"""The 200-frame VO fence (``tests/test_vo_longrun.py``): its scene, its
settings, one run of ``vo_init`` / ``vo_step`` over it, and its scoring.

The camera drifts on a gentle Lissajous path inside a fixed 3-D blob cloud
(known ground-truth centres), so the scene stays rich in features for all
200 frames.  The run catches what short runs cannot: slow pose drift,
NaN/Inf creep through the LM damping or triangulation, tracking decay as the
map ages, host-memory growth, and, where the JAX package counts its jit
cache, a kernel library built or loaded again mid-run or a carried state
whose shapes change.  ``tests/test_torch_vo_longrun.py`` runs it on the CPU
and ``chip_smoke.py``'s phase F on the card; both hold it to the reference
test's bounds (``TRACKED``, ``PATH_RATIO``, ``ATE``, ``RSS_MB``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import SiftConfig
from ..models.vo import VOConfig, vo_init, vo_step
from ..ops import _build, resolve_device
from ..sfm.evaluate import ate_rmse, camera_centers
from .testimage import blob_cloud, render_point_cloud

N_FRAMES = 200
SHAPE = (224, 224)
K = np.array([[280.0, 0.0, SHAPE[1] / 2], [0.0, 280.0, SHAPE[0] / 2], [0.0, 0.0, 1.0]],
             np.float32)
CFG = SiftConfig(kp_per_octave_cap=512)
VO = VOConfig(window=6, pts_per_frame=128, obs_per_frame=256, pnp_n=256, pnp_iters=6,
              cg_iters=6)
CHECK_EVERY = 25        # frames between finiteness checks of the carried state
WARM = 2                # the frame after which nothing may be built or reshaped
# the reference test's bounds, kept at their values
TRACKED = 0.95
PATH_RATIO = (0.45, 2.5)
ATE = 0.35
RSS_MB = 500.0


def center_at(i: int) -> np.ndarray:
    """Ground-truth camera centre of frame i."""
    return np.array([0.45 * np.sin(2 * np.pi * i / 80.0),
                     0.30 * np.sin(2 * np.pi * i / 50.0),
                     0.25 * np.sin(2 * np.pi * i / 120.0)], np.float32)


def render_frames(indices=range(N_FRAMES)) -> np.ndarray:
    """The frames of `indices`, (n, H, W) f32, rendered in NumPy."""
    pts, radii, amps = blob_cloud(n=150, seed=5, depth=(3.5, 8.5), span=4.5)
    I3 = np.eye(3, dtype=np.float32)
    return np.stack([render_point_cloud(pts, radii, amps, K.tolist(), I3, -center_at(i), SHAPE)
                     for i in indices])


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def _shapes(state) -> tuple:
    return tuple((name, tuple(t.shape), t.dtype) for name, t in zip(state._fields, state))


def score(Rs: np.ndarray, ts: np.ndarray) -> dict:
    """sim(3)-aligned ATE against the ground-truth centres and the ratio of
    the estimated path length to the true one."""
    est = camera_centers(Rs, ts)
    gt = np.stack([center_at(i) for i in range(len(Rs))])
    path_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    path_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    return {"centres_finite": bool(np.isfinite(est).all()),
            "ate": float(ate_rmse(est, gt, with_scale=True)),
            "path_ratio": float(path_est / path_gt)}


def run(device=None, frames: Optional[np.ndarray] = None,
        after_step: Optional[Callable[[int, object, object], None]] = None) -> dict:
    """``vo_init`` on frame 0 and ``vo_step`` on frames 1..N-1 on `device`
    (None: the CUDA card; raises without one).  ``after_step(i, state,
    out)`` is called after each step, outside its timing.

    Returns the tracked fraction, ``score``'s numbers, the host-clock
    seconds of each step (synchronised on a card), the RSS growth after
    frame ``WARM``, and three lists of faults that must be empty: frames
    with a non-finite t, lam or map at every ``CHECK_EVERY``-th frame,
    frames whose carried state changed a shape or dtype after ``WARM``, and
    frames after which the kernel library was built or loaded again."""
    dev = resolve_device(device)
    frames = render_frames() if frames is None else frames
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    st = vo_init(frames[0], K, CFG, VO, device=dev)
    Rs, ts = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    tracked, step_s = [], []
    not_finite, reshaped, rebuilt = [], [], []
    warm_shapes = warm_builds = rss_warm = None
    for i in range(1, len(frames)):
        sync()
        t = time.perf_counter()
        st, out = vo_step(st, frames[i], K, CFG, VO)
        sync()
        step_s.append(time.perf_counter() - t)
        if i == WARM:
            warm_shapes, warm_builds, rss_warm = _shapes(st), _build.build_counts(), rss_mb()
        elif i > WARM:
            if _shapes(st) != warm_shapes:
                reshaped.append(i)
            if _build.build_counts() != warm_builds:
                rebuilt.append(i)
        Rs.append(out.R.cpu().numpy())
        ts.append(out.t.cpu().numpy())
        tracked.append(bool(out.tracked))
        if i % CHECK_EVERY == 0 and not (np.isfinite(ts[-1]).all()
                                         and bool(torch.isfinite(st.lam))
                                         and bool(torch.isfinite(st.X).all())):
            not_finite.append(i)
        if after_step is not None:
            after_step(i, st, out)
    return {"frames": len(frames), "tracked": float(np.mean(tracked)),
            **score(np.stack(Rs), np.stack(ts)), "step_s": step_s,
            "rss_growth_mb": rss_mb() - rss_warm, "not_finite": not_finite,
            "reshaped": reshaped, "rebuilt": rebuilt, "build_counts": _build.build_counts()}
