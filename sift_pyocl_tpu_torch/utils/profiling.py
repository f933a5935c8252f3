"""Where a frame's time goes, on a CUDA card.

    python -m sift_pyocl_tpu_torch.utils.profiling [--shape 1080 1920] [--frames 5]

prints one JSON object:
  * ``stage_ms``: host-clock time of each stage of the frontend
    (``SLICE_CONFIG``; ``stage_ms_mask_pallas``, the same with
    ``mask_backend="pallas"``, whose mask stage is "K8 extrema_masks" in
    place of the plain "extrema_mask"; and ``stage_ms_mask_fused``,
    ``SiftConfig(mask_backend="fused")``, whose pyramid stage runs K1m/K2m
    and so holds the mask, and whose mask stage reads 0), from the upload of the host frame
    on, run one after another with a device synchronisation after each (so
    each figure includes the stage's own launch overhead; the frame's
    remainder is output assembly and the copy back to the host);
  * ``frame_ms``: ``SiftPlan.keypoints`` per frame, host clock;
  * ``profile``: from ``torch.profiler`` over the same frames: summed kernel
    time, the device's busy share of the wall time, the number of kernel
    launches per frame (also by kernel name) and the kernels that take the
    most time;
  * ``vo``: the VO step at the default ``VOConfig``, under
    ``mask_backend`` "xla" (the default ``SiftConfig``), "pallas" (K8) and
    "fused" (K1m/K2m):
    ``vo_stage_ms`` (CUDA events at each stage boundary of ``vo_step``:
    frontend, match, pnp, roll_spawn, ba -- device time from one boundary
    to the next, so a stage's figure includes any wait of the device on the
    host), ``step_ms`` (host clock, synchronised) and the same
    ``torch.profiler`` summary per step.
Requires a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

import dataclasses

from ..config import SLICE_CONFIG, SiftConfig
from ..models.sift import SiftPlan, octave_capacities
from ..ops.kernels import compact_masks_multi, grad_atlas, orient_desc_fused, refine_multi
from ..ops.kernels.maskk import extrema_masks, extrema_masks_ref
from ..ops.kernels.window import slot_octave_geometry
from ..ops.orient_desc import _desc_window_size, quantize_descriptors
from ..ops.pyramid import build_scale_space_and_masks
from .testimage import synthetic_scene


def _sync() -> None:
    """Wait for the card where one is in use (a CPU plan has nothing to
    wait for)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timed(fn, out: dict, name: str):
    _sync()
    t = time.perf_counter()
    res = fn()
    _sync()
    out[name] += 1e3 * (time.perf_counter() - t)
    return res


def _stage_frame(host_img, cfg: SiftConfig, caps, dev, t: dict) -> None:
    """One frame, stage by stage; every tensor dies when it returns, as in
    a plan's frame."""
    img = _timed(lambda: torch.from_numpy(host_img).to(dev), t, "upload")
    octaves, fused = _timed(lambda: build_scale_space_and_masks(img, cfg), t, "pyramid")
    dogs = [d for _, d in octaves]
    blurs = [b for b, _ in octaves]
    if fused is not None:
        # the ladders' mask forms made the masks inside the pyramid stage
        # (an octave 0 that went through K9 takes the stencil here)
        masks = _timed(lambda: [m if m is not None else extrema_masks_ref([d], cfg)[0]
                                for m, d in zip(fused, dogs)], t, "fused mask")
    elif cfg.mask_backend == "pallas":
        masks = _timed(lambda: extrema_masks(dogs, cfg), t, "K8 extrema_masks")
    else:
        masks = _timed(lambda: extrema_masks_ref(dogs, cfg), t, "extrema_mask")
    idx, wr, _ = _timed(lambda: compact_masks_multi(masks, caps), t, "K3 compact")
    s, fs, fr, fc, _, keep = _timed(
        lambda: refine_multi(dogs, masks, caps, idx, wr, cfg.border_dist,
                             cfg.peak_thresh, cfg.max_interp_moves), t, "K4 refine")
    mag, ori, rows = _timed(lambda: grad_atlas(blurs, cfg.scales), t, "K5 grad_atlas")

    def window_args():
        return (mag, ori, s, fr, fc, cfg.init_sigma * 2.0 ** (fs / cfg.scales),
                keep, _desc_window_size(cfg), cfg.max_ori,
                *slot_octave_geometry(caps, rows, blurs))

    args = _timed(window_args, t, "window args")
    _, _, raw = _timed(lambda: orient_desc_fused(*args), t, "K6 orient_desc")
    _timed(lambda: quantize_descriptors(raw.reshape(-1, 128)), t, "quantize")


def stage_times(host_img, cfg: SiftConfig, dev: torch.device, frames: int) -> dict:
    """Mean host-clock ms of each stage over `frames` frames (after one
    warm-up frame); `host_img` is the frame in host memory.  The stages are
    those of the multi-launch kernel path (``SiftPlan.log_profile`` calls
    this for its shape, config and device; on the CPU every kernel is its
    plain version)."""
    caps = [c for c, _ in octave_capacities(host_img.shape, cfg)]
    _stage_frame(host_img, cfg, caps, dev, defaultdict(float))
    acc = defaultdict(float)
    for _ in range(frames):
        _stage_frame(host_img, cfg, caps, dev, acc)
    return {k: v / frames for k, v in acc.items()}


def device_profile(run_frame, frames: int, sessions: int = 1) -> dict:
    """Kernel time and busy share of the device over `frames` calls of
    ``run_frame()`` (after one more call as warm-up), from the one of
    `sessions` profiling sessions that recorded the most CUDA events: a
    session now and then loses a whole call's records, and a lost record
    only ever lowers a count."""
    from torch.profiler import ProfilerActivity, profile

    run_frame()
    torch.cuda.synchronize()
    kernels, wall_ms = None, 0.0
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(frames):
                run_frame()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels is None or len(events) > len(kernels):
            kernels, wall_ms = events, ms
    by_name = defaultdict(float)
    count = defaultdict(int)
    for e in kernels:
        by_name[e.name] += e.device_time_total / 1e3
        count[e.name] += 1
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms_per_frame": wall_ms / frames,
        "kernel_ms_per_frame": busy_ms / frames,
        "busy_share": busy_ms / wall_ms if wall_ms else 0.0,
        "kernel_launches_per_frame": len(kernels) / frames,
        "top_kernels_ms_per_frame": [[name[:90], ms / frames] for name, ms in top],
        "launches_by_name_per_frame": {name: n / frames for name, n in count.items()},
    }


VO_STAGES = ("frontend", "match", "pnp", "roll_spawn", "ba")


def vo_stage_ms(state, frames, K, cfg: SiftConfig, vo):
    """Mean device ms of each VO stage over ``vo_step`` on `frames` (CUDA
    events recorded as each stage is enqueued).  Returns (state, {stage: ms})."""
    from ..models.vo import vo_step

    acc = defaultdict(float)
    for frame in frames:
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        state, _ = vo_step(state, frame, K, cfg, vo, on_stage=mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            acc[name] += a.elapsed_time(b)
    return state, {k: acc[k] / len(frames) for k in VO_STAGES}


def vo_frames(shape, n: int, step_px: int = 2):
    """`n` host frames of a translating scene: crops of a larger
    ``synthetic_scene`` shifted `step_px` columns a frame.  The scene is
    (h + 64, w + 64) while the shifts fit in it (21 frames at 2 px), and
    wider for longer runs, so every frame is (h, w)."""
    h, w = shape
    base = synthetic_scene((h + 64, w + max(64, 24 + step_px * (n - 1))), n_blobs=200, seed=0)
    return [np.ascontiguousarray(base[24:24 + h, 24 + step_px * i:24 + step_px * i + w])
            for i in range(n)]


def vo_report(shape, frames: int, dev: torch.device) -> dict:
    """The VO step at the default ``VOConfig`` on `frames` + 4 frames, under
    each mask backend: {"xla": ..., "pallas": ..., "fused": ...}."""
    from ..models.vo import VOConfig, vo_init, vo_step

    vo = VOConfig()
    h, w = shape
    K = torch.tensor([[1000.0, 0, w / 2], [0, 1000.0, h / 2], [0, 0, 1]], device=dev)
    host = vo_frames(shape, 2 * frames + 4)
    imgs = [torch.from_numpy(f).to(dev) for f in host]
    report = {}
    for mask_backend in ("xla", "pallas", "fused"):
        cfg = SiftConfig(mask_backend=mask_backend)
        state = vo_init(imgs[0], K, cfg, vo)
        state, _ = vo_step(state, imgs[1], K, cfg, vo)
        torch.cuda.synchronize()
        step_ms = []
        for img in imgs[2:2 + frames]:
            t = time.perf_counter()
            state, _ = vo_step(state, img, K, cfg, vo)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
        state, stages = vo_stage_ms(state, imgs[2 + frames:2 + 2 * frames], K, cfg, vo)
        rest = iter(imgs[2 + 2 * frames:])
        box = [state]

        def one():
            box[0], _ = vo_step(box[0], next(rest), K, cfg, vo)

        report[mask_backend] = {"step_ms": step_ms, "vo_stage_ms": stages,
                                "profile": device_profile(one, 1)}
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=2, default=(1080, 1920))
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    dev = torch.device("cuda", 0)
    shape = tuple(args.shape)
    img = synthetic_scene(shape, seed=0)
    plan = SiftPlan(shape, config=SLICE_CONFIG, device=dev)
    frame_ms = []
    plan.keypoints(img)
    for _ in range(args.frames):
        t = time.perf_counter()
        plan.keypoints(img)
        frame_ms.append(1e3 * (time.perf_counter() - t))
    report = {
        "device": torch.cuda.get_device_name(0),
        "shape": list(shape),
        "frame_ms": frame_ms,
        "stage_ms": stage_times(img, SLICE_CONFIG, dev, args.frames),
        "stage_ms_mask_pallas": stage_times(
            img, dataclasses.replace(SLICE_CONFIG, mask_backend="pallas"), dev, args.frames),
        "stage_ms_mask_fused": stage_times(img, SiftConfig(mask_backend="fused"), dev,
                                           args.frames),
        "profile": device_profile(lambda: plan.keypoints(img), args.frames),
        "vo": vo_report(shape, args.frames, dev),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
