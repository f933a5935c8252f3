"""Where a frame's time goes, on a CUDA card.

    python -m sift_pyocl_tpu_torch.utils.profiling [--shape 1080 1920] [--frames 5]

prints one JSON object:
  * ``stage_ms``: host-clock time of each stage of the frontend, from the
    upload of the host frame on, run one after another with a device
    synchronisation after each (so each figure includes the stage's own
    launch overhead; the frame's remainder is output assembly and the copy
    back to the host);
  * ``frame_ms``: ``SiftPlan.keypoints`` per frame, host clock;
  * ``device``: from ``torch.profiler`` over the same frames: summed kernel
    time, the device's busy share of the wall time, the number of kernel
    launches per frame and the kernels that take the most time.
Requires a CUDA device; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from ..config import SLICE_CONFIG, SiftConfig
from ..models.sift import SiftPlan, octave_capacities
from ..ops.detect import decode_compacted, extrema_mask
from ..ops.kernels import compact_masks_multi, grad_atlas, orient_desc_fused, refine_multi
from ..ops.kernels.window import slot_octave_geometry
from ..ops.orient_desc import _desc_window_size, quantize_descriptors
from ..ops.pyramid import build_scale_space
from .testimage import synthetic_scene


def _timed(fn, out: dict, name: str):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    out[name] += 1e3 * (time.perf_counter() - t)
    return res


def _stage_frame(host_img, cfg: SiftConfig, caps, dev, t: dict) -> None:
    """One frame, stage by stage; every tensor dies when it returns, as in
    a plan's frame."""
    img = _timed(lambda: torch.from_numpy(host_img).to(dev), t, "upload")
    octaves = _timed(lambda: build_scale_space(img, cfg), t, "pyramid")
    dogs = [d for _, d in octaves]
    blurs = [b for b, _ in octaves]
    masks = _timed(lambda: [extrema_mask(d, cfg, o) for o, d in enumerate(dogs)],
                   t, "extrema_mask")
    idx, wr, _ = _timed(lambda: compact_masks_multi(masks, caps), t, "K3 compact")
    s, r, c, valid = _timed(
        lambda: decode_compacted(dogs, masks, caps, idx, wr, cfg.border_dist), t, "decode")
    fs, fr, fc, _, accept = _timed(
        lambda: refine_multi(dogs, s, r, c, valid, caps, cfg.border_dist,
                             cfg.peak_thresh, cfg.max_interp_moves), t, "K4 refine")
    mag, ori, rows = _timed(lambda: grad_atlas(blurs, cfg.scales), t, "K5 grad_atlas")

    def window_args():
        return (mag, ori, s, fr, fc, cfg.init_sigma * 2.0 ** (fs / cfg.scales),
                (accept > 0) & valid, _desc_window_size(cfg), cfg.max_ori,
                *slot_octave_geometry(caps, rows, blurs))

    args = _timed(window_args, t, "window args")
    _, _, raw = _timed(lambda: orient_desc_fused(*args), t, "K6 orient_desc")
    _timed(lambda: quantize_descriptors(raw.reshape(-1, 128)), t, "quantize")


def stage_times(host_img, cfg: SiftConfig, dev: torch.device, frames: int) -> dict:
    """Mean host-clock ms of each stage over `frames` frames (after one
    warm-up frame); `host_img` is the frame in host memory."""
    caps = [c for c, _ in octave_capacities(host_img.shape, cfg)]
    _stage_frame(host_img, cfg, caps, dev, defaultdict(float))
    acc = defaultdict(float)
    for _ in range(frames):
        _stage_frame(host_img, cfg, caps, dev, acc)
    return {k: v / frames for k, v in acc.items()}


def device_profile(plan: SiftPlan, img, frames: int) -> dict:
    """Kernel time and busy share of the device over `frames` keypoints() calls."""
    from torch.profiler import ProfilerActivity, profile

    plan.keypoints(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(frames):
            plan.keypoints(img)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms_per_frame": wall_ms / frames,
        "kernel_ms_per_frame": busy_ms / frames,
        "busy_share": busy_ms / wall_ms if wall_ms else 0.0,
        "kernel_launches_per_frame": len(kernels) / frames,
        "top_kernels_ms_per_frame": [[name[:90], ms / frames] for name, ms in top],
    }


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
        "profile": device_profile(plan, img, args.frames),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
