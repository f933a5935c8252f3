"""K2m's work-list layouts side by side on a CUDA card (PyTorch port).

    python tools/ab_fused_ladders.py

Times K2m (``small_octaves_ladder_mask``) at 1080x1920's small octaves
(540x960 down to 17x30, default SiftConfig) under several placements of its
mask items, beside K2 and K2 + K8, in turns within one process: device ms a
launch from torch.profiler (the mean over recorded launches, which a lost
record does not lower) and event ms a call.  Layouts:

  * ``last``: every octave's mask item in one step after the last pass
    (the shipped layout);
  * ``octave``: each octave's mask item at the first step after its own
    last DoG pass;
  * ``first_then_last``: the largest octave's mask item where ``octave``
    puts it, the others in one step after the last pass;
  * ``first_only``: only the largest octave's mask item, where ``octave``
    puts it;
  * ``none``: no mask items (the K2m kernel doing K2's work only; its masks
    are left unwritten), the cost of its instance against K2's.

Prints one JSON object.  Requires a CUDA device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sift_pyocl_tpu_torch import SiftConfig  # noqa: E402
from sift_pyocl_tpu_torch.ops.kernels import ladder, maskk  # noqa: E402
from sift_pyocl_tpu_torch.ops.pyramid import (downsample_octave, normalized_input,  # noqa: E402
                                              pre_blur_sigma)
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene  # noqa: E402

SHIPPED = ladder.small_octaves_schedule


def _layout(name: str):
    def schedule(geo, sizes, scales, n_blocks, mask_bd=None):
        steps = SHIPPED(geo, sizes, scales, n_blocks, mask_bd)
        if mask_bd is None or name == "last":
            return steps
        masks, steps = steps[-1], [list(items) for items in steps[:-1]]
        # the step after octave o's last pass, as the octave layout puts it
        after = {it.octave: s + 1 for s, items in enumerate(steps) for it in items}
        if name != "none":
            for it in masks[:1] if name != "octave" else masks:
                if after[it.octave] == len(steps):
                    steps.append([])
                steps[after[it.octave]].append(it)
        if name == "first_then_last":
            steps.append(masks[1:])
        out = []
        for items in steps:
            t, fixed = 0, []
            for it in items:
                n = it.tile_end - it.tile_start
                fixed.append(it._replace(tile_start=t, tile_end=t + n))
                t += n
            out.append(fixed)
        return out
    return schedule


def _timed(fn, name: str, calls: int = 20):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / calls
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        best = ev if len(ev) > len(best) else best
    return {"event_ms": event_ms, "device_ms_per_launch":
            sum(e.device_time_total for e in best) / 1e3 / max(len(best), 1),
            "recorded_launches": len(best)}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = SiftConfig(mask_backend="fused")
    shape = (1080, 1920)
    x = torch.from_numpy(synthetic_scene(shape, seed=0)).to(dev)
    data = normalized_input(x, cfg)
    incs = cfg.sigma_increments()
    b0, _ = ladder.octave0_ladder(data, pre_blur_sigma(cfg), incs)
    n_oct = cfg.n_octaves(shape) - 1
    eths = tuple(maskk.octave_edge_thresh(cfg, o) for o in range(1, n_oct + 1))
    mc = (cfg.peak_thresh, eths, cfg.border_dist)
    base = downsample_octave(b0[cfg.scales], cfg.downsample_mode)
    out = {"device": torch.cuda.get_device_name(0)}
    for turn in ("last", "octave", "first_then_last", "first_only", "none", "octave", "last"):
        ladder.small_octaves_schedule = _layout(turn)
        ladder._small_plan.cache_clear()
        args = (base, incs, n_oct, cfg.scales, cfg.downsample_mode)
        r = _timed(lambda: ladder.small_octaves_ladder_mask(*args, mc),
                   "small_octaves_kernel_masks")
        out.setdefault(f"K2m {turn}", []).append(r)
        if turn == "last":
            out.setdefault("K2", []).append(
                _timed(lambda: ladder.small_octaves_ladder(*args), "small_octaves_kernel"))
            out.setdefault("K8 after K2", []).append(_timed(lambda: maskk.extrema_masks(
                [d for _, d in ladder.small_octaves_ladder(*args)], cfg), "mask_kernel"))
        steps = ladder._small_plan(tuple(ladder._geometry(*base.shape, n_oct)),
                                   tuple(map(float, incs)), cfg.scales, dev,
                                   cfg.border_dist)[0]
        out[f"steps {turn}"] = int(steps[0])
    ladder.small_octaves_schedule = SHIPPED
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
