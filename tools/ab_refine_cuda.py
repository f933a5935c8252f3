"""K4's block sizes, and the detection stage around it, on a CUDA card.

    python tools/ab_refine_cuda.py [--threads 32 64 128 256] [--rounds 2]

At 1080x1920 under SiftConfig() (the frame chip_smoke.py uses), on the plain
stencil's masks and K3's output:

  * ``k4``: for each block size of K4's kernel (``refine.THREADS``), in
    turns for `rounds` rounds: device ms a launch (torch.profiler, the mean
    over the recorded launches of 20 calls, fullest of three sessions) and
    event ms a call (CUDA events over 200 back-to-back calls); every block
    size must give the same bits;
  * ``stage``: K3 + K4 as the multi-launch path runs them
    (``detect_all_slots`` on given masks): event ms a call and CUDA
    launches a call;
  * with ``--host-profile``, ``host_profile``: where a K4 call's host time
    goes, the top functions of cProfile (own time) over 2000 calls.

On a tree whose ``refine_multi`` takes decoded candidates (the design
before K4 read K3's output), ``k4`` times that wrapper at its fixed block
size, and ``stage`` is ``detect_all_octaves`` plus the concatenation of
its six fields that the multi-launch path made; run this script from each
tree's root in turns to compare them on one card.  Prints one JSON object
with the card's ``nvidia-smi`` name and power limit.  Requires a CUDA
device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from sift_pyocl_tpu_torch import SiftConfig  # noqa: E402
from sift_pyocl_tpu_torch.models.sift import octave_capacities  # noqa: E402
from sift_pyocl_tpu_torch.ops import detect  # noqa: E402
from sift_pyocl_tpu_torch.ops.kernels import compact, refine  # noqa: E402
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space  # noqa: E402
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene  # noqa: E402

SHAPE = (1080, 1920)


def event_ms(fn, iters: int = 200) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def launches(fn, name: str, calls: int = 20):
    """(CUDA launches a call, device ms a launch of kernels named `name`),
    from the fullest of three torch.profiler sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(ev) > len(best):
            best = ev
    named = [e for e in best if name in e.name]
    dev = sum(e.device_time_total for e in named) / 1e3 / max(1, len(named))
    return len(best) / calls, dev


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="+", default=[32, 64, 128, 256])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--host-profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = SiftConfig()
    x = torch.from_numpy(synthetic_scene(SHAPE, seed=0)).to(dev)
    dogs = [d for _, d in build_scale_space(x, cfg)]
    masks = [detect.extrema_mask(d, cfg, o) for o, d in enumerate(dogs)]
    caps = [c for c, _ in octave_capacities(SHAPE, cfg)]
    idx, written, _ = compact.compact_masks_multi(masks, caps)
    bd, pt, mm = cfg.border_dist, cfg.peak_thresh, cfg.max_interp_moves
    new_api = "masks" in inspect.signature(refine.refine_multi).parameters
    out = {"card": smi, "design": "in-kernel decode" if new_api else "host decode",
           "valid_candidates": int(written.sum()), "slots": sum(caps)}
    if new_api:
        def k4():
            return refine.refine_multi(dogs, masks, caps, idx, written, bd, pt, mm)

        def stage():
            return detect.detect_all_slots(dogs, cfg, caps, masks=masks)
    else:
        cands = detect.decode_compacted(dogs, masks, caps, idx, written, bd)

        def k4():
            return refine.refine_multi(dogs, *cands, caps, bd, pt, mm)

        def stage():
            kps = [k for k, _ in detect.detect_all_octaves(dogs, cfg, caps, masks=masks)]
            return [torch.cat(f) for f in zip(*kps)]

    rows = []
    shipped = getattr(refine, "THREADS", None)
    want = [t.clone() for t in k4()]
    for _ in range(args.rounds):
        for nt in (args.threads if new_api else [shipped]):
            if new_api:
                refine.THREADS = nt
                got = k4()
                torch.cuda.synchronize()
                assert all(torch.equal(g, w) for g, w in zip(got, want)), f"{nt} threads differ"
            n_launch, dev_ms = launches(k4, "refine_kernel")
            rows.append({"threads": nt, "device_ms_per_launch": dev_ms,
                         "event_ms": event_ms(k4), "cuda_launches": n_launch})
            print(json.dumps(rows[-1]), flush=True)
    if new_api:
        refine.THREADS = shipped
    n_stage, _ = launches(stage, "refine_kernel")
    out.update({"k4": rows, "stage": {"event_ms": event_ms(stage), "cuda_launches": n_stage}})
    if args.host_profile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        for _ in range(2000):
            k4()
        prof.disable()
        torch.cuda.synchronize()
        st = pstats.Stats(prof)
        top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
        out["host_profile"] = [[f"{Path(f).name}:{line}:{fn}", calls / 2000, 1e6 * tt / 2000]
                               for (f, line, fn), (_, calls, tt, _, _) in top]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
