"""K11a and K11b (the split orientation and descriptor histograms) on a CUDA
card, from this tree or from several trees in turns.

    python tools/ab_split_windows.py                      # this tree
    python tools/ab_split_windows.py --turns OLD NEW      # OLD, NEW, NEW, OLD

At 1080x1920 under SiftConfig() (the frame and slots of chip_smoke.py's
P5): per octave the K10a/K10b keypoints, the plain gradient planes padded
by ``pad_grad_planes``, K11a's slots and, at K11a's angles
(``orientation_peaks_dense``), K11b's slots.  For each kernel, over a
frame's 7 wrapper calls:

  * ``closure_ms``: event ms (CUDA events over 20 frames) with sigma made
    in the timed closure, as chip_smoke.py's rows time it;
  * ``prepared_ms``: the same with the slot arrays and sigma made before;
  * ``cuda_launches``: CUDA launches a wrapper call (prepared);
  * ``device_ms``: the kernels' own device time a frame, and
    ``launch_device_ms`` each launch's, octave by octave (torch.profiler,
    fullest of five sessions, each opened by ``profiling.open_session``);
  * ``slots`` / ``valid``: each launch's blocks and valid slots.

``k6_per_octave``: K6 (``orient_desc_fused``) launched once an octave on
the same keypoints' unpadded planes, device ms a frame and a launch: the
same boxes and sums in one launch an octave, a yardstick for the launches'
fixed cost and tails.  ``--turns`` runs this script once a tree, each from
its own root (``--root``), and prints one JSON object a run with the
card's ``nvidia-smi`` name and power limit.  Requires a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (1080, 1920)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_events(fn, calls: int = 5, sessions: int = 5) -> list:
    """The records of work on the card over `calls` calls of fn(), from the
    fullest of `sessions` torch.profiler sessions (a lost record only ever
    lowers a count)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sift_pyocl_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiling.open_session()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = profiling.device_events(prof)
        if len(events) > len(best):
            best = events
    return best


def kernel_ms(fn, name: str, calls: int = 5):
    """(device ms a call of the kernels named `name`, device ms of each of
    their launches in one call in launch order, CUDA launches a call)."""
    ev = device_events(fn, calls)
    named = sorted((e for e in ev if name in e.name), key=lambda e: e.time_range.start)
    per = len(named) // calls
    each = [sum(named[c * per + i].device_time_total for c in range(calls)) / 1e3 / calls
            for i in range(per)]
    return sum(e.device_time_total for e in named) / 1e3 / calls, each, len(ev) / calls


def measure() -> dict:
    import torch

    from sift_pyocl_tpu_torch import SiftConfig
    from sift_pyocl_tpu_torch.models.sift import octave_capacities
    from sift_pyocl_tpu_torch.ops import _build
    from sift_pyocl_tpu_torch.ops import orient_desc as od
    from sift_pyocl_tpu_torch.ops.detect import detect_octave_pallas
    from sift_pyocl_tpu_torch.ops.kernels import window
    from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
    from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

    if not torch.cuda.is_available():
        raise SystemExit("ab_split_windows.py: no CUDA device")
    _build.library()
    dev = torch.device("cuda", 0)
    cfg = SiftConfig()
    m = cfg.max_ori
    x = torch.from_numpy(synthetic_scene(SHAPE, seed=0)).to(dev)
    caps = [c for c, _ in octave_capacities(SHAPE, cfg)]
    win_o, win_d = od._ori_window_size(cfg), od._desc_window_size(cfg)
    per = []
    for o, (blurs, dogs) in enumerate(build_scale_space(x, cfg)):
        kps, _ = detect_octave_pallas(dogs, cfg, o, caps[o])
        mags, oris = od.gradient_planes(blurs, cfg)
        mag_p, ori_p = od.pad_grad_planes(mags, oris)
        okps = od.assign_orientations_pallas(mag_p, ori_p, kps, cfg, max_ori=m)
        per.append((kps, mags, oris, mag_p, ori_p, okps))
    torch.cuda.synchronize()

    def ori_args(kps, mags, oris, mag_p, ori_p, okps):
        return (mag_p, ori_p, kps.s_int, kps.fr, kps.fc, od._sigma(cfg, kps.fs), kps.valid,
                win_o)

    def desc_args(kps, mags, oris, mag_p, ori_p, okps):
        return (mag_p, ori_p, okps.s_int, okps.fr, okps.fc, od._sigma(cfg, okps.fs),
                okps.angle, okps.valid, win_d)

    out = {"card": nvidia_smi_line(), "torch": torch.__version__, "octaves": len(per)}
    for name, args, valid_at in (("orientation_hist", ori_args, 6),
                                 ("descriptor_hist", desc_args, 7)):
        fn = getattr(window, name)
        pre = [args(*p) for p in per]
        call = lambda: [fn(*a) for a in pre]
        dev_ms, each, launches = kernel_ms(call, f"{name}_kernel")
        out[name] = {
            "closure_ms": event_ms(lambda: [fn(*args(*p)) for p in per]),
            "prepared_ms": event_ms(call),
            "cuda_launches": launches / len(per),
            "device_ms": dev_ms, "launch_device_ms": each,
            "slots": [int(a[valid_at].numel()) for a in pre],
            "valid": [int(a[valid_at].sum()) for a in pre]}
    k6 = [(mags.contiguous(), oris.contiguous(), kps.s_int, kps.fr, kps.fc,
           od._sigma(cfg, kps.fs), kps.valid, win_d, m,
           *window.slot_octave_geometry([kps.fr.shape[0]], [0], [mags]))
          for kps, mags, oris, _, _, _ in per]
    dev_ms, each, _ = kernel_ms(lambda: [window.orient_desc_fused(*a) for a in k6],
                                "orient_desc_kernel")
    out["k6_per_octave"] = {"device_ms": dev_ms, "launch_device_ms": each}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the tree whose sift_pyocl_tpu_torch is measured")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="trees to measure in turns (A B: A, B, B, A), each in its own process")
    args = ap.parse_args()
    if args.turns:
        order = args.turns + args.turns[::-1]
        for tree in order:
            root = str(Path(tree).resolve())
            res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root", root],
                                 cwd=root, check=False)
            if res.returncode:
                return res.returncode
        return 0
    sys.path.insert(0, args.root)
    res = measure()
    res["tree"] = args.root
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
