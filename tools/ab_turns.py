"""What the per-kernel A/B tools share: timing on a CUDA card and the
driver that measures several trees in turns.

A tool defines ``measure() -> dict`` and ends with
``sys.exit(ab_turns.main(__doc__, __file__, measure))``; then

    python tools/<tool>.py                      # this tree
    python tools/<tool>.py --turns OLD NEW      # OLD, NEW, NEW, OLD

runs ``measure`` once a tree, each in its own process from its own root
(``--root``), and prints one JSON object a run with the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20) -> float:
    """Event ms a call of fn() over `iters` calls, after two warm-up calls."""
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
    their launches in one call in launch order, records on the card a
    call)."""
    ev = device_events(fn, calls)
    named = sorted((e for e in ev if name in e.name), key=lambda e: e.time_range.start)
    per = len(named) // calls
    each = [sum(named[c * per + i].device_time_total for c in range(calls)) / 1e3 / calls
            for i in range(per)]
    return sum(e.device_time_total for e in named) / 1e3 / calls, each, len(ev) / calls


def main(doc: str, script: str, measure) -> int:
    """Run `measure` on this tree, or `script` once a tree in turns."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--root", default=str(Path(script).resolve().parent.parent),
                    help="the tree whose sift_pyocl_tpu_torch is measured")
    ap.add_argument("--turns", nargs="+", metavar="TREE",
                    help="trees to measure in turns (A B: A, B, B, A), each in its own process")
    args = ap.parse_args()
    if args.turns:
        for tree in args.turns + args.turns[::-1]:
            root = str(Path(tree).resolve())
            res = subprocess.run([sys.executable, str(Path(script).resolve()), "--root", root],
                                 cwd=root, check=False)
            if res.returncode:
                return res.returncode
        return 0
    sys.path.insert(0, args.root)
    res = measure()
    res.update(card=nvidia_smi_line(), tree=args.root)
    print(json.dumps(res), flush=True)
    return 0
