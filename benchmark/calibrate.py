#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 --seconds 3

In one process, for each seed a short run of the cell at its own load
and sizes (``runner.run``) and its numbers against the reference (the
lower reading); on the control seeds also the control's numbers (the
reference in bfloat16 in the program's place: the upper reading).  Prints
one JSON line a seed and, last, the largest program reading and the
smallest control reading of each number.  For VO, the control seeds also
read each fault of ``harness/faults.py`` planted in the sampled steps'
outputs.  The benchmark's own runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def read_faults(entry) -> dict:
    """The VO check on the sampled steps with each fault planted in the
    program's output state."""
    from benchmark.harness import faults

    kept = list(entry.sample.items)
    readings = {}
    for name, fault in faults.VO_FAULTS.items():
        entry.sample.items = [(n, before, fault(before, after, entry.vo.window,
                                                  float(entry.K[0, 0])), out)
                              for n, before, after, out in kept]
        readings[name] = entry.check()
    entry.sample.items = kept
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import manifest, runner

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.Cell(manifest.load_manifest(ROOT), args.workload)
    dev = torch.device("cuda", 0)
    lower, upper = {}, {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        row = {"seed": seed}

        def after(entry, numbers, row=row, seed=seed):
            row["program"] = numbers
            if seed in args.control_seeds:
                row["control"] = entry.check(control=True)
                if cell.traffic["entry"] == "vo_stream":
                    row["faults"] = read_faults(entry)

        result = runner.run(cell, seed, args.seconds, False, dev, time.perf_counter(),
                            after=after)
        row["frames_per_s"] = result["metrics"]["frames_per_s"]["value"]
        print(json.dumps(row), flush=True)
        if seed in args.seeds:
            for k, v in row["program"].items():
                lower[k] = max(lower.get(k, v), v)
        for k, v in row.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
