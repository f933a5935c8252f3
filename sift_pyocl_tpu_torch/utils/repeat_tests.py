"""Run one pytest selection many times, each in a fresh process.

    python -m sift_pyocl_tpu_torch.utils.repeat_tests --runs 50 \\
        -- --noconftest -m gpu tests/test_torch_gpu_kernels.py -k best2_l2_one_launch -q

A fault that shows only now and then (a race, state left by an earlier
call) needs many runs to show at all; a fresh process each time also
repeats whatever the first call of a process does.  Prints one line a run
(exit code, seconds, pytest's summary line) and, last, one JSON object with
the count of runs and of failures; the whole output of each failed run is
kept in ``<out>/run_<i>.log`` (``--out``, by default ``repeat/`` in the
package's git-ignored build directory).  Exits non-zero if any run failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from ..ops._build import BUILD_DIR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--out", type=Path, default=BUILD_DIR / "repeat")
    ap.add_argument("pytest_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    pytest_args = [a for a in args.pytest_args if a != "--"]
    args.out.mkdir(parents=True, exist_ok=True)
    failed = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pytest", *pytest_args],
                              capture_output=True, text=True, check=False)
        text = proc.stdout + proc.stderr
        lines = [ln for ln in text.splitlines() if ln.strip()]
        print(f"run {i}: rc {proc.returncode}, {time.perf_counter() - t0:.1f} s, "
              f"{lines[-1] if lines else ''}", flush=True)
        if proc.returncode != 0:
            failed.append(i)
            (args.out / f"run_{i}.log").write_text(text)
    print(json.dumps({"runs": args.runs, "failed": len(failed), "failed_runs": failed,
                      "pytest_args": pytest_args}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
