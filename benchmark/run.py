#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared with the reference beside its limit; the same numbers are
the last lines of standard error.  Exits non-zero, printing no result,
without enough CUDA cards, outside a checkout that holds the port, or when
JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program and of PyTorch's compilers inside the checkout
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))

    from benchmark.harness import guard, manifest

    if not (ROOT / "sift_pyocl_tpu_torch").is_dir():
        print("[bench] the port (sift_pyocl_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    cell = manifest.Cell(manifest.load_manifest(ROOT), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark.harness import runner
    from sift_pyocl_tpu_torch.ops import _build

    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T0)
    print(f"[bench] kernel library builds in this run: {_build.build_counts()['builds']}",
          file=sys.stderr)
    found = guard.forbidden_loaded()
    if found:
        print(f"[bench] forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"[bench] check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
