#!/usr/bin/env python
"""Demo: bundle adjustment on a synthetic multi-camera problem, on one
device and through the sharded DistributedBA (BASELINE.json configs 4-5),
with the PyTorch + CUDA port (examples/demo_sfm.py's demo).

The distributed BA runs over a torch.distributed group of one rank (NCCL on
the card, gloo on the CPU); more ranks run it as tests/test_torch_distributed.py
does, each process joining the same group.

Usage: python examples/demo_sfm_torch.py [--device cpu]
(default device: the CUDA card)
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch.distributed as dist

from sift_pyocl_tpu_torch.ops import resolve_device
from sift_pyocl_tpu_torch.parallel import global_ba_mesh
from sift_pyocl_tpu_torch.sfm import DistributedBA, run_ba
from sift_pyocl_tpu_torch.sfm.ba import BAParams
from sift_pyocl_tpu_torch.sfm.synthetic import make_problem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    K, gt, obs, meta = make_problem(n_cams=12, n_points=400, noise_px=0.5, seed=0)
    rng = np.random.default_rng(1)
    noisy = BAParams(
        Rs=np.asarray(gt.Rs),
        ts=np.asarray(gt.ts + 0.02 * rng.normal(size=gt.ts.shape), np.float32),
        X=np.asarray(gt.X + 0.10 * rng.normal(size=gt.X.shape), np.float32),
    )

    params, costs = run_ba(noisy, obs, K, iters=10, device=dev)
    print(f"single-device BA ({dev}): cost {costs[0]:.2f} -> {costs[-1]:.2f}")

    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="demo_sfm_") as store:
        dist.init_process_group(backend, init_method=f"file://{store}/group", world_size=1,
                                rank=0)
        try:
            dparams, dcosts = DistributedBA(global_ba_mesh(device=dev)).run(noisy, obs, K,
                                                                           iters=10)
        finally:
            dist.destroy_process_group()
    print(f"DistributedBA (1 {backend} rank): cost {dcosts[0]:.2f} -> {dcosts[-1]:.2f}")


if __name__ == "__main__":
    main()
