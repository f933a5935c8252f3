#!/usr/bin/env python
"""Demo: match and align a translated image pair through the PyTorch + CUDA
port (examples/demo_match_align.py's demo).

Usage: python examples/demo_match_align_torch.py [--device cpu]
(default device: the CUDA card)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from sift_pyocl_tpu_torch import LinearAlign, MatchPlan, SiftPlan
from sift_pyocl_tpu_torch.utils.testimage import transformed_pair


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    a, b = transformed_pair((384, 384), seed=1, dx=9, dy=-6)
    plan = SiftPlan(a.shape, "float32", device=args.device)
    kp_a = plan.keypoints(a)
    kp_b = plan.keypoints(b)
    m = MatchPlan(device=args.device).match(kp_a, kp_b)
    dx = float(np.median(m[:, 1]["x"] - m[:, 0]["x"]))
    dy = float(np.median(m[:, 1]["y"] - m[:, 0]["y"]))
    print(f"{len(m)} matches; median displacement = ({dx:+.2f}, {dy:+.2f}) "
          f"(truth: (-9, +6))")

    aligner = LinearAlign(a, device=args.device)
    out = aligner.align(b, return_all=True)
    print("affine matrix:\n", np.round(out["matrix"], 4))
    print("offset:", np.round(out["offset"], 3))
    err = np.abs(out["result"][32:-32, 32:-32] - a[32:-32, 32:-32]).mean()
    print(f"mean abs error after warp (interior): {err:.3f}")


if __name__ == "__main__":
    main()
