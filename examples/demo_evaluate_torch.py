#!/usr/bin/env python
"""Demo: sequence ATE evaluation from files on disk through the PyTorch +
CUDA port (examples/demo_evaluate.py's demo).

Renders an out-and-back loop trajectory, writes it as PGM frames and a
TUM-format ground-truth file, then runs the evaluation CLI
(`python -m sift_pyocl_tpu_torch.evaluate`) over the directory: the same
flow a user follows with a real dataset on disk.

Usage: python examples/demo_evaluate_torch.py [--out DIR] [--frames N] [--device cpu]
(default device: the CUDA card)
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="output dir (default: temp)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from sift_pyocl_tpu_torch.evaluate import main as eval_main, save_sequence
    from sift_pyocl_tpu_torch.utils.render3d import render_sequence

    out = args.out or tempfile.mkdtemp(prefix="sift_eval_demo_")
    print(f"rendering {args.frames}-frame loop sequence -> {out}")
    K, frames, gtR, gtT = render_sequence(
        n_frames=args.frames, n_points=120, image_size=(320, 240), seed=0,
        arc_deg=30.0, out_and_back=True,
    )
    seq_dir, gt_path = save_sequence(out, frames, gtR, gtT)
    cli = ["--frames", str(seq_dir), "--gt", str(gt_path), "--mode", "sfm",
           "--fx", str(float(K[0, 0]))]
    if args.device:
        cli += ["--device", args.device]
    print("running: python -m sift_pyocl_tpu_torch.evaluate " + " ".join(cli))
    return eval_main(cli)


if __name__ == "__main__":
    sys.exit(main())
