#!/usr/bin/env python
"""Demo: the visual-odometry loop (SIFT + matching + PnP + windowed BA a
frame) through the PyTorch + CUDA port (examples/demo_vo.py's demo).

Renders a rigid 3-D blob cloud from a camera translating along +x and
compares the recovered trajectory against ground truth; with init_depth
matching the cloud's mean depth the trajectory is metric.

Usage: python examples/demo_vo_torch.py [--frames N] [--device cpu]
(default device: the CUDA card)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.models.vo import VOConfig, vo_init, vo_step
from sift_pyocl_tpu_torch.utils.testimage import blob_cloud, render_point_cloud


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--step", type=float, default=0.15,
                    help="camera x-translation per frame (world units)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    H, W = 256, 256
    K = [[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]]
    pts, radii, amps = blob_cloud(n=140, seed=3, depth=(3.5, 8.0), span=4.5)
    I = np.eye(3, dtype=np.float32)

    def frame_at(i):
        c = np.array([args.step * i, 0.0, 0.0], np.float32)
        return render_point_cloud(pts, radii, amps, K, I, -c, (H, W))

    cfg = SiftConfig(kp_per_octave_cap=512)
    vo = VOConfig(window=6, pts_per_frame=128, obs_per_frame=256,
                  pnp_n=256, pnp_iters=6, cg_iters=6)
    state = vo_init(frame_at(0), K, cfg, vo, device=args.device)
    print("frame | keypoints matches  rms(px)   t (world)            true t_x   err")
    for i in range(1, args.frames):
        state, out = vo_step(state, frame_at(i), K, cfg, vo)
        t = out.t.cpu().numpy()
        true_tx = -args.step * i
        print(
            f"{i:5d} | {int(out.n_kp):9d} {int(out.n_matches):7d} "
            f"{float(out.rms_px):8.3f}   [{t[0]:+.3f} {t[1]:+.3f} {t[2]:+.3f}]"
            f"   {true_tx:+.3f}   {abs(t[0] - true_tx):.3f}"
        )


if __name__ == "__main__":
    main()
