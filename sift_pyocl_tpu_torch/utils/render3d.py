"""Synthetic 3-D scene renderer for end-to-end SfM tests (a NumPy copy of
``sift_pyocl_tpu/utils/render3d.py``; ``tests/test_torch_config.py`` holds
its frames bit-equal to the original's).

Renders Gaussian blobs anchored at 3-D world points as seen by a moving
pinhole camera (blob screen size scales with inverse depth), giving image
sequences with true parallax and a known trajectory: the stand-in for
standard benchmark sequences (BASELINE.md ATE criterion), made from a seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..sfm.synthetic import look_at


def make_trajectory(n_frames: int, radius: float = 8.0, arc_deg: float = 40.0,
                    bob: float = 0.3, out_and_back: bool = False):
    """Arc of world-to-camera poses looking at the origin.

    out_and_back: traverse the arc and RETURN (0 -> arc -> 0), so the last
    frames revisit the first views — a loop-closure sequence."""
    Rs, ts = [], []
    for i in range(n_frames):
        u = i / max(n_frames - 1, 1)
        if out_and_back:
            u = 1.0 - abs(2.0 * u - 1.0)   # 0 -> 1 -> 0
        a = np.deg2rad(arc_deg) * (u - 0.5)
        center = np.array([radius * np.sin(a), bob * np.sin(3 * a), -radius * np.cos(a)])
        R, t = look_at(center, np.zeros(3))
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def render_sequence(
    n_frames: int = 12,
    n_points: int = 180,
    image_size: Tuple[int, int] = (320, 240),
    f: float = 300.0,
    seed: int = 0,
    radius: float = 8.0,
    arc_deg: float = 40.0,
    out_and_back: bool = False,
) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray, np.ndarray]:
    """Returns (K, frames, gt_Rs, gt_ts)."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    pts = rng.uniform([-3, -2.2, -1.5], [3, 2.2, 1.5], (n_points, 3))
    size3d = rng.uniform(0.04, 0.12, n_points)
    # each landmark = a unique asymmetric cluster of sub-blobs (plain radial
    # Gaussians are SIFT's worst case: no stable orientation, and identical
    # appearance makes the ratio test reject everything)
    n_sat = 5
    sat_off = rng.uniform(-2.2, 2.2, (n_points, n_sat, 2))  # in units of size3d
    sat_amp = rng.uniform(40, 150, (n_points, n_sat)) * rng.choice(
        [-1.0, 1.0], (n_points, n_sat)
    )
    sat_sig = rng.uniform(0.5, 1.2, (n_points, n_sat))       # in units of size3d
    Rs, ts = make_trajectory(n_frames, radius=radius, arc_deg=arc_deg,
                             out_and_back=out_and_back)

    cc, rr = np.meshgrid(np.arange(w), np.arange(h))
    frames = []
    for i in range(n_frames):
        Xc = pts @ Rs[i].T + ts[i]
        z = Xc[:, 2]
        vis = z > 1.0
        u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
        scale = K[0, 0] * size3d / z  # screen pixels per size3d unit
        img = np.full((h, w), 8.0, np.float32)
        for j in np.nonzero(vis)[0]:
            if not (-30 < u[j] < w + 30 and -30 < v[j] < h + 30):
                continue
            for k in range(n_sat):
                us = u[j] + sat_off[j, k, 0] * scale[j]
                vs = v[j] + sat_off[j, k, 1] * scale[j]
                s = max(sat_sig[j, k] * scale[j], 0.7)
                img += sat_amp[j, k] * np.exp(
                    -((rr - vs) ** 2 + (cc - us) ** 2) / (2 * s * s)
                ).astype(np.float32)
        img -= img.min()
        img *= 255.0 / max(img.max(), 1e-9)
        frames.append(img.astype(np.float32))
    return K, frames, Rs, ts
