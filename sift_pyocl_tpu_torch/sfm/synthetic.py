"""Synthetic SfM problems for tests and benchmarks: they play the role of
"standard sequences" for the ATE bound.

A NumPy copy of ``sift_pyocl_tpu/sfm/synthetic.py`` that returns this
package's ``BAParams`` / ``BAObs`` (of NumPy arrays, as there);
``tests/test_torch_config.py`` holds it equal to the original."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .ba import BAObs, BAParams


def look_at(center: np.ndarray, target: np.ndarray, up=np.array([0.0, -1.0, 0.0])):
    """World-to-camera (R, t) for a camera at `center` looking at `target`."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])  # rows = camera axes in world
    t = -R @ center
    return R, t


def make_problem(
    n_cams: int = 8,
    n_points: int = 200,
    noise_px: float = 0.5,
    seed: int = 0,
    image_size: Tuple[int, int] = (640, 480),
    radius: float = 6.0,
    arc_deg: float = 60.0,
):
    """Camera arc around a point cloud; all points observed by all cameras
    that see them in front and in frame.  Returns (K, gt_params, obs, meta)."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1.0]])
    pts = rng.uniform([-2, -2, -1], [2, 2, 1], (n_points, 3))
    Rs, ts, centers = [], [], []
    for i in range(n_cams):
        ang = np.deg2rad(arc_deg) * (i / max(n_cams - 1, 1) - 0.5)
        center = np.array([radius * np.sin(ang), 0.3 * np.sin(2 * ang), -radius * np.cos(ang)])
        R, t = look_at(center, np.zeros(3))
        Rs.append(R)
        ts.append(t)
        centers.append(center)
    Rs = np.stack(Rs)
    ts = np.stack(ts)

    cam_ids, pt_ids, uvs = [], [], []
    for c in range(n_cams):
        Xc = pts @ Rs[c].T + ts[c]
        z = Xc[:, 2]
        u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
        vis = (z > 0.5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        idx = np.nonzero(vis)[0]
        cam_ids.append(np.full(len(idx), c))
        pt_ids.append(idx)
        uvs.append(np.stack([u[idx], v[idx]], axis=1))
    cam_ids = np.concatenate(cam_ids).astype(np.int32)
    pt_ids = np.concatenate(pt_ids).astype(np.int32)
    uvs = np.concatenate(uvs).astype(np.float32)
    uvs += rng.normal(0, noise_px, uvs.shape).astype(np.float32)

    params = BAParams(Rs=Rs.astype(np.float32), ts=ts.astype(np.float32),
                      X=pts.astype(np.float32))
    obs = BAObs(uv=uvs, cam=cam_ids, pt=pt_ids,
                w=np.ones(len(cam_ids), np.float32))
    meta = {"centers": np.stack(centers), "K": K}
    return K.astype(np.float32), params, obs, meta


def perturb(params: BAParams, rot_deg: float, trans: float, point_sigma: float,
            seed: int = 1, keep_fixed=(0,)) -> BAParams:
    """Add noise to poses/points (except cameras in keep_fixed) — BA's start."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    Rs = np.array(params.Rs).copy()
    ts = np.array(params.ts).copy()
    X = np.array(params.X).copy()
    for c in range(Rs.shape[0]):
        if c in keep_fixed:
            continue
        dR = Rotation.from_rotvec(
            rng.normal(0, np.deg2rad(rot_deg), 3)
        ).as_matrix()
        Rs[c] = dR @ Rs[c]
        ts[c] = ts[c] + rng.normal(0, trans, 3)
    X += rng.normal(0, point_sigma, X.shape)
    return BAParams(Rs.astype(np.float32), ts.astype(np.float32), X.astype(np.float32))
