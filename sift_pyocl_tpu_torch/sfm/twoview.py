"""Two-view initialization: relative pose and initial structure.

Port of ``sift_pyocl_tpu/sfm/twoview.py``: essential RANSAC on
K-normalized coordinates, the cheirality-tested pose among the four
decompositions, then triangulation, all at static shapes with masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import as_tensor, device_of
from .geometry import (_eye3, backproject, choose_pose, decompose_essential, sampson_error_F,
                       triangulate_two_view)
from .ransac import ransac_essential_normalized


class TwoViewInit(NamedTuple):
    R: torch.Tensor          # (3, 3) pose of cam2 (cam1 = identity)
    t: torch.Tensor          # (3,) unit-norm translation (scale is free)
    points: torch.Tensor     # (N, 3) triangulated points (world = cam1 frame)
    inliers: torch.Tensor    # (N,) bool: essential inliers with positive depths
    n_inliers: torch.Tensor  # () int32


def initialize_two_view(seed: int, K, uv1, uv2, valid, thresh_px: float = 1.5,
                        n_hypo: int = 256, min_parallax_deg: float = 0.0, weights=None,
                        device=None) -> TwoViewInit:
    """Essential RANSAC -> cheirality-tested pose -> triangulated structure.

    Tensors or arrays; on `device` where given, else on `uv1`'s device if it
    is a tensor, else on the CUDA card (raises without one).  ``weights``:
    the (n_hypo, N) RANSAC rows to use in place of drawing them from `seed`.
    `min_parallax_deg` is accepted and unused, as in the JAX package."""
    dev = device_of(uv1, device)
    K, uv1, uv2 = (as_tensor(a, dev, torch.float32) for a in (K, uv1, uv2))
    valid = as_tensor(valid, dev, torch.bool)
    f = 0.5 * (K[0, 0] + K[1, 1])
    xy1 = backproject(K, uv1)[:, :2]
    xy2 = backproject(K, uv2)[:, :2]
    res = ransac_essential_normalized(seed, xy1, xy2, valid, thresh=(thresh_px / f) ** 2,
                                      n_hypo=n_hypo, weights=weights)
    E = res.model                # rank 2, ~unit norm on normalized coordinates
    Rs, ts = decompose_essential(E)
    eye = _eye3(xy1)
    R, t, _ = choose_pose(Rs, ts, eye, eye, xy1, xy2, res.inliers.to(torch.float32))
    X, z1, z2 = triangulate_two_view(eye, eye, torch.zeros_like(t), eye, R, t, xy1, xy2)
    good = res.inliers & (z1 > 1e-6) & (z2 > 1e-6)
    # reprojection check in pixels with the real K
    err = sampson_error_F(E, xy1, xy2) * f * f
    good = good & (err < thresh_px ** 2)
    return TwoViewInit(R, t, X, good, good.sum(dtype=torch.int32))
