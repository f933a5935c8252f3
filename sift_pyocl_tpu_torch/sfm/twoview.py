"""Two-view initialization: relative pose and initial structure.

Port of ``sift_pyocl_tpu/sfm/twoview.py``: essential RANSAC on
K-normalized coordinates, the cheirality-tested pose among the four
decompositions, then triangulation, all at static shapes with masks.

The JAX package jits ``initialize_two_view`` as one program.  On a CUDA
device it replays one CUDA graph per (device, input shapes, `thresh_px`,
`n_hypo`, rows given) (``TWOVIEW_GRAPHS``; callers pad the matches to a
power-of-two bucket with a `valid` mask, as the JAX package does): its
eigen- and singular-value decompositions are the kernels K12 and K13
(``ops.kernels.linalg``), and the RANSAC rows' noise is drawn on the host
(``ransac.ransac_host_noise``) and goes in as an input, the top-k taken
inside (``ransac.ransac(noise=)``).  Elsewhere, and as the replay's
reference, it runs ``_initialize_two_view_eager``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import as_tensor, device_of
from ..utils import graphs
from .geometry import (_eye3, backproject, choose_pose, decompose_essential, sampson_error_F,
                       triangulate_two_view)
from .ransac import ransac_essential_normalized, ransac_host_noise


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
    `min_parallax_deg` is accepted and unused, as in the JAX package.  On a
    CUDA device one graph replay (``TWOVIEW_GRAPHS``) with no host sync: the
    fields are views of one buffer, which ``graphs.to_host`` brings home in
    one copy."""
    dev = device_of(uv1, device)
    if dev.type != "cuda":
        return _initialize_two_view_eager(seed, K, uv1, uv2, valid, thresh_px, n_hypo,
                                          min_parallax_deg, weights, dev)
    static, inputs = _two_view_inputs(seed, K, uv1, uv2, valid, thresh_px, n_hypo, weights,
                                      dev)
    return TwoViewInit(*TWOVIEW_GRAPHS(dev, static, inputs))


def _initialize_two_view_eager(seed: int, K, uv1, uv2, valid, thresh_px: float = 1.5,
                               n_hypo: int = 256, min_parallax_deg: float = 0.0, weights=None,
                               device=None) -> TwoViewInit:
    """``initialize_two_view`` op by op on its device (what its graph
    captures; what the CPU runs)."""
    dev = device_of(uv1, device)
    static, inputs = _two_view_inputs(seed, K, uv1, uv2, valid, thresh_px, n_hypo, weights,
                                      dev)
    return TwoViewInit(*_two_view_flat(static, *(a.to(dev) for a in inputs)))


def _host_or(x, dtype: torch.dtype) -> torch.Tensor:
    """`x` as a tensor of `dtype`: a tensor stays where it lies, an array
    becomes a host tensor (copied in by the graph's input fill)."""
    if torch.is_tensor(x):
        return x.to(dtype=dtype)
    return torch.from_numpy(np.array(x)).to(dtype)


def _two_view_inputs(seed, K, uv1, uv2, valid, thresh_px, n_hypo, weights, dev):
    """(static, inputs) of ``_two_view_flat``: K on the device first, then
    the points, the mask and the host noise (``ransac_host_noise``) or the
    caller's rows where they lie."""
    uv1, uv2 = (_host_or(a, torch.float32) for a in (uv1, uv2))
    valid = _host_or(valid, torch.bool)
    rows = ransac_host_noise(seed, n_hypo, uv1.shape[0]) if weights is None else \
        _host_or(weights, torch.float32)
    static = (float(thresh_px), int(n_hypo), weights is not None)
    return static, (as_tensor(K, dev, torch.float32), uv1, uv2, valid, rows)


def _two_view_flat(static, K, uv1, uv2, valid, rows):
    """The two-view init from flat inputs on K's device (a graph body):
    `rows` the host noise the RANSAC draws its rows from or, with rows
    given, the rows.  Returns (R, t, points, inliers, n_inliers)."""
    thresh_px, n_hypo, given = static
    f = 0.5 * (K[0, 0] + K[1, 1])
    xy1 = backproject(K, uv1)[:, :2]
    xy2 = backproject(K, uv2)[:, :2]
    res = ransac_essential_normalized(0, xy1, xy2, valid, thresh=(thresh_px / f) ** 2,
                                      n_hypo=n_hypo, weights=rows if given else None,
                                      noise=None if given else rows)
    E = res.model                # rank 2, ~unit norm on normalized coordinates
    Rs, ts = decompose_essential(E)
    eye = _eye3(xy1)
    R, t, _ = choose_pose(Rs, ts, eye, eye, xy1, xy2, res.inliers.to(torch.float32))
    X, z1, z2 = triangulate_two_view(eye, eye, torch.zeros_like(t), eye, R, t, xy1, xy2)
    good = res.inliers & (z1 > 1e-6) & (z2 > 1e-6)
    # reprojection check in pixels with the real K
    err = sampson_error_F(E, xy1, xy2) * f * f
    good = good & (err < thresh_px ** 2)
    return R, t, X, good, good.sum(dtype=torch.int32)


# initialize_two_view's graphs on the card (the SfM bootstrap)
TWOVIEW_GRAPHS = graphs.GraphCache(_two_view_flat)
