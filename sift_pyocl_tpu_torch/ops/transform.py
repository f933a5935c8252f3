"""Bilinear affine warp (reference: openCL/transform.cl::transform).

Port of ``sift_pyocl_tpu/ops/transform.py::affine_warp_jax``, a plain XLA
gather in the JAX package (no Pallas kernel), so plain PyTorch here:
out[r, c] = img[M @ (r, c) + offset], bilinear, with `fill` outside the
source image.  The arithmetic is the reference's, in f32 and in its order:
``sr = m00*r + m01*c + off0``, ``floor``, four clamped gathers and the
``valid`` test.  ``grid_sample`` is not used: its edge and ``align_corners``
semantics give other values at the border.

The JAX package jits the warp, one program per image shape.  On a CUDA
device ``affine_warp`` likewise replays one CUDA graph per (device, H, W,
`fill`) (``WARP_GRAPHS``): the image, the matrix and the offset are its
inputs, copied in by the replay (host arrays by their own copies, which do
not wait for the device), and the warped image is a view of one fresh
buffer.  ``_affine_warp_eager`` is the body the graph captures, and what
the CPU runs.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..utils import graphs
from . import as_tensor, device_of


def affine_warp(img, matrix, offset, fill: float = 0.0,
                device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """(H, W) f32 warp of `img` by (matrix (2, 2), offset (2,)) in (row, col).

    Tensors or arrays.  It runs on `device` where given, else on `img`'s
    device if `img` is a tensor, else on the CUDA card (``device=None``
    raises without one; pass ``device="cpu"`` for the CPU).  Returns a
    tensor on that device: on a card the replay of ``WARP_GRAPHS``'s graph
    for the image's shape and `fill`."""
    dev = device_of(img, device)
    if dev.type != "cuda":
        return _affine_warp_eager(img, matrix, offset, fill, dev)
    inputs = [torch.as_tensor(a).to(torch.float32) for a in (img, matrix, offset)]
    return WARP_GRAPHS(dev, float(fill), inputs)[0]


def _affine_warp_eager(img, matrix, offset, fill: float = 0.0,
                       device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """``affine_warp`` op by op on its device (what its graph captures)."""
    dev = device_of(img, device)
    x, m, off = (as_tensor(a, dev, torch.float32) for a in (img, matrix, offset))
    return _warp_flat(float(fill), x, m, off)[0]


def _warp_flat(fill: float, x: torch.Tensor, m: torch.Tensor, off: torch.Tensor):
    """The warp of f32 `x` on its device (a graph body)."""
    dev = x.device
    H, W = x.shape
    rr = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    cc = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    sr = m[0, 0] * rr + m[0, 1] * cc + off[0]
    sc = m[1, 0] * rr + m[1, 1] * cc + off[1]
    r0 = torch.floor(sr)
    c0 = torch.floor(sc)
    fr = sr - r0
    fc = sc - c0
    valid = (sr >= 0) & (sr <= H - 1) & (sc >= 0) & (sc <= W - 1)
    # f32 -> int32 truncates toward zero, as XLA's convert does (r0 is
    # already integral; out-of-range values are clamped, then masked)
    r0i = r0.to(torch.int32)
    c0i = c0.to(torch.int32)
    r1i = (r0i + 1).clamp(0, H - 1).long()
    c1i = (c0i + 1).clamp(0, W - 1).long()
    r0i = r0i.clamp(0, H - 1).long()
    c0i = c0i.clamp(0, W - 1).long()
    out = (x[r0i, c0i] * (1 - fr) * (1 - fc)
           + x[r1i, c0i] * fr * (1 - fc)
           + x[r0i, c1i] * (1 - fr) * fc
           + x[r1i, c1i] * fr * fc)
    return (torch.where(valid, out, fill),)


# the warp on the card: one CUDA graph per (device, H, W, fill)
WARP_GRAPHS = graphs.GraphCache(_warp_flat)

# The JAX package's name (the port keeps its names, as match_descriptors_jax).
affine_warp_jax = affine_warp
