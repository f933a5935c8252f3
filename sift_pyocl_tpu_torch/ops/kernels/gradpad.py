"""K5: gradient magnitude/orientation atlas of every octave.

Port of ``sift_pyocl_tpu/ops/pallas/gradpad.py::grad_atlas_pallas``; the
kernel is ``csrc/gradpad.cu``.  Layout (the port's own, unpadded):
``mag``/``ori`` of shape (scales, sum_o H_o, Wmax); octave o fills rows
[row_starts[o], row_starts[o] + H_o) and columns [0, W_o), zeros elsewhere.
The window kernel checks octave bounds instead of reading zero padding.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import _build, on_cuda
from ..orient_desc import gradient

Atlas = Tuple[torch.Tensor, torch.Tensor, List[int]]


def atlas_geometry(shapes: Sequence[Tuple[int, int]]) -> Tuple[List[int], int, int]:
    """(row_starts, rows, wmax) for octave image shapes [(H_o, W_o), ...]."""
    row_starts, rows = [], 0
    for h, _ in shapes:
        row_starts.append(rows)
        rows += h
    return row_starts, rows, max(w for _, w in shapes)


def _check(blur_list, scales) -> None:
    for b in blur_list:
        if b.dtype != torch.float32 or b.ndim != 3 or b.shape[0] < scales + 2:
            raise ValueError("blur stacks must be (scales+3, H, W) float32")
        if b.device != blur_list[0].device:
            raise ValueError("all blur stacks must lie on one device")


def grad_atlas(blur_list: Sequence[torch.Tensor], scales: int) -> Atlas:
    """Gradient atlas of planes 1..scales of every octave's blur stack.
    Returns (mag, ori, row_starts)."""
    _check(blur_list, scales)
    if not on_cuda(blur_list[0]):
        return grad_atlas_ref(blur_list, scales)
    blurs = [b.contiguous() for b in blur_list]
    dev = blurs[0].device
    row_starts, rows, wmax = atlas_geometry([tuple(b.shape[1:]) for b in blurs])
    mag = torch.empty(scales, rows, wmax, dtype=torch.float32, device=dev)
    ori = torch.empty_like(mag)
    n_oct = len(blurs)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_grad_atlas", [ci, vp, vp, vp, ci, ci, vp, vp, vp])
    ptrs = (vp * n_oct)(*[b.data_ptr() for b in blurs])
    hs = (ci * n_oct)(*[b.shape[1] for b in blurs])
    ws = (ci * n_oct)(*[b.shape[2] for b in blurs])
    with torch.cuda.device(dev):
        err = fn(n_oct, ptrs, hs, ws, int(scales), int(wmax), _build.ptr(mag),
                 _build.ptr(ori), _build.stream_of(mag))
    _build.check(err, "grad_atlas")
    grad_atlas.launches += 1
    return mag, ori, row_starts


grad_atlas.launches = 0


def grad_atlas_ref(blur_list: Sequence[torch.Tensor], scales: int) -> Atlas:
    """Plain PyTorch version of ``grad_atlas``: ``gradient`` of planes
    1..scales of each octave, placed in the same layout."""
    _check(blur_list, scales)
    row_starts, rows, wmax = atlas_geometry([tuple(b.shape[1:]) for b in blur_list])
    dev = blur_list[0].device
    mag = torch.zeros(scales, rows, wmax, dtype=torch.float32, device=dev)
    ori = torch.zeros_like(mag)
    for r0, b in zip(row_starts, blur_list):
        m, o = gradient(b[1 : scales + 1])
        _, h, w = m.shape
        mag[:, r0:r0 + h, :w] = m
        ori[:, r0:r0 + h, :w] = o
    return mag, ori, row_starts
