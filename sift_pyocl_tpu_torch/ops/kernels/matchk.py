"""K7: best-2 squared-L2 descriptor matching.

Port of ``sift_pyocl_tpu/ops/pallas/matchk.py::best2_l2_pallas``; the kernels
are ``csrc/matchk.cu``.  Per query row: the smallest squared-L2 distance
``d1``, the lowest column ``i1`` that holds it, and ``d2``, the smallest over
every other column; invalid columns are +inf.  Two operand forms, as in the
TPU kernel: u8 descriptors (K7), where every distance is an exact integer in
f32, so the kernel and the plain version agree bit for bit; and f32 (K7f,
also for mixed u8/f32, cast to f32 as the JAX wrapper does), where they
differ by the order of the dot products' sums.  There is no cap on the
number of columns.  ``two_pass`` chooses how the TPU kernel reduces a
distance tile; both of its values compute this one function, which the
port's kernels compute whichever is given.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build, on_cuda

Best2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(desc1, desc2, valid2, valid1) -> None:
    if desc1.ndim != 2 or desc2.ndim != 2 or desc1.shape[1] != 128 or desc2.shape[1] != 128:
        raise ValueError(f"descriptors must be (N, 128), got {tuple(desc1.shape)} "
                         f"and {tuple(desc2.shape)}")
    if desc2.shape[0] < 1:
        raise ValueError("desc2 needs at least one row")
    if valid2.shape != (desc2.shape[0],):
        raise ValueError("valid2 must be (N2,)")
    if valid1 is not None and valid1.shape != (desc1.shape[0],):
        raise ValueError("valid1 must be (N1,)")
    for t in (desc2, valid2, valid1):
        if t is not None and t.device != desc1.device:
            raise ValueError("all inputs must lie on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, valid2: torch.Tensor,
            valid1: Optional[torch.Tensor]) -> Best2:
    """One launch of the C entry `name` on prepared operands."""
    n1, n2 = a.shape[0], b.shape[0]
    v2 = valid2.to(torch.uint8).contiguous()
    v1 = None if valid1 is None else valid1.to(torch.uint8).contiguous()
    d1 = torch.empty(n1, dtype=torch.float32, device=a.device)
    d2 = torch.empty_like(d1)
    i1 = torch.empty(n1, dtype=torch.int32, device=a.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function(name, [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp])
    with torch.cuda.device(a.device):
        err = fn(_build.ptr(a), _build.ptr(b), None if v1 is None else _build.ptr(v1),
                 _build.ptr(v2), n1, n2, _build.ptr(d1), _build.ptr(d2), _build.ptr(i1),
                 _build.stream_of(a))
    _build.check(err, name)
    return d1, d2, i1


def best2_l2(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor,
             valid1: Optional[torch.Tensor] = None, two_pass: bool = False) -> Best2:
    """(d1 (N1,) f32, d2 (N1,) f32, i1 (N1,) int32) of squared-L2 distances.

    On the card: K7 for two uint8 descriptor sets, else K7f
    (``best2_l2_f32``); rows whose `valid1` is False return (0, 0, 0), and
    every caller masks them.  On the CPU the plain version computes every
    row.  ``two_pass`` (False or True) is the TPU kernel's reduction choice
    and gives the same result."""
    _check(desc1, desc2, valid2, valid1)
    if two_pass not in (False, True):
        raise ValueError(f"two_pass must be False or True, got {two_pass!r}")
    if not on_cuda(desc1):
        return best2_l2_ref(desc1, desc2, valid2)
    if desc1.dtype != torch.uint8 or desc2.dtype != torch.uint8:
        return best2_l2_f32(desc1, desc2, valid2, valid1)
    out = _launch("sift_best2_l2", _aligned(desc1), _aligned(desc2), valid2, valid1)
    best2_l2.launches += 1
    return out


best2_l2.launches = 0


def best2_l2_f32(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor,
                 valid1: Optional[torch.Tensor] = None) -> Best2:
    """K7f: ``best2_l2`` with both descriptor sets cast to f32 (the TPU
    kernel's f32 operand form, and its mixed u8/f32 one); its launches are
    counted here, apart from K7's u8 ones."""
    _check(desc1, desc2, valid2, valid1)
    if not on_cuda(desc1):
        return best2_l2_ref(desc1, desc2, valid2)
    out = _launch("sift_best2_l2_f32", desc1.to(torch.float32).contiguous(),
                  desc2.to(torch.float32).contiguous(), valid2, valid1)
    best2_l2_f32.launches += 1
    return out


best2_l2_f32.launches = 0


def best2_l2_ref(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor,
                 valid1: Optional[torch.Tensor] = None) -> Best2:
    """Plain PyTorch version (``ops/match.py::_best2_l2`` of the JAX
    package): one f32 matmul, then min, first argmin and the min with the
    argmin column masked.  Every row is computed; `valid1` is ignored."""
    _check(desc1, desc2, valid2, valid1)
    a = desc1.to(torch.float32)
    b = desc2.to(torch.float32)
    ab = a @ b.T
    na = (a * a).sum(1)
    nb = (b * b).sum(1)
    dist = na[:, None] + nb[None, :] - 2.0 * ab
    dist = torch.where(valid2.bool()[None, :], dist.clamp_min(0.0), torch.inf)
    d1 = dist.min(dim=1).values
    i1 = dist.argmin(dim=1)
    col = torch.arange(dist.shape[1], device=dist.device)
    d2 = torch.where(col[None, :] == i1[:, None], torch.inf, dist).min(dim=1).values
    return d1, d2, i1.to(torch.int32)
