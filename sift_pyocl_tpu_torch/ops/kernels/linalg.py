"""K12 and K13: batched small eigen- and singular-value decompositions.

No Pallas kernel stands behind these two: they are what ``jnp.linalg.eigh``
and ``jnp.linalg.svd`` are inside the JAX package's jitted two-view init
(``sift_pyocl_tpu/sfm/twoview.py``).  Their kernels are ``csrc/linalg.cu``
and read nothing back to the host, so a CUDA graph can hold them, where
``torch.linalg.eigh`` and ``torch.linalg.svd`` on the card read cuSOLVER's
error flags.  The plain versions are those two calls: what the CPU runs,
and the same function.  Eigenvector and singular-vector signs (and, for
repeated values, the basis of their subspace) differ between the kernels
and the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build, on_cuda

EIG_MAX_N = 9     # csrc/linalg.cu's EIG_MAX_N


def _check_square(A: torch.Tensor, what: str, sizes: range) -> None:
    if A.ndim < 2 or A.shape[-1] != A.shape[-2] or A.shape[-1] not in sizes:
        raise ValueError(f"{what}: need (..., n, n) with n in {sizes}, got {tuple(A.shape)}")


def _check_f32(A: torch.Tensor, what: str) -> None:
    """The kernels take float32 (the plain versions any float type)."""
    if A.dtype != torch.float32:
        raise ValueError(f"{what}: the kernel needs float32, got {A.dtype}")


def sym_eig_small(A: torch.Tensor, plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n, n) symmetric, n <= 9 (the lower triangle is read) ->
    (eigenvalues (..., n) ascending, eigenvectors (..., n, n), column i
    that of value i), as ``torch.linalg.eigh``.  K12 on a CUDA tensor (f32;
    one launch a call), the plain version on a CPU tensor or with
    `plain`."""
    _check_square(A, "sym_eig_small", range(1, EIG_MAX_N + 1))
    if plain or not on_cuda(A):
        return sym_eig_small_ref(A)
    _check_f32(A, "sym_eig_small")
    n = A.shape[-1]
    a = A.reshape(-1, n, n).contiguous()
    w = torch.empty(a.shape[:2], dtype=torch.float32, device=A.device)
    v = torch.empty_like(a)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_sym_eig_small", [vp, vp, vp, ci, ci, vp])
    with torch.cuda.device(A.device):
        err = fn(_build.ptr(a), _build.ptr(w), _build.ptr(v), a.shape[0], n, _build.stream_of(a))
    _build.check(err, "sym_eig_small")
    sym_eig_small.launches += 1
    return w.reshape(A.shape[:-1]), v.reshape(A.shape)


sym_eig_small.launches = 0


def sym_eig_small_ref(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K12: ``torch.linalg.eigh``."""
    return tuple(torch.linalg.eigh(A))


def svd3(A: torch.Tensor, plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 3, 3) -> (U (..., 3, 3), S (..., 3) descending, Vh (..., 3,
    3)) with A = U diag(S) Vh, as ``torch.linalg.svd``.  K13 on a CUDA
    tensor (f32; one launch a call), whose U has as third column the cross
    product of the first two (with the sign of A's third direction), so it
    is well defined when S[2] is 0; the plain version on a CPU tensor or
    with `plain`."""
    _check_square(A, "svd3", range(3, 4))
    if plain or not on_cuda(A):
        return svd3_ref(A)
    _check_f32(A, "svd3")
    a = A.reshape(-1, 3, 3).contiguous()
    u, vh = torch.empty_like(a), torch.empty_like(a)
    s = torch.empty(a.shape[:2], dtype=torch.float32, device=A.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_svd3", [vp, vp, vp, vp, ci, vp])
    with torch.cuda.device(A.device):
        err = fn(_build.ptr(a), _build.ptr(u), _build.ptr(s), _build.ptr(vh), a.shape[0],
                 _build.stream_of(a))
    _build.check(err, "svd3")
    svd3.launches += 1
    return u.reshape(A.shape), s.reshape(A.shape[:-1]), vh.reshape(A.shape)


svd3.launches = 0


def svd3_ref(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K13: ``torch.linalg.svd``."""
    return tuple(torch.linalg.svd(A))
