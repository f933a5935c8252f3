"""K9: the separable Gaussian blur of one plane.

Port of ``sift_pyocl_tpu/ops/pallas/conv.py::separable_blur_pallas``; the
kernel is ``sift_separable_blur`` in ``csrc/ladder.cu``, one launch of
K1's level kernel (``blur_level_kernel<K>``, without the DoG), so an
octave blurred level by level through K9 is bit-equal to K1's.  Each
pass clamps its reads to the plane's edges (the Pallas wrapper edge-pads
the plane first: the same values).  The plain version is the plain
pyramid's blur (``ops.pyramid.separable_blur_ref``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, on_cuda
from ..pyramid import separable_blur_ref


def _check(img: torch.Tensor, taps: torch.Tensor) -> None:
    if img.ndim != 2 or img.dtype != torch.float32:
        raise ValueError(f"expected an (H, W) float32 plane, got {tuple(img.shape)} {img.dtype}")
    if taps.ndim != 1 or taps.dtype != torch.float32 or taps.numel() % 2 != 1:
        raise ValueError("taps must be an odd number of float32 values")
    if taps.device != img.device:
        raise ValueError("taps and plane must lie on one device")


def separable_blur(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """`img` (H, W) f32 correlated with the 1-D `taps` along rows, then
    along columns, clamp-to-edge borders (symmetric Gaussian taps, so this
    is their convolution)."""
    _check(img, taps)
    if not on_cuda(img):
        return separable_blur_ref(img, taps)
    img, taps = img.contiguous(), taps.contiguous()
    H, W = img.shape
    out = torch.empty_like(img)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_separable_blur", [vp, vp, ci, ci, vp, ci, vp])
    with torch.cuda.device(img.device):
        err = fn(_build.ptr(img), _build.ptr(out), H, W, _build.ptr(taps), taps.numel(),
                 _build.stream_of(img))
    _build.check(err, "separable_blur")
    separable_blur.launches += 1
    return out


separable_blur.launches = 0
