"""K1 and K2: the Gaussian blur ladders of the scale-space pyramid.

Port of ``sift_pyocl_tpu/ops/pallas/ladder0.py::octave0_ladder`` (K1) and
``sift_pyocl_tpu/ops/pallas/ladder.py::small_octaves_ladder`` (K2); the
kernels are ``csrc/ladder.cu``, one launch per blur level.  Taps are
``oracle.gaussian_kernel``'s, uploaded once per (sigmas, device); every
level clamps to its own edges, as ``ops.pyramid.blur`` does.  The plain
versions are the plain pyramid's (``ops.pyramid.octave0_ladder_ref`` and
``small_octaves_ladder_ref``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _build, on_cuda
from ..pyramid import Ladder, octave0_ladder_ref, small_octaves_ladder_ref
from ...oracle import gaussian_kernel


@lru_cache(maxsize=32)
def _taps_table(sigmas: Tuple[float, ...], device: torch.device):
    """Every sigma's taps back to back on `device`, with C arrays of each
    entry's offset and length."""
    taps = [gaussian_kernel(s) for s in sigmas]
    sizes = [len(t) for t in taps]
    offsets = np.cumsum([0] + sizes[:-1]).tolist()
    n = len(taps)
    flat = torch.as_tensor(np.concatenate(taps), device=device)
    return flat, (ctypes.c_int * n)(*offsets), (ctypes.c_int * n)(*sizes)


def _check_plane(x: torch.Tensor) -> None:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"expected an (H, W) float32 plane, got {tuple(x.shape)} {x.dtype}")


def octave0_ladder(img: torch.Tensor, pre_sigma: float,
                   increments: Sequence[float]) -> Ladder:
    """Octave 0's blur stack (len(increments)+1, H, W) and DoG stack
    (len(increments), H, W) from the normalized image: level 0 is `img`
    blurred by `pre_sigma`, level l+1 is level l blurred by
    ``increments[l]``.  (An input that needs no pre-blur takes the
    per-level route of ``ops.pyramid``, as in the JAX package.)"""
    _check_plane(img)
    if not on_cuda(img):
        return octave0_ladder_ref(img, pre_sigma, increments)
    H, W = img.shape
    n = len(increments)
    taps, offsets, sizes = _taps_table((float(pre_sigma),) + tuple(map(float, increments)),
                                       img.device)
    img = img.contiguous()
    blurs = torch.empty((n + 1, H, W), dtype=torch.float32, device=img.device)
    dogs = torch.empty((n, H, W), dtype=torch.float32, device=img.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_octave0_ladder", [vp, vp, vp, ci, ci, vp, vp, vp, ci, vp])
    with torch.cuda.device(img.device):
        err = fn(_build.ptr(img), _build.ptr(blurs), _build.ptr(dogs), H, W,
                 _build.ptr(taps), offsets, sizes, n, _build.stream_of(img))
    _build.check(err, "octave0_ladder")
    octave0_ladder.launches += 1
    return blurs, dogs


octave0_ladder.launches = 0


def _geometry(h: int, w: int, n_oct: int) -> List[Tuple[int, int]]:
    """Ceil-halved octave sizes ((h+1)//2 rows), as img[::2, ::2]."""
    out = []
    for _ in range(n_oct):
        out.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def _check_small(base1: torch.Tensor, increments, n_oct: int, scales: int, ds_mode: str):
    _check_plane(base1)
    if n_oct < 1 or not 0 <= scales <= len(increments):
        raise ValueError(f"n_oct={n_oct}, scales={scales}: need n_oct >= 1 and "
                         f"0 <= scales <= {len(increments)}")
    if ds_mode not in ("shrink", "bin"):
        raise ValueError(f"unknown ds_mode {ds_mode!r}")


def small_octaves_ladder(base1: torch.Tensor, increments: Sequence[float], n_oct: int,
                         scales: int, ds_mode: str = "shrink") -> List[Ladder]:
    """Blur and DoG stacks of `n_oct` octaves from the first small octave's
    base (octave 0's level `scales`, downsampled): each octave's level 0 is
    its base, the next base is level `scales` shrunk or 2x2-binned."""
    _check_small(base1, increments, n_oct, scales, ds_mode)
    if not on_cuda(base1):
        return small_octaves_ladder_ref(base1, increments, n_oct, scales, ds_mode)
    dev = base1.device
    n = len(increments)
    geo = _geometry(*base1.shape, n_oct)
    taps, offsets, sizes = _taps_table(tuple(map(float, increments)), dev)
    blurs = [torch.empty((n + 1, h, w), dtype=torch.float32, device=dev) for h, w in geo]
    dogs = [torch.empty((n, h, w), dtype=torch.float32, device=dev) for h, w in geo]
    blurs[0][0].copy_(base1)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_small_octaves_ladder",
                         [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp])
    bp = (vp * n_oct)(*[b.data_ptr() for b in blurs])
    dp = (vp * n_oct)(*[d.data_ptr() for d in dogs])
    hs = (ci * n_oct)(*[h for h, _ in geo])
    ws = (ci * n_oct)(*[w for _, w in geo])
    with torch.cuda.device(dev):
        err = fn(n_oct, bp, dp, hs, ws, _build.ptr(taps), offsets, sizes, n, scales,
                 int(ds_mode == "bin"), _build.stream_of(base1))
    _build.check(err, "small_octaves_ladder")
    small_octaves_ladder.launches += 1
    return list(zip(blurs, dogs))


small_octaves_ladder.launches = 0
