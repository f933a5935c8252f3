"""K1 and K2: the Gaussian blur ladders of the scale-space pyramid.

Port of ``sift_pyocl_tpu/ops/pallas/ladder0.py::octave0_ladder`` (K1) and
``sift_pyocl_tpu/ops/pallas/ladder.py::small_octaves_ladder`` (K2); the
kernels are ``csrc/ladder.cu``, one launch per blur level.  Taps are
``oracle.gaussian_kernel``'s, uploaded once per (sigmas, device); every
level clamps to its own edges, as ``ops.pyramid.blur`` does.  The plain
versions are the plain pyramid's (``ops.pyramid.octave0_ladder_ref`` and
``small_octaves_ladder_ref``).

With ``mask_cfg`` (the TPU kernels' argument of that name, behind
``SiftConfig(mask_backend="fused")``) each octave also gets its extrema
mask from inside the ladder, as a third value: K1m ``octave0_ladder_mask``
and K2m ``small_octaves_ladder_mask``, which count their launches apart
from K1's and K2's.  The JAX kernels return the mask with garbage borders;
these return it border-stripped, (scales, H - 2bd, W - 2bd) bool, as K8
and the plain stencil do, so ``mask_cfg`` carries ``bd`` as its third
entry.  Their plain versions are the plain ladder followed by the stencil
(``maskk.stencil_mask``) on its DoGs.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build, on_cuda
from ..pyramid import Ladder, octave0_ladder_ref, small_octaves_ladder_ref
from ...oracle import gaussian_kernel
from .maskk import stencil_mask

# (blurs, dogs, mask) of one octave in the mask form
MaskedLadder = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def _check_mask_cfg(mask_cfg, n_levels: int, shapes, n_eths: Optional[int]):
    """(peak_thresh, eth or eths, bd) of a mask form, checked against the
    ladder's levels and octave shapes."""
    if len(mask_cfg) != 3:
        raise ValueError("mask_cfg is (peak_thresh, edge threshold(s), border_dist)")
    peak, eth, bd = mask_cfg
    if n_eths is not None and len(eth) != n_eths:
        raise ValueError(f"need one edge threshold per octave ({n_eths}), got {len(eth)}")
    if n_levels < 3 or bd < 1 or any(h <= 2 * bd or w <= 2 * bd for h, w in shapes):
        raise ValueError(f"the mask needs >= 3 DoG planes, bd >= 1 and octaves wider than "
                         f"2 bd; got {n_levels} planes, bd {bd}, octaves {list(shapes)}")
    return float(peak), eth, int(bd)


def octave0_ladder(img: torch.Tensor, pre_sigma: float, increments: Sequence[float],
                   mask_cfg: Optional[Tuple[float, float, int]] = None):
    """Octave 0's blur stack (len(increments)+1, H, W) and DoG stack
    (len(increments), H, W) from the normalized image: level 0 is `img`
    blurred by `pre_sigma`, level l+1 is level l blurred by
    ``increments[l]``.  (An input that needs no pre-blur takes the
    per-level route of ``ops.pyramid``, as in the JAX package.)  With
    ``mask_cfg=(peak_thresh, eth, bd)``, K1m: the same stacks and the
    extrema mask as a third value (``octave0_ladder_mask``)."""
    if mask_cfg is not None:
        return octave0_ladder_mask(img, pre_sigma, increments, mask_cfg)
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


def octave0_ladder_mask(img: torch.Tensor, pre_sigma: float, increments: Sequence[float],
                        mask_cfg: Tuple[float, float, int]) -> MaskedLadder:
    """K1m: ``octave0_ladder``'s stacks, bit-equal to K1's, and octave 0's
    (len(increments) - 2, H - 2bd, W - 2bd) bool extrema mask at
    ``mask_cfg = (peak_thresh, eth, bd)``, equal to the stencil's on those
    DoGs."""
    _check_plane(img)
    n = len(increments)
    H, W = img.shape
    peak, eth, bd = _check_mask_cfg(mask_cfg, n, [(H, W)], None)
    if not on_cuda(img):
        return octave0_ladder_mask_ref(img, pre_sigma, increments, mask_cfg)
    taps, offsets, sizes = _taps_table((float(pre_sigma),) + tuple(map(float, increments)),
                                       img.device)
    img = img.contiguous()
    blurs = torch.empty((n + 1, H, W), dtype=torch.float32, device=img.device)
    dogs = torch.empty((n, H, W), dtype=torch.float32, device=img.device)
    mask = torch.empty((n - 2, H - 2 * bd, W - 2 * bd), dtype=torch.uint8, device=img.device)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function("sift_octave0_ladder_mask",
                         [vp, vp, vp, vp, ci, ci, vp, vp, vp, ci, ci, cf, cf, vp])
    with torch.cuda.device(img.device):
        err = fn(_build.ptr(img), _build.ptr(blurs), _build.ptr(dogs), _build.ptr(mask), H, W,
                 _build.ptr(taps), offsets, sizes, n, bd, float(0.8 * peak), float(eth),
                 _build.stream_of(img))
    _build.check(err, "octave0_ladder_mask")
    octave0_ladder_mask.launches += 1
    return blurs, dogs, mask.view(torch.bool)


octave0_ladder_mask.launches = 0


def octave0_ladder_mask_ref(img: torch.Tensor, pre_sigma: float, increments: Sequence[float],
                            mask_cfg: Tuple[float, float, int]) -> MaskedLadder:
    """Plain version of K1m: the plain ladder, then the stencil."""
    peak, eth, bd = mask_cfg
    blurs, dogs = octave0_ladder_ref(img, pre_sigma, increments)
    return blurs, dogs, stencil_mask(dogs, peak, eth, bd)


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
                         scales: int, ds_mode: str = "shrink",
                         mask_cfg: Optional[Tuple[float, Sequence[float], int]] = None):
    """Blur and DoG stacks of `n_oct` octaves from the first small octave's
    base (octave 0's level `scales`, downsampled): each octave's level 0 is
    its base, the next base is level `scales` shrunk or 2x2-binned.  With
    ``mask_cfg=(peak_thresh, eths, bd)`` (one edge threshold per octave),
    K2m: each octave's (blurs, dogs, mask) (``small_octaves_ladder_mask``)."""
    if mask_cfg is not None:
        return small_octaves_ladder_mask(base1, increments, n_oct, scales, ds_mode, mask_cfg)
    _check_small(base1, increments, n_oct, scales, ds_mode)
    if not on_cuda(base1):
        return small_octaves_ladder_ref(base1, increments, n_oct, scales, ds_mode)
    dev = base1.device
    n = len(increments)
    geo = _geometry(*base1.shape, n_oct)
    taps, offsets, sizes = _taps_table(tuple(map(float, increments)), dev)
    blurs, dogs = _allocate(geo, n, dev)
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


def _allocate(geo, n: int, dev):
    blurs = [torch.empty((n + 1, h, w), dtype=torch.float32, device=dev) for h, w in geo]
    dogs = [torch.empty((n, h, w), dtype=torch.float32, device=dev) for h, w in geo]
    return blurs, dogs


def small_octaves_ladder_mask(base1: torch.Tensor, increments: Sequence[float], n_oct: int,
                              scales: int, ds_mode: str,
                              mask_cfg: Tuple[float, Sequence[float], int]
                              ) -> List[MaskedLadder]:
    """K2m: ``small_octaves_ladder``'s stacks, bit-equal to K2's, and each
    octave's (len(increments) - 2, H - 2bd, W - 2bd) bool extrema mask at
    ``mask_cfg = (peak_thresh, eths, bd)``, octave o taking ``eths[o]``."""
    _check_small(base1, increments, n_oct, scales, ds_mode)
    n = len(increments)
    geo = _geometry(*base1.shape, n_oct)
    peak, eths, bd = _check_mask_cfg(mask_cfg, n, geo, n_oct)
    if not on_cuda(base1):
        return small_octaves_ladder_mask_ref(base1, increments, n_oct, scales, ds_mode, mask_cfg)
    dev = base1.device
    taps, offsets, sizes = _taps_table(tuple(map(float, increments)), dev)
    blurs, dogs = _allocate(geo, n, dev)
    masks = [torch.empty((n - 2, h - 2 * bd, w - 2 * bd), dtype=torch.uint8, device=dev)
             for h, w in geo]
    blurs[0][0].copy_(base1)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function("sift_small_octaves_ladder_mask",
                         [ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, vp, vp])
    bp = (vp * n_oct)(*[b.data_ptr() for b in blurs])
    dp = (vp * n_oct)(*[d.data_ptr() for d in dogs])
    mp = (vp * n_oct)(*[m.data_ptr() for m in masks])
    hs = (ci * n_oct)(*[h for h, _ in geo])
    ws = (ci * n_oct)(*[w for _, w in geo])
    ec = (cf * n_oct)(*map(float, eths))
    with torch.cuda.device(dev):
        err = fn(n_oct, bp, dp, mp, hs, ws, _build.ptr(taps), offsets, sizes, n, scales,
                 int(ds_mode == "bin"), bd, float(0.8 * peak), ec, _build.stream_of(base1))
    _build.check(err, "small_octaves_ladder_mask")
    small_octaves_ladder_mask.launches += 1
    return [(b, d, m.view(torch.bool)) for b, d, m in zip(blurs, dogs, masks)]


small_octaves_ladder_mask.launches = 0


def small_octaves_ladder_mask_ref(base1: torch.Tensor, increments: Sequence[float], n_oct: int,
                                  scales: int, ds_mode: str,
                                  mask_cfg: Tuple[float, Sequence[float], int]
                                  ) -> List[MaskedLadder]:
    """Plain version of K2m: the plain ladder, then the stencil per octave."""
    peak, eths, bd = mask_cfg
    return [(b, d, stencil_mask(d, peak, eth, bd)) for (b, d), eth in
            zip(small_octaves_ladder_ref(base1, increments, n_oct, scales, ds_mode), eths)]
