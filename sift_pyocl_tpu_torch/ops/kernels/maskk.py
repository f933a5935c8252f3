"""K8: the DoG extrema masks of every octave in one launch.

Port of ``sift_pyocl_tpu/ops/pallas/maskk.py::extrema_masks_atlas_pallas``;
the kernel is ``csrc/maskk.cu``.  The TPU kernel reads a padded DoG atlas
and its caller strips each octave's border window out of the atlas mask;
the kernel here reads each octave's own DoG stack and writes the
border-stripped masks straight into one allocation, each octave's part
16-byte aligned, which K3 (``compact.py``) takes as it is.  Each entry (an
octave of one frame) takes the edge threshold of its octave number
(``oct_ids``), so a batch's entries, frame after frame, are one launch.

The plain version is the stencil of ``sift_pyocl_tpu/ops/detect.py``
(``extrema_mask``, at explicit thresholds ``stencil_mask``), which
``mask_backend="xla"`` runs on any device, and which the in-ladder masks of
K1/K2 (``ladder.py``) equal bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import _build, on_cuda
from ...config import SiftConfig


def octave_edge_thresh(cfg: SiftConfig, octave: int) -> float:
    """Edge threshold by the octsize <= 1 rule (oracle.local_maxmin):
    edge_thresh1 for octave 0, and for octave 1 too when double_im_size."""
    octsize = 2.0 ** (octave - 1) if cfg.double_im_size else 2.0 ** octave
    return cfg.edge_thresh1 if octsize <= 1.0 else cfg.edge_thresh


def extrema_mask(dogs: torch.Tensor, cfg: SiftConfig, octave: int) -> torch.Tensor:
    """Bool mask (scales, H-2bd, W-2bd) of extrema candidates: strict
    26-neighbour max or min, |v| > 0.8 peak_thresh, 2x2 spatial-Hessian edge
    test, border excluded (the "stencil" semantics of the JAX package)."""
    return stencil_mask(dogs, cfg.peak_thresh, octave_edge_thresh(cfg, octave),
                        cfg.border_dist)


def stencil_mask(dogs: torch.Tensor, peak_thresh: float, eth: float, bd: int) -> torch.Tensor:
    """The plain stencil of ``extrema_mask`` at explicit thresholds (the
    mask_cfg form of the ladder kernels' plain versions).  Counts its calls
    in ``stencil_mask.calls``, so that a run can show it never ran."""
    stencil_mask.calls += 1
    S, H, W = dogs.shape
    v = dogs[1 : S - 1, bd : H - bd, bd : W - bd]
    strong = v.abs() > 0.8 * peak_thresh
    is_max = torch.ones_like(strong)
    is_min = torch.ones_like(strong)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if ds == 0 and dr == 0 and dc == 0:
                    continue
                nb = dogs[1 + ds : S - 1 + ds, bd + dr : H - bd + dr, bd + dc : W - bd + dc]
                is_max &= v > nb
                is_min &= v < nb
    cand = strong & (is_max | is_min)
    d = dogs[1 : S - 1]
    ctr = d[:, bd : H - bd, bd : W - bd]
    hxx = d[:, bd : H - bd, bd - 1 : W - bd - 1] + d[:, bd : H - bd, bd + 1 : W - bd + 1] - 2 * ctr
    hyy = d[:, bd - 1 : H - bd - 1, bd : W - bd] + d[:, bd + 1 : H - bd + 1, bd : W - bd] - 2 * ctr
    hxy = 0.25 * (
        d[:, bd + 1 : H - bd + 1, bd + 1 : W - bd + 1]
        - d[:, bd + 1 : H - bd + 1, bd - 1 : W - bd - 1]
        - d[:, bd - 1 : H - bd - 1, bd + 1 : W - bd + 1]
        + d[:, bd - 1 : H - bd - 1, bd - 1 : W - bd - 1]
    )
    det = hxx * hyy - hxy * hxy
    tr = hxx + hyy
    not_edge = (det > 0) & (det >= eth * tr * tr)
    return cand & not_edge


stencil_mask.calls = 0


def _check(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig) -> None:
    bd = cfg.border_dist
    if not octave_dogs or bd < 1:
        raise ValueError("need at least one DoG stack and border_dist >= 1")
    for d in octave_dogs:
        if d.dtype != torch.float32 or d.ndim != 3 or d.shape[0] < 3:
            raise ValueError("DoG stacks must be (S+2, H, W) float32")
        if d.shape[1] <= 2 * bd or d.shape[2] <= 2 * bd:
            raise ValueError(f"DoG plane {tuple(d.shape[1:])} has no pixel inside the border")
        if d.device != octave_dogs[0].device or d.shape[0] != octave_dogs[0].shape[0]:
            raise ValueError("DoG stacks must lie on one device with one plane count")


class _Chunk(NamedTuple):
    """One launch's ctypes arguments: octaves [a, b) of the call."""
    a: int
    b: int
    hs: ctypes.Array
    ws: ctypes.Array
    eths: ctypes.Array
    outoff: ctypes.Array
    ptrs: ctypes.Array          # refilled with the DoG pointers at each call


class _Layout(NamedTuple):
    """What a K8 call needs apart from the DoG pointers, for one set of
    octave shapes, octave numbers and thresholds: each launch's ctypes
    arguments (one launch for at most ``_build.MAX_ENTRIES`` octaves) and
    the masks' places in the output."""
    chunks: List[_Chunk]
    offs: List[int]
    sizes: List[int]
    shapes: List[Tuple[int, int, int]]
    n_bytes: int


_layouts: Dict[tuple, _Layout] = {}


def _oct_ids(n: int, oct_ids: Optional[Sequence[int]]) -> List[int]:
    """Each entry's octave number: `oct_ids`, or 0..n-1 (one frame's octaves
    in order) where None."""
    if oct_ids is None:
        return list(range(n))
    if len(oct_ids) != n:
        raise ValueError(f"need one octave number per DoG stack: {len(oct_ids)} for {n}")
    return [int(o) for o in oct_ids]


def _layout(dogs: Sequence[torch.Tensor], cfg: SiftConfig, oct_ids: List[int]) -> _Layout:
    """The cached layout for these DoG shapes, octave numbers and `cfg`
    (built once)."""
    bd = cfg.border_dist
    key = (tuple(tuple(d.shape) for d in dogs), tuple(oct_ids), bd, cfg.peak_thresh,
           cfg.edge_thresh, cfg.edge_thresh1, cfg.double_im_size)
    lay = _layouts.get(key)
    if lay is None:
        shapes = [(d.shape[0] - 2, d.shape[1] - 2 * bd, d.shape[2] - 2 * bd) for d in dogs]
        sizes = [s * h * w for s, h, w in shapes]
        offs, n = [], 0
        for size in sizes:
            offs.append(n)
            n += (size + 15) // 16 * 16
        ci = ctypes.c_int
        chunks = []
        for a, b in _build.entry_chunks(len(dogs)):
            k = b - a
            chunks.append(_Chunk(
                a=a, b=b, hs=(ci * k)(*[d.shape[1] for d in dogs[a:b]]),
                ws=(ci * k)(*[d.shape[2] for d in dogs[a:b]]),
                eths=(ctypes.c_float * k)(*[octave_edge_thresh(cfg, o) for o in oct_ids[a:b]]),
                outoff=(ctypes.c_longlong * k)(*offs[a:b]), ptrs=(ctypes.c_void_p * k)()))
        lay = _Layout(chunks=chunks, offs=offs, sizes=sizes, shapes=shapes, n_bytes=n)
        _layouts[key] = lay
    return lay


def extrema_masks(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig,
                  oct_ids: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Every octave's extrema mask in one launch (one for at most
    ``_build.MAX_ENTRIES`` octaves: a batch's longer list is split,
    ``_build.entry_chunks``): entry i's (S-2, H-2bd, W-2bd) bool mask,
    equal to ``extrema_mask(octave_dogs[i], cfg, oct_ids[i])``; `oct_ids`
    (each entry's octave number, which sets its edge threshold) defaults to
    0..n-1.  On the card the masks are views of one uint8 0/1 allocation; a
    warm call (shapes, octave numbers and cfg seen before) builds no ctypes
    array."""
    _check(octave_dogs, cfg)
    ids = _oct_ids(len(octave_dogs), oct_ids)
    if not on_cuda(octave_dogs[0]):
        return extrema_masks_ref(octave_dogs, cfg, ids)
    dogs = [d.contiguous() for d in octave_dogs]
    dev = dogs[0].device
    lay = _layout(dogs, cfg, ids)
    out = torch.empty(lay.n_bytes, dtype=torch.uint8, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_extrema_masks",
                         [ci, vp, vp, vp, vp, vp, ci, ci, ctypes.c_float, vp, vp])
    with torch.cuda.device(dev):
        for ch in lay.chunks:
            for o, d in enumerate(dogs[ch.a:ch.b]):
                ch.ptrs[o] = d.data_ptr()
            err = fn(ch.b - ch.a, ch.ptrs, ch.hs, ch.ws, ch.eths, ch.outoff,
                     int(dogs[0].shape[0]), int(cfg.border_dist), float(0.8 * cfg.peak_thresh),
                     _build.ptr(out), _build.stream_of(out))
            _build.check(err, "extrema_masks")
    extrema_masks.launches += len(lay.chunks)
    flat = out.view(torch.bool)
    return [flat[off:off + size].view(shape)
            for off, size, shape in zip(lay.offs, lay.sizes, lay.shapes)]


extrema_masks.launches = 0


def extrema_masks_ref(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig,
                      oct_ids: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Plain PyTorch version of ``extrema_masks``: the stencil per entry, at
    its octave number's edge threshold."""
    _check(octave_dogs, cfg)
    ids = _oct_ids(len(octave_dogs), oct_ids)
    return [extrema_mask(d, cfg, o) for o, d in zip(ids, octave_dogs)]
