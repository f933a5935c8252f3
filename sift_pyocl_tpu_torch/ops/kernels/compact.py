"""K3 and K10a: stream compaction of extrema masks.

Port of ``sift_pyocl_tpu/ops/pallas/compact.py``: ``compact_masks_multi``
(K3, every octave in one launch) and ``compact_mask_pallas`` (K10a, one
mask, here ``compact_mask``); both are one launch of ``csrc/compact.cu``'s
single-pass kernel.  Octave o's set mask elements come out as flat
row-major indices in exactly ``np.nonzero`` order, at most
``MAX_PER_TILE`` per ``TILE``-element tile (the rest are dropped but still
counted in ``total``), cut at ``caps[o]``.  K3's ``extract_mode`` ("sum" or
"rowmm") chooses how the TPU kernel pulls a tile's indices out of VMEM;
both give this one result, which the port's kernel computes for either.

The kernel keeps a ticket, an epoch and one status word per tile in a
scratch buffer per (device, stream), zeroed once at its first call there
and left ready for the next call by the kernel itself, so a call clears
nothing.  The calls on one stream (and the CUDA graphs captured on it)
share that buffer and must not run concurrently.  A capture needs one call
on the capturing stream before it, as any warm-up does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from .. import _build, on_cuda

TILE = 64 * 512
MAX_PER_TILE = 128

_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _check_masks(masks: Sequence[torch.Tensor], caps: Sequence[int]) -> None:
    if len(masks) != len(caps) or not masks:
        raise ValueError("need one capacity per mask and at least one mask")
    dev = masks[0].device
    for m in masks:
        if m.device != dev:
            raise ValueError("all masks must lie on one device")
        if m.dtype not in (torch.bool, torch.uint8, torch.int8):
            raise TypeError(f"mask dtype {m.dtype}: expected bool or 8-bit ints")


def _scratch_of(dev: torch.device, stream: int) -> torch.Tensor:
    """The kernel's scratch for `stream` on `dev`: zeroed at its first use
    and kept (``csrc/compact.cu`` leaves it ready for the next call)."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("compaction: call it once on this stream before capturing a "
                               "CUDA graph (its scratch is made and zeroed at the first call)")
        words = _build.function("sift_compact_scratch_words", [])()
        buf = torch.zeros(words, dtype=torch.int64, device=dev)
        _scratch[key] = buf
    _build.hold_for_graph(buf)
    return buf


def _launch(masks: Sequence[torch.Tensor], caps: Sequence[int]
            ) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], int]:
    """The launches of ``csrc/compact.cu`` over `masks` (the work of K3 and
    K10a): one over every mask, or one for each ``_build.entry_chunks`` part
    of a longer list, each into its own slots of the one output.  Returns
    ((idx, written, total), the number of launches)."""
    dev = masks[0].device
    flats: List[torch.Tensor] = []
    for m in masks:
        # bool, uint8 and int8 are bytes, and the kernel counts nonzero bytes
        f = m if m.is_contiguous() else m.contiguous()
        if f.data_ptr() % 16:
            f = f.clone()
        flats.append(f)
    n_oct = len(flats)
    chunks = _build.entry_chunks(n_oct)
    tiles = [(f.numel() + TILE - 1) // TILE for f in flats]
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch_of(dev, stream)
    max_tiles = (scratch.numel() - 1) // 3       # one flag and two prefix words a tile
    n_tiles = max(sum(tiles[a:b]) for a, b in chunks)
    if n_tiles > max_tiles or any(c < 0 for c in caps):
        raise ValueError(f"compaction takes at most {max_tiles} tiles of {TILE} elements a "
                         f"launch and caps >= 0; got {n_tiles} tiles, caps {list(caps)}")
    idx = torch.empty(int(sum(caps)), dtype=torch.int32, device=dev)
    written = torch.empty(n_oct, dtype=torch.int32, device=dev)
    total = torch.empty(n_oct, dtype=torch.int32, device=dev)
    vp = ctypes.c_void_p
    fn = _build.function("sift_compact_masks_multi",
                         [ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp])
    slot0 = 0
    with torch.cuda.device(dev):
        for a, b in chunks:
            n = b - a
            ptrs = (vp * n)(*[f.data_ptr() for f in flats[a:b]])
            lens = (ctypes.c_longlong * n)(*[f.numel() for f in flats[a:b]])
            caps_c = (ctypes.c_int * n)(*[int(c) for c in caps[a:b]])
            err = fn(n, ptrs, lens, caps_c, idx.data_ptr() + 4 * slot0,
                     written.data_ptr() + 4 * a, total.data_ptr() + 4 * a, scratch.data_ptr(),
                     stream)
            _build.check(err, "compact")
            slot0 += int(sum(caps[a:b]))
    return (idx, written, total), len(chunks)


EXTRACT_MODES = ("sum", "rowmm")


def compact_masks_multi(masks: Sequence[torch.Tensor], caps: Sequence[int],
                        extract_mode: str = "sum"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: compact every octave's mask (any shapes, flattened row-major),
    one launch for at most ``_build.MAX_ENTRIES`` masks (a batch's longer
    list is split, ``_build.entry_chunks``).  ``extract_mode`` takes the TPU
    kernel's values, each the same function.

    Returns (idx (sum(caps),) int32 -- octave o's indices at
    [sum(caps[:o]), sum(caps[:o]) + written[o]), zeros after --,
    written (n_oct,) int32, total (n_oct,) int32)."""
    if extract_mode not in EXTRACT_MODES:
        raise ValueError(f"extract_mode must be one of {EXTRACT_MODES}, got {extract_mode!r}")
    _check_masks(masks, caps)
    if not on_cuda(masks[0]):
        return compact_masks_multi_ref(masks, caps)
    out, launches = _launch(masks, caps)
    compact_masks_multi.launches += launches
    return out


compact_masks_multi.launches = 0


def compact_masks_multi_ref(masks: Sequence[torch.Tensor], caps: Sequence[int]
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``compact_masks_multi`` (same outputs)."""
    _check_masks(masks, caps)
    parts = [compact_mask_ref(m, cap) for m, cap in zip(masks, caps)]
    idx, written, total = zip(*parts)
    return torch.cat(idx), torch.stack(written), torch.stack(total)


def compact_mask(mask: torch.Tensor, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10a, port of ``sift_pyocl_tpu/ops/pallas/compact.py::compact_mask_pallas``:
    one mask's set elements in ``np.nonzero`` order, under the same tile
    rule as K3 (a single-mask launch of its kernels).

    Returns (idx (cap,) int32, zeros after `written`; written () int32;
    total () int32)."""
    _check_masks([mask], [cap])
    if not on_cuda(mask):
        return compact_mask_ref(mask, cap)
    (idx, written, total), launches = _launch([mask], [cap])
    compact_mask.launches += launches
    return idx, written[0], total[0]


compact_mask.launches = 0


def compact_mask_ref(mask: torch.Tensor, cap: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``compact_mask`` (same outputs)."""
    _check_masks([mask], [cap])
    dev = mask.device
    f = (mask != 0).reshape(-1)
    nt = (f.numel() + TILE - 1) // TILE
    tiles = torch.zeros(nt * TILE, dtype=torch.bool, device=dev)
    tiles[: f.numel()] = f
    tiles = tiles.view(nt, TILE)
    cnt = tiles.sum(1)
    rank = tiles.cumsum(1) - 1                    # in-tile rank of each bit
    kept = cnt.clamp(max=MAX_PER_TILE)
    slot = (kept.cumsum(0) - kept)[:, None] + rank
    take = tiles & (rank < MAX_PER_TILE) & (slot < cap)
    pos = torch.nonzero(take.reshape(-1)).squeeze(1)
    out = torch.zeros(int(cap), dtype=torch.int32, device=dev)
    out[slot.reshape(-1)[pos]] = pos.to(torch.int32)
    return (out, kept.sum().clamp(max=int(cap)).to(torch.int32),
            cnt.sum().to(torch.int32))
