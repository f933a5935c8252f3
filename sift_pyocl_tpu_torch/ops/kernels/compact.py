"""K3: multi-octave stream compaction of extrema masks.

Port of ``sift_pyocl_tpu/ops/pallas/compact.py::compact_masks_multi``; the
kernel is ``csrc/compact.cu``.  Octave o's set mask elements come out as
flat row-major indices in exactly ``np.nonzero`` order, at most
``MAX_PER_TILE`` per ``TILE``-element tile (the rest are dropped but still
counted in ``total``), cut at ``caps[o]``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import _build, on_cuda

TILE = 64 * 512
MAX_PER_TILE = 128


def _check_masks(masks: Sequence[torch.Tensor], caps: Sequence[int]) -> None:
    if len(masks) != len(caps) or not masks:
        raise ValueError("need one capacity per mask and at least one mask")
    dev = masks[0].device
    for m in masks:
        if m.device != dev:
            raise ValueError("all masks must lie on one device")
        if m.dtype not in (torch.bool, torch.uint8, torch.int8):
            raise TypeError(f"mask dtype {m.dtype}: expected bool or 8-bit ints")


def compact_masks_multi(masks: Sequence[torch.Tensor], caps: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact every octave's mask (any shapes, flattened row-major).

    Returns (idx (sum(caps),) int32 -- octave o's indices at
    [sum(caps[:o]), sum(caps[:o]) + written[o]), zeros after --,
    written (n_oct,) int32, total (n_oct,) int32)."""
    _check_masks(masks, caps)
    if not on_cuda(masks[0]):
        return compact_masks_multi_ref(masks, caps)
    dev = masks[0].device
    flats: List[torch.Tensor] = []
    for m in masks:
        f = (m != 0).view(torch.uint8).reshape(-1).contiguous()
        if f.data_ptr() % 16:
            f = f.clone()
        flats.append(f)
    n_oct = len(flats)
    n_tiles = sum((f.numel() + TILE - 1) // TILE for f in flats)
    idx = torch.zeros(int(sum(caps)), dtype=torch.int32, device=dev)
    written = torch.empty(n_oct, dtype=torch.int32, device=dev)
    total = torch.empty(n_oct, dtype=torch.int32, device=dev)
    tile_cnt = torch.empty(max(n_tiles, 1), dtype=torch.int32, device=dev)
    tile_off = torch.empty_like(tile_cnt)
    vp = ctypes.c_void_p
    fn = _build.function("sift_compact_masks_multi",
                         [ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp, vp])
    ptrs = (vp * n_oct)(*[f.data_ptr() for f in flats])
    lens = (ctypes.c_longlong * n_oct)(*[f.numel() for f in flats])
    caps_c = (ctypes.c_int * n_oct)(*[int(c) for c in caps])
    with torch.cuda.device(dev):
        err = fn(n_oct, ptrs, lens, caps_c, _build.ptr(idx), _build.ptr(written),
                 _build.ptr(total), _build.ptr(tile_cnt), _build.ptr(tile_off),
                 _build.stream_of(idx))
    _build.check(err, "compact_masks_multi")
    compact_masks_multi.launches += 1
    return idx, written, total


compact_masks_multi.launches = 0


def compact_masks_multi_ref(masks: Sequence[torch.Tensor], caps: Sequence[int]
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``compact_masks_multi`` (same outputs)."""
    _check_masks(masks, caps)
    dev = masks[0].device
    idx_l, wr_l, tot_l = [], [], []
    for m, cap in zip(masks, caps):
        f = (m != 0).reshape(-1)
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
        idx_l.append(out)
        wr_l.append(kept.sum().clamp(max=int(cap)))
        tot_l.append(cnt.sum())
    return (torch.cat(idx_l), torch.stack(wr_l).to(torch.int32),
            torch.stack(tot_l).to(torch.int32))
