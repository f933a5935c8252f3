"""K1 and K2: the Gaussian blur ladders of the scale-space pyramid.

Port of ``sift_pyocl_tpu/ops/pallas/ladder0.py::octave0_ladder`` (K1) and
``sift_pyocl_tpu/ops/pallas/ladder.py::small_octaves_ladder`` (K2); the
kernels are ``csrc/ladder.cu``: K1 one launch per blur level, K2 one
cooperative launch for every small octave, walking the work list that
``small_octaves_schedule`` builds here (``schedule_table`` puts it on the
device).  Taps are
``oracle.gaussian_kernel``'s, uploaded once per (sigmas, device); every
level clamps to its own edges, as ``ops.pyramid.blur`` does.  The plain
versions are the plain pyramid's (``ops.pyramid.octave0_ladder_ref`` and
``small_octaves_ladder_ref``).

With ``mask_cfg`` (the TPU kernels' argument of that name, behind
``SiftConfig(mask_backend="fused")``) each octave also gets its extrema
mask from inside the ladder, as a third value: K1m ``octave0_ladder_mask``
(K1's launches, then K8's mask kernel on octave 0) and K2m
``small_octaves_ladder_mask`` (K2's one launch, whose work list also holds
a mask item an octave on K8's tiles), which count their launches apart
from K1's and K2's.  The JAX kernels return the mask with garbage borders;
these return it border-stripped, (scales, H - 2bd, W - 2bd) bool, as K8
and the plain stencil do, so ``mask_cfg`` carries ``bd`` as its third
entry.  Their plain versions are the plain ladder followed by the stencil
(``maskk.stencil_mask``) on its DoGs.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    _build.hold_for_graph(taps)
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
    _build.hold_for_graph(taps)
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


# K2's tiles: TW columns (a warp across) by one of TILE_HEIGHTS rows, TY
# warps a block (csrc/ladder.cu)
TW, TY = 32, 8
TILE_HEIGHTS = (64, 32, 16, 8)
# K2m's mask items run K8's tile body: MASK_TH x MASK_TW mask pixels a tile
# (csrc/extrema_tile.cuh)
MASK_TH, MASK_TW = 32, 64


class LadderItem(NamedTuple):
    """One blur pass of K2's work list: octave `octave`'s level + 1 from its
    `level`, over tiles [tile_start, tile_end) of its step (``tiles_x``
    across, ``th`` rows each), taps [tap_off, tap_off + K); ds 1 writes the
    next octave's base from the level written, 2 from the level read
    (scales == 0).  Octave 0's pass 0 reads base1 and writes it as level 0.
    With ``mask`` 1 (K2m), the octave's extrema mask over its whole DoG
    stack instead: ``level`` is the number of passes it follows (the DoG
    planes), tiles of MASK_TH x MASK_TW mask pixels (``tiles_x`` across the
    border-stripped width), no taps."""
    octave: int
    level: int
    H: int
    W: int
    th: int
    tiles_x: int
    tile_start: int
    tile_end: int
    tap_off: int
    K: int
    ds: int
    mask: int = 0


def _tile_height(h: int, w: int, half: int, n_blocks: int) -> int:
    """The tile height of an h x w octave that finishes a pass soonest on
    `n_blocks` blocks: fewest rounds of tiles a block times rows a warp
    sums (horizontal, th + 2 half rows; vertical, th rows), ties to the
    taller tile."""
    def cost(th: int) -> int:
        tiles = math.ceil(w / TW) * math.ceil(h / th)
        return math.ceil(tiles / n_blocks) * (math.ceil((th + 2 * half) / TY) + th // TY)

    return min(TILE_HEIGHTS, key=lambda th: (cost(th), -th))


def small_octaves_schedule(geo: Sequence[Tuple[int, int]], tap_sizes: Sequence[int],
                           scales: int, n_blocks: int,
                           mask_bd: Optional[int] = None) -> List[List[LadderItem]]:
    """K2's work list: steps of blur passes, each pass depending only on
    passes of earlier steps.  Octave o's pass l (level l+1 from level l)
    runs at step start(o) + l, where start(0) = 0 and octave o+1 starts one
    step after the pass that writes its base (level `scales` of octave o,
    or level 0 read by pass 0 when scales == 0), so octaves overlap.  With
    ``mask_bd`` (K2m's border), one more step after the last pass holds
    every octave's mask item.  (A step lasts as long as its slowest tile, and
    a mask tile outlasts a small octave's blur tile: each octave's item at
    the first step after its own last pass lengthened six steps, 0.202
    device ms against 0.182 on an H100 at 1080x1920's small octaves,
    ``tools/ab_fused_ladders.py``.)"""
    n_lv = len(tap_sizes)
    if n_lv < 1 or not 0 <= scales <= n_lv:
        raise ValueError(f"need >= 1 increment and 0 <= scales <= {n_lv}, got {scales}")
    offsets = np.cumsum([0] + list(tap_sizes[:-1])).tolist()
    half = max((k - 1) // 2 for k in tap_sizes)
    ds_pass = max(scales - 1, 0)
    steps: Dict[int, list] = {}
    start = 0
    for o, (h, w) in enumerate(geo):
        th = _tile_height(h, w, half, n_blocks)
        tiles_x, tiles = math.ceil(w / TW), math.ceil(w / TW) * math.ceil(h / th)
        for l in range(n_lv):
            ds = (2 if scales == 0 else 1) if o + 1 < len(geo) and l == ds_pass else 0
            steps.setdefault(start + l, []).append(
                (o, l, h, w, th, tiles_x, tiles, offsets[l], tap_sizes[l], ds, 0))
        start += ds_pass + 1
    if mask_bd is not None:
        last = len(steps)
        for o, (h, w) in enumerate(geo):
            mx = math.ceil((w - 2 * mask_bd) / MASK_TW)
            steps.setdefault(last, []).append(
                (o, n_lv, h, w, MASK_TH, mx, mx * math.ceil((h - 2 * mask_bd) / MASK_TH),
                 0, 0, 0, 1))
    out = []
    for s in range(len(steps)):
        items, t = [], 0
        for o, l, h, w, th, tiles_x, tiles, off, k, ds, mask in steps[s]:
            items.append(LadderItem(o, l, h, w, th, tiles_x, t, t + tiles, off, k, ds, mask))
            t += tiles
        out.append(items)
    return out


def schedule_table(steps: List[List[LadderItem]]) -> np.ndarray:
    """The int32 table ``csrc/ladder.cu``'s small_octaves_kernel reads: the
    number of steps, the first item of each step (one entry more), then
    each item's fields in ``LadderItem`` order."""
    firsts = np.cumsum([0] + [len(items) for items in steps]).tolist()
    flat = [f for items in steps for it in items for f in it]
    return np.asarray([len(steps)] + firsts + flat, dtype=np.int32)


@lru_cache(maxsize=32)
def _small_plan(geo: Tuple[Tuple[int, int], ...], increments: Tuple[float, ...], scales: int,
                device: torch.device, mask_bd: Optional[int] = None):
    """(device table, blocks, taps, tap count, largest half-width) of K2's
    launch for these octaves and sigmas on `device`; with ``mask_bd``,
    K2m's (the work list with its mask items, the grid for its shared
    memory)."""
    taps, _, sizes = _taps_table(increments, device)
    sizes = list(sizes)
    half = max((k - 1) // 2 for k in sizes)
    blocks = ctypes.c_int(0)
    ci = ctypes.c_int
    fn = _build.function("sift_small_octaves_ladder_grid", [ci, ci, ci, ctypes.c_void_p])
    n_dogs = 0 if mask_bd is None else len(sizes)
    with torch.cuda.device(device):
        _build.check(fn(sum(sizes), half, n_dogs, ctypes.byref(blocks)), "small_octaves_ladder")
    steps = small_octaves_schedule(geo, sizes, scales, blocks.value, mask_bd)
    table = torch.as_tensor(schedule_table(steps), device=device)
    return table, blocks.value, taps, sum(sizes), half


def _small_args(base1: torch.Tensor, increments: Sequence[float], n_oct: int, scales: int,
                ds_mode: str, mask_bd: Optional[int] = None):
    """What K2's and K2m's C entries share: the octave geometry, the plan,
    the allocated stacks and the leading ctypes arguments (n_oct, blur and
    DoG pointers, then base1, taps, tap count, half-width, table, bin).
    `base1` is contiguous, and the caller holds it until the launch."""
    dev = base1.device
    geo = _geometry(*base1.shape, n_oct)
    table, blocks, taps, n_taps, half = _small_plan(tuple(geo), tuple(map(float, increments)),
                                                    scales, dev, mask_bd)
    _build.hold_for_graph(table, taps)
    blurs, dogs = _allocate(geo, len(increments), dev)
    vp = ctypes.c_void_p
    lead = (n_oct, (vp * n_oct)(*[b.data_ptr() for b in blurs]),
            (vp * n_oct)(*[d.data_ptr() for d in dogs]))
    rest = (_build.ptr(base1), _build.ptr(taps), n_taps, half, _build.ptr(table),
            int(ds_mode == "bin"))
    return geo, blocks, blurs, dogs, lead, rest


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
    base1 = base1.contiguous()
    _, blocks, blurs, dogs, lead, rest = _small_args(base1, increments, n_oct, scales, ds_mode)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_small_octaves_ladder",
                         [ci, vp, vp, vp, vp, ci, ci, vp, ci, ci, vp])
    with torch.cuda.device(base1.device):
        err = fn(*lead, *rest, blocks, _build.stream_of(base1))
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
    base1 = base1.contiguous()
    geo, blocks, blurs, dogs, lead, rest = _small_args(base1, increments, n_oct, scales,
                                                       ds_mode, bd)
    masks = [torch.empty((n - 2, h - 2 * bd, w - 2 * bd), dtype=torch.uint8, device=dev)
             for h, w in geo]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function("sift_small_octaves_ladder_mask",
                         [ci, vp, vp, vp, vp, vp, ci, ci, vp, ci, ci, ci, cf, vp, ci, vp])
    mp = (vp * n_oct)(*[m.data_ptr() for m in masks])
    ec = (cf * n_oct)(*map(float, eths))
    with torch.cuda.device(dev):
        err = fn(*lead, mp, *rest, n, bd, float(0.8 * peak), ec, blocks, _build.stream_of(base1))
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
