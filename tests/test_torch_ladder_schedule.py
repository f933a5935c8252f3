"""K2's work list (``ops/kernels/ladder.py::small_octaves_schedule``), which
the one-launch small-octave kernel walks on the card: every (octave, level,
pixel) written exactly once, every next octave's base once, each pass after
the passes it reads, and the octave geometry that of ``_geometry`` and of
the plain ladder.  K2m's work list (``mask_bd``) adds one mask item an
octave, all in one step after the last pass: after every DoG pass its
planes read, every mask pixel once, one step more than K2's."""

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.oracle import gaussian_kernel
from sift_pyocl_tpu_torch.ops.kernels.ladder import (MASK_TH, MASK_TW, TILE_HEIGHTS, TW,
                                                     LadderItem, _geometry, schedule_table,
                                                     small_octaves_schedule)
from sift_pyocl_tpu_torch.ops.pyramid import small_octaves_ladder_ref
from _torch_threads import _one_torch_thread  # noqa: F401


def _sizes(scales: int):
    return [len(gaussian_kernel(s)) for s in SiftConfig(scales=scales).sigma_increments()]


@pytest.mark.parametrize("shape,n_oct,scales,n_blocks", [
    ((540, 960), 6, 3, 264), ((540, 960), 6, 3, 132), ((540, 960), 6, 2, 264),
    ((541, 963), 6, 3, 1), ((135, 241), 1, 3, 264), ((77, 131), 3, 0, 16),
    ((77, 131), 3, 5, 7), ((17, 30), 1, 2, 264)])
def test_schedule_covers_every_pixel_once(shape, n_oct, scales, n_blocks):
    sizes = _sizes(3 if scales in (0, 5) else scales)
    geo = _geometry(*shape, n_oct)
    steps = small_octaves_schedule(geo, sizes, scales, n_blocks)
    n_lv = len(sizes)
    written = {(o, l): np.zeros(hw, np.int32) for o, hw in enumerate(geo) for l in range(n_lv)}
    bases = {o: np.zeros(((h + 1) // 2, (w + 1) // 2), np.int32)
             for o, (h, w) in enumerate(geo[:-1])}
    ready = {(0, 0)}                    # levels readable at the start of a step
    offsets = np.cumsum([0] + sizes[:-1])
    seen = set()
    for items in steps:
        t = 0
        made = set()
        for it in items:
            o, l = it.octave, it.level
            assert (o, l) not in seen and (o, l) in ready, (o, l)
            seen.add((o, l))
            assert (it.H, it.W) == geo[o] and it.th in TILE_HEIGHTS
            assert (it.tap_off, it.K) == (offsets[l], sizes[l])
            assert it.tile_start == t and it.tiles_x == -(-it.W // TW)
            t = it.tile_end
            for lt in range(it.tile_end - it.tile_start):
                r0, c0 = (lt // it.tiles_x) * it.th, (lt % it.tiles_x) * TW
                assert r0 < it.H and c0 < it.W
                written[o, l][r0:r0 + it.th, c0:c0 + TW] += 1
                if it.ds:
                    bases[o][r0 // 2:(r0 + it.th) // 2, c0 // 2:(c0 + TW) // 2] += 1
            made.add((o, l + 1))
            if it.ds:
                assert o + 1 < len(geo) and it.ds == (2 if scales == 0 else 1)
                assert l == max(scales - 1, 0)
                made.add((o + 1, 0))
        ready |= made                   # what a step writes is read from the next step on
    assert seen == set(written)
    for key, cover in written.items():
        assert (cover == 1).all(), key
    for o, cover in bases.items():
        assert (cover == 1).all(), o


@pytest.mark.parametrize("n_blocks", [1, 264])
def test_schedule_table_layout(n_blocks):
    """The device table: step count, each step's first item, then the
    items' fields in LadderItem order."""
    steps = small_octaves_schedule(_geometry(540, 960, 6), _sizes(3), 3, n_blocks)
    table = schedule_table(steps)
    n = int(table[0])
    assert n == len(steps) == 3 * 5 + 5        # octaves overlap: 20 steps, not 30
    firsts = table[1:n + 2]
    items = table[n + 2:].reshape(-1, len(LadderItem._fields))
    assert firsts[0] == 0 and firsts[-1] == len(items)
    for s, step in enumerate(steps):
        got = [LadderItem(*map(int, row)) for row in items[firsts[s]:firsts[s + 1]]]
        assert got == step


@pytest.mark.parametrize("shape,n_oct", [((55, 97), 6), ((20, 33), 3)])
def test_geometry_is_the_plain_ladders(shape, n_oct):
    """_geometry (the kernel's octave shapes) is the ceil-halved geometry of
    the plain ladder, which the parity tests hold to the JAX package."""
    cfg = SiftConfig()
    plain = small_octaves_ladder_ref(torch.rand(shape), cfg.sigma_increments(), n_oct,
                                     cfg.scales)
    geo = _geometry(*shape, n_oct)
    assert geo == [tuple(b.shape[1:]) for b, _ in plain]
    h, w = shape
    for got in geo:
        assert got == (h, w)
        h, w = -(-h // 2), -(-w // 2)


def _from_table(table: np.ndarray):
    n = int(table[0])
    firsts = table[1:n + 2]
    items = table[n + 2:].reshape(-1, len(LadderItem._fields))
    return [[LadderItem(*map(int, row)) for row in items[firsts[s]:firsts[s + 1]]]
            for s in range(n)]


@pytest.mark.parametrize("shape,n_oct,scales,bd,n_blocks", [
    ((540, 960), 6, 3, 5, 264), ((541, 963), 6, 1, 5, 264), ((541, 963), 6, 2, 1, 132),
    ((540, 960), 6, 4, 5, 264), ((135, 241), 1, 3, 5, 264), ((77, 131), 3, 4, 5, 7),
    ((77, 131), 3, 2, 3, 1), ((23, 40), 2, 3, 5, 264), ((64, 129), 2, 1, 2, 16)])
def test_mask_items_follow_their_dogs_and_cover_every_mask_pixel_once(shape, n_oct, scales, bd,
                                                                      n_blocks):
    """K2m's work list: one mask item an octave, at a step after the three
    DoG passes of each of its planes (all in the step after the last
    pass), its MASK_TH x MASK_TW tiles covering every pixel of the
    border-stripped mask exactly once; K2's blur passes unchanged, at most
    one step more; the device table round-trips."""
    sizes = _sizes(scales)
    n_lv = len(sizes)
    geo = _geometry(*shape, n_oct)
    plain = small_octaves_schedule(geo, sizes, scales, n_blocks)
    steps = small_octaves_schedule(geo, sizes, scales, n_blocks, mask_bd=bd)
    assert len(plain) <= len(steps) <= len(plain) + 1

    for s, items in enumerate(steps):
        want = plain[s] if s < len(plain) else []
        assert [it for it in items if not it.mask] == want, s
        t = 0
        for it in items:                # the step's tile ranges follow one another
            assert it.tile_start == t and it.tile_end > t
            t = it.tile_end
    pass_step = {(it.octave, it.level): s for s, items in enumerate(steps)
                 for it in items if not it.mask}
    masks = [(s, it) for s, items in enumerate(steps) for it in items if it.mask]
    assert sorted(it.octave for _, it in masks) == list(range(n_oct))
    for s, it in masks:
        o = it.octave
        h, w = geo[o]
        hm, wm = h - 2 * bd, w - 2 * bd
        for p in range(n_lv - 2):       # mask plane p reads DoGs p, p + 1, p + 2
            assert all(pass_step[o, l] < s for l in (p, p + 1, p + 2)), (o, p)
        assert s == len(steps) - 1
        assert (it.level, it.H, it.W, it.th) == (n_lv, h, w, MASK_TH)
        assert (it.tap_off, it.K, it.ds) == (0, 0, 0)
        assert it.tiles_x == -(-wm // MASK_TW)
        cover = np.zeros((hm, wm), np.int32)
        for lt in range(it.tile_end - it.tile_start):
            i0, j0 = (lt // it.tiles_x) * MASK_TH, (lt % it.tiles_x) * MASK_TW
            assert i0 < hm and j0 < wm
            cover[i0:i0 + MASK_TH, j0:j0 + MASK_TW] += 1
        assert (cover == 1).all(), o
    assert _from_table(schedule_table(steps)) == steps


def test_mask_items_add_one_step_at_the_default_config():
    """1080x1920's small octaves (540x960 down to 17x30) at the default
    config: 20 steps for K2, 21 for K2m, the last one every octave's mask
    item (349 tiles) and nothing else."""
    cfg = SiftConfig()
    geo = _geometry(540, 960, 6)
    steps = small_octaves_schedule(geo, _sizes(3), 3, 264, mask_bd=cfg.border_dist)
    assert len(steps) == 21
    assert [(it.octave, it.mask) for it in steps[-1]] == [(o, 1) for o in range(6)]
    assert steps[-1][-1].tile_end == 255 + 72 + 16 + 4 + 1 + 1
    assert not any(it.mask for items in steps[:-1] for it in items)
