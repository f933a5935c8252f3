"""K2's work list (``ops/kernels/ladder.py::small_octaves_schedule``), which
the one-launch small-octave kernel walks on the card: every (octave, level,
pixel) written exactly once, every next octave's base once, each pass after
the passes it reads, and the octave geometry that of ``_geometry`` and of
the plain ladder."""

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.oracle import gaussian_kernel
from sift_pyocl_tpu_torch.ops.kernels.ladder import (TILE_HEIGHTS, TW, LadderItem, _geometry,
                                                     schedule_table, small_octaves_schedule)
from sift_pyocl_tpu_torch.ops.pyramid import small_octaves_ladder_ref


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
