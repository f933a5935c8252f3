"""K7's and K7f's column splits on the CPU: ``matchk.best2_split_merge``
(each split's best-2, merged in ascending split order by the kernels'
rule) equals ``best2_l2_ref`` bit for bit on random u8 descriptors, with
the minimum tied inside one split and across two splits, an all-invalid
split, every column invalid, and N2 not a multiple of the split width.
For f32 operands (K7f's), at K7f's split width and at one that leaves a
short last split, it is held to the JAX package's ``best2_l2_pallas`` in
interpret mode on the same inputs, and equals ``best2_l2_ref`` bit for bit
on integer-valued f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.ops.pallas.matchk import best2_l2_pallas

from sift_pyocl_tpu_torch.ops.kernels import matchk
from _torch_threads import _one_torch_thread  # noqa: F401

N1 = 300


def _data(n2: int, seed: int, p_valid: float = 0.8):
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 256, (N1, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (n2, 128), dtype=np.uint8)
    v2 = rng.uniform(size=n2) < p_valid
    return d1, d2, v2


def _check(d1, d2, v2, n_splits: int):
    a, b, v = torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(v2)
    want = matchk.best2_l2_ref(a, b, v)
    got = matchk.best2_split_merge(a, b, v, n_splits)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return want


@pytest.mark.parametrize("n2,n_splits", [(512, 2), (600, 3), (1000, 8), (257, 2), (97, 5),
                                         (64, 64)])
def test_random_descriptors(n2, n_splits):
    _check(*_data(n2, n2 + n_splits), n_splits)


def test_min_tied_inside_one_split():
    d1, d2, v2 = _data(600, 1)
    d2[[10, 40]] = d1[0]          # both in split 0 of 3 (200 columns each)
    v2[[10, 40]] = True
    d1_, d2_, i1 = _check(d1, d2, v2, 3)
    assert int(i1[0]) == 10 and float(d1_[0]) == float(d2_[0]) == 0.0


def test_min_tied_across_two_splits():
    d1, d2, v2 = _data(600, 2)
    d2[[450, 150, 350]] = d1[1]    # splits 2, 0 and 1
    v2[[150, 350, 450]] = True
    d1_, d2_, i1 = _check(d1, d2, v2, 3)
    assert int(i1[1]) == 150 and float(d1_[1]) == float(d2_[1]) == 0.0
    # and the kernel's own split width (SPLIT_COLS) on the same columns
    _check(d1, d2, v2, -(-600 // matchk.SPLIT_COLS))


def test_an_all_invalid_split():
    d1, d2, v2 = _data(600, 3)
    v2[200:400] = False
    d2[300] = d1[2]               # an exact match in the invalid split
    _, _, i1 = _check(d1, d2, v2, 3)
    assert int(i1[2]) != 300


def test_every_column_invalid():
    d1, d2, v2 = _data(600, 4)
    d1_, d2_, i1 = _check(d1, d2, np.zeros_like(v2), 3)
    assert bool(torch.isinf(d1_).all()) and bool(torch.isinf(d2_).all())
    assert not bool(i1.any())


def test_one_valid_column_in_the_last_short_split():
    d1, d2, v2 = _data(601, 5)
    v2[:] = False
    v2[600] = True                # the last split holds one column
    d1_, d2_, i1 = _check(d1, d2, v2, 3)
    assert bool((i1 == 600).all()) and bool(torch.isinf(d2_).all())


def test_merge_rule_gives_the_lowest_column_in_any_order():
    """The rule itself: merging the splits in any order gives the same
    state, so the kernel's result does not depend on block order."""
    d1, d2, v2 = _data(600, 6)
    d2[[100, 300, 500]] = d1[3]
    v2[[100, 300, 500]] = True
    a, b, v = torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(v2)
    parts = []
    for c0 in range(0, 600, 200):
        p = matchk.best2_l2_ref(a, b[c0:c0 + 200], v[c0:c0 + 200])
        parts.append((p[0], p[1], p[2] + c0))
    want = matchk.best2_l2_ref(a, b, v)
    for order in ((0, 1, 2), (2, 1, 0), (1, 2, 0)):
        out = parts[order[0]]
        for k in order[1:]:
            out = matchk._merge(out, parts[k])
        for g, w in zip(out, want):
            assert torch.equal(g, w)


# (N2, n_splits): K7f's split width with full splits, the same width with
# a short last split (128, 128, 126), and another width with a short last
# split (86, 86, 85)
F32_SPLITS = [(3 * matchk.SPLIT_COLS, 3), (3 * matchk.SPLIT_COLS - 2, 3), (257, 3)]


def _f32_data(n2: int, seed: int):
    """u8 descriptors with the minimum tied inside one split (row 0:
    columns 3 and 5) and across two (row 1: columns 150 and 40 + the last
    split's first column), and a near-duplicate row (row 2)."""
    d1, d2, v2 = _data(n2, seed)
    last = (-(-n2 // 3)) * 2
    d2[5] = d2[3]
    d1[0] = d2[3]
    d2[150] = d2[last + 40] = d1[1]
    d1[2] = d2[10]
    d1[2, 0] ^= 1
    v2[[3, 5, 10, 150, last + 40]] = True
    return d1, d2, v2


@pytest.mark.parametrize("n2,n_splits", F32_SPLITS)
def test_f32_splits_match_jax(n2, n_splits):
    """K7f's merge on f32 values whose sums round (u8 over 255) against
    best2_l2_pallas in interpret mode: d1/d2 within 1e-5 of |a|^2 + max
    |b|^2 (the two sum the dot products in other orders; as
    tests/test_torch_fused_mask.py::test_best2_f32_operands_match_jax), i1
    equal except where the two best distances are that close."""
    d1, d2, v2 = _f32_data(n2, n2 + 11)
    a, b = d1.astype(np.float32) / 255.0, d2.astype(np.float32) / 255.0
    p1, p2, pi = (np.asarray(x) for x in best2_l2_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(v2), interpret=True))
    g1, g2, gi = (x.numpy() for x in matchk.best2_split_merge(
        *(torch.from_numpy(x) for x in (a, b, v2)), n_splits))
    mag = (a * a).sum(1) + (b[v2] * b[v2]).sum(1).max()
    assert np.all(np.abs(g1 - p1) <= 1e-5 * mag)
    assert np.all(np.abs(np.where(np.isinf(g2), 1e30, g2) - np.where(np.isinf(p2), 1e30, p2))
                  <= 1e-5 * mag)
    near = (p2 - p1) <= 1e-5 * mag
    assert not np.any((gi != pi) & ~near)
    # the planted ties: equal columns give equal distances, the lowest wins
    assert gi[0] == 3 and g1[0] == g2[0] and gi[1] == 150 and g1[1] == g2[1]


@pytest.mark.parametrize("n2,n_splits", F32_SPLITS)
def test_f32_splits_exact_on_integer_values(n2, n_splits):
    """On integer-valued f32 (and the same integers over 512) every sum is
    exact, so the merged splits equal best2_l2_ref bit for bit, ties
    included."""
    d1, d2, v2 = _f32_data(n2, n2 + 12)
    for scale in (1.0, 512.0):
        a, b = d1.astype(np.float32) / scale, d2.astype(np.float32) / scale
        want = _check(a, b, v2, n_splits)
        assert int(want[2][0]) == 3 and int(want[2][1]) == 150
