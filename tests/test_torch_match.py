"""K7 and ratio-test matching: the port's best-2 and matchers against the
JAX package's (``_best2_l2``, ``best2_l2_pallas`` in interpret mode,
``match_descriptors_dense``, ``match_descriptors_jax``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.ops import match as jm
from sift_pyocl_tpu.ops.pallas.matchk import best2_l2_pallas

from sift_pyocl_tpu_torch.ops import match as tm
from sift_pyocl_tpu_torch.ops.kernels import matchk
from _torch_threads import _one_torch_thread  # noqa: F401


def _problem(n1, n2, seed, frac1=0.7, frac2=0.8):
    """u8 descriptors with planted ties: row 0 is column 3 and column 5
    equals column 3 (a tie at the minimum, d2 == d1); row 1's best sits in
    the last two columns (equal); a few rows are near-duplicates."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 256, (n1, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (n2, 128), dtype=np.uint8)
    d2[5] = d2[3]
    d1[0] = d2[3]
    d2[n2 - 1] = d2[n2 - 2] = d1[1]
    d1[2:6] = d2[10:14]
    d1[2:6, 0] ^= 1
    v1 = rng.uniform(size=n1) < frac1
    v2 = rng.uniform(size=n2) < frac2
    v1[:6] = True
    v2[[3, 5, 10, 11, 12, 13, n2 - 2, n2 - 1]] = True
    return d1, d2, v1, v2


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("n1,n2,seed", [(300, 200, 0), (64, 8300, 1)])
def test_best2_l2_plain_is_exact(n1, n2, seed):
    """Bit-equal to JAX _best2_l2 on every row, and to the interpret-mode
    Pallas kernel on valid1 rows (it may zero rows of all-invalid 128-row
    sub-tiles); N2 = 8300 is past the TPU kernel's MAX_N2 of 8192."""
    d1, d2, v1, v2 = _problem(n1, n2, seed)
    got = [g.numpy() for g in matchk.best2_l2_ref(*_t(d1, d2, v2))]
    want = [np.asarray(w) for w in jm._best2_l2(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][0] == 3 and got[0][0] == 0 and got[1][0] == 0      # tie: d2 == d1
    assert got[2][1] == n2 - 2 and got[1][1] == got[0][1] == 0
    if n2 <= 8192:
        pal = best2_l2_pallas(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2),
                              jnp.asarray(v1), interpret=True)
        for g, w in zip(got, pal):
            np.testing.assert_array_equal(g[v1], np.asarray(w)[v1])


def test_best2_l2_all_invalid_columns():
    d1, d2, _, _ = _problem(20, 30, 2)
    v2 = np.zeros(30, bool)
    got = matchk.best2_l2_ref(*_t(d1, d2, v2))
    want = jm._best2_l2(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isinf(got[0].numpy()).all() and (got[2].numpy() == 0).all()


def test_best2_l2_wrapper_takes_plain_version_on_cpu():
    d1, d2, v1, v2 = _problem(40, 50, 3)
    matchk.best2_l2.launches = 0
    got = matchk.best2_l2(*_t(d1, d2, v2), torch.from_numpy(v1))
    want = matchk.best2_l2_ref(*_t(d1, d2, v2))
    assert matchk.best2_l2.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        matchk.best2_l2(torch.zeros(4, 64, dtype=torch.uint8), *_t(d2, v2))


@pytest.mark.parametrize("metric", ["L1", "L2"])
@pytest.mark.parametrize("ratio_sq", [0.5329, 0.9])
def test_match_descriptors_dense_matches_jax(metric, ratio_sq):
    """keep, idx, dist and dist2 exactly, on valid1 rows (idx everywhere
    where kept)."""
    d1, d2, v1, v2 = _problem(120, 90, 4)
    got = tm.match_descriptors_dense(*_t(d1, v1, d2, v2), metric=metric, ratio_sq=ratio_sq)
    want = jm.match_descriptors_dense(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
                                      jnp.asarray(v2), metric=metric, ratio_sq=ratio_sq)
    keep = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), keep)
    assert keep.sum() > 3
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy()[v1], np.asarray(w)[v1])


@pytest.mark.parametrize("metric,xy_radius", [("L1", None), ("L1", (6.0, 10.0)),
                                              ("L2", (2.0, 10.0)), ("L2", None)])
def test_match_descriptors_jax_compaction_and_xy_gate(metric, xy_radius):
    """count, keep order (np.nonzero), idx1/idx2/dist/valid exactly."""
    rng = np.random.default_rng(5)
    d = rng.integers(0, 255, (48, 128)).astype(np.uint8)
    d2 = d.copy()
    d2[::3, :8] += 3
    xy1 = rng.uniform(0, 100, (48, 2)).astype(np.float32)
    xy2 = xy1 + np.where(np.arange(48)[:, None] % 2, 5.0, 1.0).astype(np.float32) * [1, 0]
    v1 = rng.uniform(size=48) < 0.8
    v2 = np.ones(48, bool)
    kw = dict(metric=metric, ratio_sq=0.9, xy_radius=xy_radius)
    got = tm.match_descriptors_jax(*_t(d, v1, d2, v2), xy1=torch.from_numpy(xy1),
                                   xy2=torch.from_numpy(xy2), **kw)
    want = jm.match_descriptors_jax(jnp.asarray(d), jnp.asarray(v1), jnp.asarray(d2),
                                    jnp.asarray(v2), xy1=jnp.asarray(xy1), xy2=jnp.asarray(xy2),
                                    **kw)
    assert isinstance(got, tm.MatchResult)
    assert int(got.count) == int(want.count) > 0
    for f in ("idx1", "idx2", "dist", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)


def test_unknown_metric_raises():
    d1, d2, v1, v2 = _problem(8, 16, 6)
    with pytest.raises(ValueError, match="metric"):
        tm.match_descriptors_dense(*_t(d1, v1, d2, v2), metric="cos")


@pytest.mark.parametrize("n1,n2", [(1, 1), (37, 1), (1, 300), (129, 2), (256, 8320)])
def test_best2_l2_plain_edge_shapes_match_jax(n1, n2):
    """Single rows and columns, a partial 128-row tile, and the VO step's
    keyframe call (256 spawn rows x 8320 slots): bit-equal to JAX _best2_l2."""
    rng = np.random.default_rng(n1 * 7 + n2)
    d1 = rng.integers(0, 256, (n1, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (n2, 128), dtype=np.uint8)
    v2 = rng.uniform(size=n2) < 0.8
    got = matchk.best2_l2_ref(*_t(d1, d2, v2))
    want = jm._best2_l2(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
