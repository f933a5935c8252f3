"""The two-view init at the JAX package's padded bucket, on the CPU: the
port's ``initialize_two_view`` on matches padded to 256 and 512 rows (a
valid mask) against the JAX package's jitted one on the same padded
inputs and rows; the padded init against the unpadded one; the RANSAC
draws split into host noise and device top-k (``ransac_host_noise``,
``sample_rows``) against ``_sample_weights``; ``IncrementalSfM``'s padding;
and the K12 / K13 wrappers' plain route (``ops.kernels.linalg``).

On the CPU the wrappers take ``torch.linalg.eigh`` and ``torch.linalg.svd``
and ``initialize_two_view`` its eager function; the card's graph and
kernels are ``tests/test_torch_gpu_twoview_graph.py``'s.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.sfm.twoview import initialize_two_view as j_init

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops.kernels import launch_counts, linalg, reset_launch_counts
from sift_pyocl_tpu_torch.sfm import geometry as tg
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import twoview as ttv

from test_torch_sfm_geometry import _essential_scene
from _torch_threads import _one_torch_thread  # noqa: F401

# the modules, not the `ransac` functions both sfm packages export
jr = importlib.import_module("sift_pyocl_tpu.sfm.ransac")
tr = importlib.import_module("sift_pyocl_tpu_torch.sfm.ransac")

THRESH_PX = 2.0


@pytest.fixture(scope="module")
def scene():
    return _essential_scene()


def _padded(uv1, uv2, P):
    n = len(uv1)
    return (tpipe._pad_rows(uv1, P, np.float32), tpipe._pad_rows(uv2, P, np.float32),
            np.arange(P) < n)


@pytest.mark.parametrize("P", [256, 512])
def test_padded_init_matches_jax_given_its_rows(scene, P):
    """The 150 matches padded to P rows: the port fed the rows JAX draws
    over the whole bucket gives JAX's inliers and count, R and t within
    1e-4, the good points within 1e-3; no padded row is an inlier."""
    K, uv1, uv2, _, _, gt_in = scene
    a1, a2, v = _padded(uv1, uv2, P)
    key = jax.random.key(11)
    rows = np.asarray(jr._sample_weights(key, jnp.asarray(v), 256, 8))
    want = j_init(key, *(jnp.asarray(a) for a in (K, a1, a2, v)), thresh_px=THRESH_PX)
    got = ttv.initialize_two_view(0, K, a1, a2, v, thresh_px=THRESH_PX, weights=rows,
                                  device="cpu")
    good = np.asarray(want.inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), good)
    assert int(got.n_inliers) == int(want.n_inliers) and not good[150:].any()
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_allclose(got.points.numpy()[good], np.asarray(want.points)[good],
                               atol=1e-3)
    assert (good[:150] & gt_in).sum() >= 0.9 * gt_in.sum()


@pytest.mark.parametrize("P,seed", [(256, 0), (512, 1)])
def test_padded_init_matches_unpadded(scene, P, seed):
    """The same rows over the 150 matches and over their P-row bucket (the
    padded columns all 0) give the same inlier set, R and t within 1e-4
    (the zero-weight rows change only the order of A^T A's sums)."""
    K, uv1, uv2, _, _, _ = scene
    a1, a2, v = _padded(uv1, uv2, P)
    rows = tr._sample_weights(seed, torch.from_numpy(v), 256, 8)
    got = ttv.initialize_two_view(0, K, a1, a2, v, thresh_px=THRESH_PX, weights=rows,
                                  device="cpu")
    want = ttv.initialize_two_view(0, K, uv1, uv2, np.ones(150, bool), thresh_px=THRESH_PX,
                                   weights=rows[:, :150], device="cpu")
    assert torch.equal(got.inliers[:150], want.inliers) and not bool(got.inliers[150:].any())
    assert int(got.n_inliers) == int(want.n_inliers) >= 90
    np.testing.assert_allclose(got.R.numpy(), want.R.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=1e-4)


def _sample_weights_before(seed, valid, n_hypo, k):
    """``_sample_weights`` as one function, before its split (the rows
    the port drew up to now)."""
    n = valid.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    u = torch.rand((n_hypo, n), generator=gen, dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    g = (-torch.log(-torch.log(u))).to(valid.device)
    g = torch.where(valid.bool()[None, :], g, -torch.inf)
    idx = torch.topk(g, k, dim=1).indices
    w = torch.zeros((n_hypo, n), dtype=torch.float32, device=valid.device)
    return w.scatter_(1, idx, 1.0)


@pytest.mark.parametrize("seed,n,P,n_hypo,k", [(0, 150, 256, 256, 8), (7, 300, 512, 256, 8),
                                               (3, 20, 256, 64, 4), (5, 9, 16, 32, 3)])
def test_split_draws_equal_sample_weights(seed, n, P, n_hypo, k):
    """sample_rows(ransac_host_noise(seed, n_hypo, P), valid, k) equals
    _sample_weights and its form before the split bit for bit; each row
    picks k distinct valid entries and never a padded one; the noise is a
    CPU tensor, the same on every call."""
    valid = torch.arange(P) < n
    g = tr.ransac_host_noise(seed, n_hypo, P)
    assert g.device.type == "cpu" and g.shape == (n_hypo, P) and g.dtype == torch.float32
    assert torch.equal(g, tr.ransac_host_noise(seed, n_hypo, P))
    rows = tr.sample_rows(g, valid, k)
    assert torch.equal(rows, tr._sample_weights(seed, valid, n_hypo, k))
    assert torch.equal(rows, _sample_weights_before(seed, valid, n_hypo, k))
    assert bool((rows.sum(1) == k).all()) and not bool(rows[:, n:].any())


def test_incremental_sfm_pads_the_two_view_init(scene, monkeypatch):
    """IncrementalSfM._run_two_view_init pads the M matched pairs to
    _pow2_pad(M) rows with a valid mask (M = 150 -> 256, 300 -> 512), and
    returns the init on the host with its points and inliers sliced to the
    M pairs, equal to the padded init's first M rows."""
    K, uv1, uv2, _, _, _ = scene
    calls = []

    def recorded(seed, K_, a1, a2, v, **kw):
        out = ttv.initialize_two_view(seed, K_, a1, a2, v, **kw)
        calls.append((a1, a2, v, kw, out))
        return out

    monkeypatch.setattr(tpipe, "initialize_two_view", recorded)
    sfm = tpipe.IncrementalSfM(K, (240, 320), cfg=SiftConfig(kp_per_octave_cap=256),
                               reproj_px=THRESH_PX, device="cpu")
    for m in (150, 300):
        u1, u2 = np.resize(uv1, (m, 2)), np.resize(uv2, (m, 2))
        init = sfm._run_two_view_init(np.zeros((m, 2), np.int64), u1, u2)
        a1, a2, v, kw, out = calls[-1]
        P = tpipe._pow2_pad(m)
        assert a1.shape == a2.shape == (P, 2) and a1.dtype == np.float32
        np.testing.assert_array_equal(v, np.arange(P) < m)
        np.testing.assert_array_equal(a1[:m], u1)
        assert not a1[m:].any() and not a2[m:].any() and kw["thresh_px"] == THRESH_PX
        assert init.points.shape == (m, 3) and init.inliers.shape == (m,)
        assert all(t.device.type == "cpu" for t in init)
        assert torch.equal(init.points, out.points[:m]) and torch.equal(init.inliers,
                                                                       out.inliers[:m])
        assert not bool(out.inliers[m:].any())
        assert int(init.n_inliers) == int(init.inliers.sum()) >= 90


def test_linalg_wrappers_take_the_plain_route_on_the_cpu():
    """On CPU tensors sym_eig_small and svd3 are torch.linalg.eigh and
    torch.linalg.svd bit for bit (f32 and f64, batched and not) and launch
    nothing; a shape they do not take raises."""
    gen = torch.Generator().manual_seed(0)
    reset_launch_counts()
    for dtype in (torch.float32, torch.float64):
        B = torch.randn((5, 9, 9), generator=gen, dtype=dtype)
        A = B + B.transpose(-1, -2)
        for a in (A, A[0]):
            w, V = linalg.sym_eig_small(a)
            ww, VV = torch.linalg.eigh(a)
            assert torch.equal(w, ww) and torch.equal(V, VV)
        M = torch.randn((4, 3, 3), generator=gen, dtype=dtype)
        for m in (M, M[1]):
            assert all(torch.equal(x, y) for x, y in zip(linalg.svd3(m), torch.linalg.svd(m)))
    assert launch_counts()["sym_eig_small"] == launch_counts()["svd3"] == 0
    for bad in (torch.zeros(10, 10), torch.zeros(3, 4), torch.zeros(3)):
        with pytest.raises(ValueError):
            linalg.sym_eig_small(bad)
    for bad in (torch.zeros(2, 2), torch.zeros(4, 4)):
        with pytest.raises(ValueError):
            linalg.svd3(bad)


def test_decompose_essential_equals_its_w_matrix_form(scene):
    """decompose_essential's rotations, built from U's columns (no constant
    copied from the host), equal U W Vt and U W^T Vt bit for bit."""
    _, _, _, xy1, xy2, gt_in = scene
    E = tg.fit_fundamental_8pt(torch.tensor(xy1), torch.tensor(xy2),
                               torch.tensor(gt_in, dtype=torch.float32)[None])[0]
    Rs, ts = tg.decompose_essential(E)
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(tg._det3(U))
    Vt = Vt * torch.sign(tg._det3(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    assert torch.equal(Rs[0], U @ W @ Vt) and torch.equal(Rs[2], U @ W.T @ Vt)
    assert torch.equal(ts[0], U[:, 2]) and torch.equal(ts[1], -U[:, 2])
