"""Two-view geometry, RANSAC, RANSAC-PnP, two-view init and the pose graph:
the port's ``sfm`` modules against the JAX package's, on the scenes of
tests/test_sfm_geometry.py, tests/test_ransac.py and
tests/test_pnp_posegraph.py.

Drift between the two, and how each test holds it:
* SVD and ``eigh`` signs differ between libraries: F and E are compared up
  to sign, ``decompose_essential``'s candidates as a set (rotations in
  either order, t up to sign), and ``choose_pose`` is fed JAX's candidates
  and must pick the same index.
* RANSAC draws: the port takes the rows JAX drew (``weights=`` for the
  homography and essential fits, ``draws=`` for PnP).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.sfm import geometry as jg
from sift_pyocl_tpu.sfm import posegraph as jpg
from sift_pyocl_tpu.sfm.pnp import ransac_pnp as j_ransac_pnp
from sift_pyocl_tpu.sfm.synthetic import make_problem, perturb
from sift_pyocl_tpu.sfm.twoview import initialize_two_view as j_init

from sift_pyocl_tpu_torch.sfm import geometry as tg
from sift_pyocl_tpu_torch.sfm import posegraph as tpg
from sift_pyocl_tpu_torch.sfm.pnp import (JITTER, SUBSET, pnp_draws, ransac_pnp,
                                          ransac_pnp_given_draws)
from sift_pyocl_tpu_torch.sfm.twoview import initialize_two_view

# the modules, not the `ransac` functions both sfm packages export
jr = importlib.import_module("sift_pyocl_tpu.sfm.ransac")
tr = importlib.import_module("sift_pyocl_tpu_torch.sfm.ransac")


F32_GAP = 5e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _up_to_sign(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    _close(got * np.sign(np.sum(got * want)), want, atol)


def _essential_scene():
    """tests/test_ransac.py::test_ransac_essential_with_outliers's scene
    (150 points, 45 outliers) in pixels and in K-normalized coordinates."""
    rng = np.random.default_rng(1)
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (150, 3))
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1.0]])
    R2 = np.asarray(jg.so3_exp(jnp.asarray([0.03, -0.25, 0.02])))
    t2 = np.array([-0.8, 0.1, 0.05])
    uv1 = np.array(jg.project(jnp.asarray(K), jnp.eye(3), jnp.zeros(3), jnp.asarray(X))[0])
    uv2 = np.array(jg.project(jnp.asarray(K), jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(X))[0])
    uv2 += rng.normal(0, 0.3, uv2.shape)
    out_idx = rng.choice(150, 45, replace=False)
    uv2[out_idx] = rng.uniform(0, 300, (45, 2))
    gt_in = np.ones(150, bool)
    gt_in[out_idx] = False
    K, uv1, uv2 = (a.astype(np.float32) for a in (K, uv1, uv2))
    xy1 = np.asarray(jg.backproject(jnp.asarray(K), jnp.asarray(uv1)))[:, :2]
    xy2 = np.asarray(jg.backproject(jnp.asarray(K), jnp.asarray(uv2)))[:, :2]
    return K, uv1, uv2, xy1, xy2, gt_in


@pytest.fixture(scope="module")
def essential_scene():
    return _essential_scene()


def _homography_scene():
    """tests/test_ransac.py::_homography_scene (120 points, 35 % outliers)."""
    rng = np.random.default_rng(0)
    H_gt = np.array([[1.05, 0.02, 5.0], [-0.01, 0.98, -3.0], [5e-5, -1e-4, 1.0]])
    p1 = rng.uniform(0, 300, (120, 2))
    ph = np.concatenate([p1, np.ones((120, 1))], axis=1) @ H_gt.T
    p2 = ph[:, :2] / ph[:, 2:]
    p2 += rng.normal(0, 0.3, p2.shape)
    out_idx = rng.choice(120, 42, replace=False)
    p2[out_idx] = rng.uniform(0, 300, (42, 2))
    gt_in = np.ones(120, bool)
    gt_in[out_idx] = False
    return p1.astype(np.float32), p2.astype(np.float32), gt_in


@pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [1e-7, -2e-7, 3e-7], [0.3, -0.2, 0.5],
                               [2.0, 1.0, -1.5]])
def test_so3_log_and_pose_inverse_match_jax(w):
    """so3_log and pose_inverse within 1e-5, batched rows equal to single."""
    R = np.asarray(jg.so3_exp(jnp.asarray(w, jnp.float32)))
    _close(tg.so3_log(_t(R)), jg.so3_log(jnp.asarray(R)), 1e-5)
    t = np.array([0.3, -1.2, 2.0], np.float32)
    for g, j in zip(tg.pose_inverse(_t(R), _t(t)), jg.pose_inverse(jnp.asarray(R), jnp.asarray(t))):
        _close(g, j, 1e-5)
    Rb = np.stack([R, R.T])
    _close(tg.so3_log(_t(Rb))[1], jg.so3_log(jnp.asarray(R.T)), 1e-5)


def test_fundamental_and_essential_match_jax_up_to_sign(essential_scene):
    """fit_fundamental_8pt on the inlier set within 1e-4 of the JAX fit up
    to sign.  On 8-point rows (batched) f32 is the limit: both packages'
    fits lie within F32_GAP of the float64 fit (measured: at most 3.6e-4
    for either, 1.6e-4 apart).  essential_from_fundamental of the same F
    within 1e-4; the Sampson errors within rtol 1e-4."""
    K, uv1, uv2, xy1, xy2, gt_in = essential_scene
    rows = np.asarray(jr._sample_weights(jax.random.key(3), jnp.ones(150, bool), 6, 8))
    W = np.concatenate([gt_in[None].astype(np.float32), rows])
    got = tg.fit_fundamental_8pt(_t(xy1), _t(xy2), _t(W)).numpy()
    f64 = tg.fit_fundamental_8pt(*(torch.from_numpy(np.array(a)).double() for a in (xy1, xy2, W)))
    for b in range(len(W)):
        want = np.asarray(jg.fit_fundamental_8pt(jnp.asarray(xy1), jnp.asarray(xy2),
                                                 jnp.asarray(W[b])))
        if b == 0:
            _up_to_sign(got[b], want, 1e-4)
        for f32 in (got[b], want):
            _up_to_sign(f32, f64[b].numpy(), F32_GAP)
    F = np.asarray(jg.fit_fundamental_8pt(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(W[0])))
    _close(tg.essential_from_fundamental(_t(F), _t(K), _t(K)),
           jg.essential_from_fundamental(jnp.asarray(F), jnp.asarray(K), jnp.asarray(K)), 1e-4)
    E = got[0]
    _close(tg.sampson_error_F(_t(E), _t(xy1), _t(xy2)),
           jg.sampson_error_F(jnp.asarray(E), jnp.asarray(xy1), jnp.asarray(xy2)), 1e-12, 1e-4)


def test_decompose_essential_and_choose_pose_match_jax(essential_scene):
    """The four candidates agree as a set after sign alignment (rotations
    within 1e-4 in either order, t up to sign); fed JAX's candidates,
    choose_pose picks JAX's index with its score."""
    _, _, _, xy1, xy2, gt_in = essential_scene
    E = np.asarray(jg.fit_fundamental_8pt(jnp.asarray(xy1), jnp.asarray(xy2),
                                          jnp.asarray(gt_in, jnp.float32)))
    jRs, jts = (np.asarray(a) for a in jg.decompose_essential(jnp.asarray(E)))
    tRs, tts = (a.numpy() for a in tg.decompose_essential(_t(E)))
    for R in tRs:
        assert min(np.abs(R - jR).max() for jR in jRs) < 1e-4
    for t in tts:
        assert min(np.abs(t - s * jt).max() for jt in jts for s in (1, -1)) < 1e-4
    eye = np.eye(3, dtype=np.float32)
    w = gt_in.astype(np.float32)
    jR, jt, js = jg.choose_pose(*(jnp.asarray(a) for a in (jRs, jts, eye, eye, xy1, xy2, w)))
    R, t, s = tg.choose_pose(_t(jRs), _t(jts), _t(eye), _t(eye), _t(xy1), _t(xy2), _t(w))
    j_idx = [k for k in range(4) if np.array_equal(jRs[k], np.asarray(jR))
             and np.array_equal(jts[k], np.asarray(jt))]
    t_idx = [k for k in range(4) if np.array_equal(jRs[k], R.numpy())
             and np.array_equal(jts[k], t.numpy())]
    assert t_idx[0] == j_idx[0]
    assert float(s) == float(js) == gt_in.sum()


def test_homography_fit_and_error_match_jax():
    """fit_homography on the inlier set within rtol 1e-4 (atol 1e-6 for the
    ~1e-4 perspective terms; H[2, 2] = 1), homography_error of one H within
    rtol 1e-4.  Minimal 4-point fits differ by up to 1 % between the two
    f32 solves; RANSAC's test holds their outcome."""
    p1, p2, gt_in = _homography_scene()
    w = gt_in.astype(np.float32)
    want = jg.fit_homography(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w))
    _close(tg.fit_homography(_t(p1), _t(p2), _t(w[None]))[0], want, 1e-6, 1e-4)
    _close(tg.homography_error(_t(want), _t(p1), _t(p2)),
           jg.homography_error(want, jnp.asarray(p1), jnp.asarray(p2)), 1e-3, 1e-4)


def test_ransac_homography_matches_jax_given_its_rows():
    """Fed the rows JAX drew: inliers and scores equal, H within 1e-4."""
    p1, p2, gt_in = _homography_scene()
    key = jax.random.key(0)
    valid = jnp.ones(120, bool)
    rows = np.asarray(jr._sample_weights(key, valid, 256, 4))
    want = jr.ransac_homography(key, jnp.asarray(p1), jnp.asarray(p2), valid)
    got = tr.ransac_homography(0, p1, p2, np.ones(120, bool), weights=rows, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) and int(got.best_score) == int(want.best_score)
    _close(got.model, want.model, 1e-6, 1e-4)
    assert (got.inliers.numpy() & gt_in).sum() >= 0.97 * gt_in.sum()


def test_ransac_essential_matches_jax_given_its_rows(essential_scene):
    """Fed the rows JAX drew: inliers and scores equal, the model within
    1e-4 up to sign."""
    _, _, _, xy1, xy2, _ = essential_scene
    key = jax.random.key(2)
    valid = jnp.ones(150, bool)
    rows = np.asarray(jr._sample_weights(key, valid, 256, 8))
    thresh = (2.0 / 400.0) ** 2
    want = jr.ransac_essential_normalized(key, jnp.asarray(xy1), jnp.asarray(xy2), valid,
                                          thresh=thresh)
    got = tr.ransac_essential_normalized(0, xy1, xy2, np.ones(150, bool), thresh=thresh,
                                         weights=rows, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) and int(got.best_score) == int(want.best_score)
    _up_to_sign(got.model, want.model, 1e-4)


def test_initialize_two_view_matches_jax_given_its_rows(essential_scene):
    """Fed JAX's RANSAC rows: `good` equal, R and t within 1e-4, the good
    points within 1e-3; and near the truth (tests/test_ransac.py)."""
    K, uv1, uv2, _, _, gt_in = essential_scene
    key = jax.random.key(1)
    rows = np.asarray(jr._sample_weights(key, jnp.ones(150, bool), 256, 8))
    want = j_init(key, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(150, bool),
                  thresh_px=2.0)
    got = initialize_two_view(0, K, uv1, uv2, np.ones(150, bool), thresh_px=2.0, weights=rows,
                              device="cpu")
    good = np.asarray(want.inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), good)
    assert int(got.n_inliers) == int(want.n_inliers)
    _close(got.R, want.R, 1e-4)
    _close(got.t, want.t, 1e-4)
    _close(got.points.numpy()[good], np.asarray(want.points)[good], 1e-3)
    assert (good & gt_in).sum() >= 0.9 * gt_in.sum()


def _pnp_outlier_scene():
    """tests/test_pnp_posegraph.py::test_ransac_pnp_with_outliers's scene:
    _pnp_scene(seed=1, n=100) with 30 outliers and a perturbed init."""
    rng = np.random.default_rng(1)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (100, 3)).astype(np.float32)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    R = np.asarray(jg.so3_exp(jnp.asarray([0.05, -0.2, 0.1])), np.float32)
    t = np.array([0.3, -0.1, 0.2], np.float32)
    uv = np.array(jg.project(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))[0])
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    rng = np.random.default_rng(2)
    out = rng.choice(100, 30, replace=False)
    uv[out] = rng.uniform(0, 300, (30, 2)).astype(np.float32)
    R0, t0 = jg.pose_retract(jnp.asarray(R), jnp.asarray(t),
                             jnp.asarray([0.02, 0.02, -0.03, 0.08, 0.05, -0.1]))
    gt_in = np.ones(100, bool)
    gt_in[out] = False
    return K, R, t, X, uv.astype(np.float32), np.asarray(R0), np.asarray(t0), gt_in


def jax_pnp_draws(key, w, n_hypo: int = 16):
    """The (xi, subset) rows ``sift_pyocl_tpu/sfm/pnp.py::ransac_pnp`` draws
    from `key` for weights `w` (its per-hypothesis key splits)."""
    n = w.shape[0]

    def one(k):
        k1, k2 = jax.random.split(k)
        xi = jax.random.normal(k1, (6,)) * jnp.asarray(JITTER)
        g = jnp.where(w > 0, jax.random.gumbel(k2, (n,)), -jnp.inf)
        _, idx = jax.lax.top_k(g, SUBSET)
        return xi, jnp.zeros((n,)).at[idx].set(1.0)

    xi, sub = jax.vmap(one)(jax.random.split(key, n_hypo))
    return np.asarray(xi), np.asarray(sub)


def test_ransac_pnp_matches_jax_given_its_draws():
    """Fed JAX's draws: inliers and their count equal, R and t within 1e-4."""
    K, R_gt, t_gt, X, uv, R0, t0, gt_in = _pnp_outlier_scene()
    w = np.ones(100, np.float32)
    w[::9] = 0.0
    key = jax.random.key(0)
    want = j_ransac_pnp(key, jnp.asarray(K), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                        jnp.asarray(uv), jnp.asarray(w))
    got = ransac_pnp(0, _t(K), _t(R0), _t(t0), _t(X), _t(uv), _t(w),
                     draws=[torch.from_numpy(np.array(d))
                            for d in jax_pnp_draws(key, jnp.asarray(w))])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)


def test_ransac_pnp_own_draws_recover_the_pose():
    """The port's own draws (a CPU generator): 12 distinct w > 0 entries a
    row, the same rows for a seed; the pose within tests/test_pnp_posegraph.py's
    tolerances."""
    K, R_gt, t_gt, X, uv, R0, t0, gt_in = _pnp_outlier_scene()
    w = torch.ones(100)
    w[::9] = 0.0
    xi, sub = pnp_draws(5, w)
    assert xi.shape == (16, 6) and torch.equal(sub.sum(1), torch.full((16,), 12.0))
    assert float((sub * (w == 0)).sum()) == 0.0
    assert torch.equal(sub, pnp_draws(5, w)[1]) and not torch.equal(sub, pnp_draws(6, w)[1])
    R, t, inl, n_inl = ransac_pnp(0, _t(K), _t(R0), _t(t0), _t(X), _t(uv), torch.ones(100))
    got = inl.numpy()
    assert (got & gt_in).sum() >= 0.9 * gt_in.sum() and (got & ~gt_in).sum() <= 2
    _close(R, R_gt, 1e-2)
    _close(t, t_gt, 2e-2)


def test_ransac_pnp_under_vmap_over_frames_equals_one_at_a_time():
    """The loop-closure probe's batch: ransac_pnp_given_draws mapped over
    three frames (inits, weights and draws of their own) gives each
    frame's inliers and counts, and its pose within 1e-4 (the batched
    products sum in another order), as one call a frame."""
    K, _, _, X, uv, R0, t0, _ = _pnp_outlier_scene()
    rng = np.random.default_rng(8)
    Ws = torch.from_numpy((rng.uniform(size=(3, 100)) < [[0.9], [0.7], [0.5]]).astype(np.float32))
    R0s = torch.stack([_t(R0), _t(R0).T @ _t(R0) @ _t(R0), _t(R0)])
    t0s = torch.stack([_t(t0), _t(t0) * 1.05, _t(t0) + 0.02])
    draws = [pnp_draws(s, Ws[k]) for k, s in enumerate((3, 4, 5))]
    probe = torch.func.vmap(lambda R_, t_, w_, xi_, sub_: ransac_pnp_given_draws(
        _t(K), R_, t_, _t(X), _t(uv), w_, xi_, sub_, thresh_px=3.0))
    got = probe(R0s, t0s, Ws, *(torch.stack([d[k] for d in draws]) for k in (0, 1)))
    for k in range(3):
        want = ransac_pnp(0, _t(K), R0s[k], t0s[k], _t(X), _t(uv), Ws[k], thresh_px=3.0,
                          draws=draws[k])
        assert torch.equal(got[2][k], want[2]) and int(got[3][k]) == int(want[3])
        _close(got[0][k], want[0], 1e-4)
        _close(got[1][k], want[1], 1e-4)


@pytest.fixture(scope="module")
def chain_graph():
    """tests/test_pnp_posegraph.py::test_pose_graph_chain's graph: a noisy
    start, exact odometry edges and one loop edge; and the same edges with
    translation noise (2 cm), whose optimum keeps a cost."""
    _, gt, _, _ = make_problem(n_cams=10, n_points=50, seed=3)
    start = perturb(gt, rot_deg=3.0, trans=0.2, point_sigma=0.0, seed=4, keep_fixed=(0,))
    ei = list(range(9)) + [0]
    ej = list(range(1, 10)) + [9]
    Z = [jpg.relative_pose(*(jnp.asarray(a) for a in (gt.Rs[i], gt.ts[i], gt.Rs[j], gt.ts[j])))
         for i, j in zip(ei, ej)]
    graph = dict(i=np.asarray(ei, np.int32), j=np.asarray(ej, np.int32),
                 Z_R=np.stack([np.asarray(z[0]) for z in Z]),
                 Z_t=np.stack([np.asarray(z[1]) for z in Z]), w=np.ones(10, np.float32))
    free = np.ones(10, np.float32)
    free[0] = 0.0
    noisy = dict(graph, Z_t=graph["Z_t"] + np.random.default_rng(5).normal(
        0, 0.02, graph["Z_t"].shape).astype(np.float32))
    return gt, start, {"exact": graph, "noisy": noisy}, free


def test_pose_graph_jacobians_and_relative_pose_match_jax(chain_graph):
    """The edge Jacobians (jvp here, jacfwd there) within 1e-5; batched
    relative_pose within 1e-6."""
    _, start, graphs, _ = chain_graph
    g = graphs["exact"]
    Rs, ts = start.Rs, start.ts
    for e in range(10):
        i, j = g["i"][e], g["j"][e]
        Ri, ti, Rj, tj = (jnp.asarray(a) for a in (Rs[i], ts[i], Rs[j], ts[j]))
        f = lambda a, b: jpg._edge_residual(*jg.pose_retract(Ri, ti, a), *jg.pose_retract(Rj, tj, b),
                                            jnp.asarray(g["Z_R"][e]), jnp.asarray(g["Z_t"][e]))
        z = jnp.zeros(6)
        Ji, Jj = tpg._edge_jacobians(_t(Rs[i][None]), _t(ts[i][None]), _t(Rs[j][None]),
                                     _t(ts[j][None]), _t(g["Z_R"][e][None]), _t(g["Z_t"][e][None]))
        _close(Ji[0], jax.jacfwd(f, argnums=0)(z, z), 1e-5)
        _close(Jj[0], jax.jacfwd(f, argnums=1)(z, z), 1e-5)
    got = tpg.relative_pose(_t(Rs[:-1]), _t(ts[:-1]), _t(Rs[1:]), _t(ts[1:]))
    for k in range(9):
        want = jpg.relative_pose(*(jnp.asarray(a) for a in (Rs[k], ts[k], Rs[k + 1], ts[k + 1])))
        _close(got[0][k], want[0], 1e-6)
        _close(got[1][k], want[1], 1e-6)


@pytest.mark.parametrize("edges", ["exact", "noisy"])
def test_optimize_pose_graph_matches_jax(chain_graph, edges):
    """25 iterations as tests/test_pnp_posegraph.py: poses within 1e-4 of
    the JAX solve; the cost below 1e-6 on exact edges (both ~1e-12, float
    noise), within rtol 1e-4 on noisy ones."""
    _, start, graphs, free = chain_graph
    g = graphs[edges]
    iters = 25
    jgraph = jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()})
    want = jpg.optimize_pose_graph(jnp.asarray(start.Rs), jnp.asarray(start.ts), jgraph,
                                   jnp.asarray(free), iters=iters)
    got = tpg.optimize_pose_graph(_t(start.Rs), _t(start.ts),
                                  tpg.PoseGraph(**{k: torch.from_numpy(v) for k, v in g.items()}),
                                  _t(free), iters=iters)
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)
    if edges == "noisy":
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    else:
        assert float(got[2]) < 1e-6 and float(want[2]) < 1e-6
