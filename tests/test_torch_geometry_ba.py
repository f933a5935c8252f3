"""Geometry, PnP, bundle adjustment (every layout, ``run_ba``) and the
checkpoints: the port's ``sfm`` modules against the JAX package's on the
JAX suite's own scenes.  The port's scatter form sums by sorted segments
(``sfm/segment.py``) where the JAX package scatter-adds: the same sums in
another order, held at tests/test_ba.py's tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from sift_pyocl_tpu.models.vo import VOState as JVOState
from sift_pyocl_tpu.sfm import ba as jba
from sift_pyocl_tpu.sfm import checkpoint as jck
from sift_pyocl_tpu.sfm import geometry as jg
from sift_pyocl_tpu.sfm.pnp import pnp_refine as j_pnp_refine
from sift_pyocl_tpu.sfm.synthetic import make_problem, perturb

from sift_pyocl_tpu_torch.models.vo import VOState
from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm import checkpoint as tck
from sift_pyocl_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
from sift_pyocl_tpu_torch.sfm import geometry as tg
from sift_pyocl_tpu_torch.sfm.pnp import pnp_refine
from sift_pyocl_tpu_torch.sfm.segment import segment_sum, segments
from sift_pyocl_tpu_torch.utils.convert import ba_obs_from_jax, ba_params_from_jax
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL = 1e-5


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [1e-7, -2e-7, 3e-7], [0.3, -0.2, 0.5], [2.0, 1.0, -1.5]])
def test_so3_se3_exp_match_jax(w):
    w = np.asarray(w, np.float32)
    xi = np.concatenate([w, np.asarray([0.4, -0.3, 1.2], np.float32)])
    _close(tg.hat(torch.from_numpy(w)), jg.hat(jnp.asarray(w)))
    _close(tg.so3_exp(torch.from_numpy(w)), jg.so3_exp(jnp.asarray(w)))
    for g, j in zip(tg.se3_exp(torch.from_numpy(xi)), jg.se3_exp(jnp.asarray(xi))):
        _close(g, j)
    R = jg.so3_exp(jnp.asarray([0.1, 0.2, -0.1]))
    t = jnp.asarray([0.3, -0.2, 1.0])
    for g, j in zip(tg.pose_retract(torch.from_numpy(np.array(R)), torch.from_numpy(np.array(t)),
                                    torch.from_numpy(xi)),
                    jg.pose_retract(R, t, jnp.asarray(xi))):
        _close(g, j)


def test_batched_se3_exp_equals_per_row():
    xi = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32) * 0.3
    R, t = tg.se3_exp(torch.from_numpy(xi))
    for i in range(5):
        Rj, tj = jg.se3_exp(jnp.asarray(xi[i]))
        _close(R[i], Rj)
        _close(t[i], tj)


def test_projection_and_triangulation_match_jax():
    rng = np.random.default_rng(1)
    K = np.array([[400.0, 0, 160], [0, 410.0, 120], [0, 0, 1]], np.float32)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (50, 3)).astype(np.float32)
    X[0, 2] = -3.0                       # behind the camera
    R1 = np.array(jg.so3_exp(jnp.asarray([0.02, -0.1, 0.05])))
    t1 = np.array([0.1, -0.05, 0.2], np.float32)
    R2 = np.array(jg.so3_exp(jnp.asarray([-0.03, 0.08, 0.0])))
    t2 = np.array([-0.4, 0.02, 0.1], np.float32)
    T = [torch.from_numpy(a) for a in (K, R1, t1, X)]
    J = [jnp.asarray(a) for a in (K, R1, t1, X)]
    for g, j in zip(tg.project(*T), jg.project(*J)):
        _close(g, j)
    for g, j in zip(tg.project_jacobians(*T), jg.project_jacobians(*J)):
        _close(g, j, atol=1e-4)
    uv1 = np.array(jg.project(*J)[0])
    uv2 = np.array(jg.project(J[0], jnp.asarray(R2), jnp.asarray(t2), J[3])[0])
    _close(tg.backproject(T[0], torch.from_numpy(uv1)), jg.backproject(J[0], jnp.asarray(uv1)))
    A = rng.normal(size=(7, 3, 3)).astype(np.float32)
    b = rng.normal(size=(7, 3)).astype(np.float32)
    _close(tg._solve3_batched(torch.from_numpy(A), torch.from_numpy(b)),
           jg._solve3_batched(jnp.asarray(A), jnp.asarray(b)), rtol=1e-4, atol=1e-5)
    got = tg.triangulate_two_view(T[0], T[1], T[2], T[0], torch.from_numpy(R2), torch.from_numpy(t2),
                                  torch.from_numpy(uv1), torch.from_numpy(uv2))
    want = jg.triangulate_two_view(J[0], J[1], J[2], J[0], jnp.asarray(R2), jnp.asarray(t2),
                                   jnp.asarray(uv1), jnp.asarray(uv2))
    for g, j in zip(got, want):
        _close(g, j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[0].numpy()[1:], X[1:], atol=1e-2)


def _pnp_scene(seed=0, n=80, noise=0.3):
    """tests/test_pnp_posegraph.py::_pnp_scene."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3)).astype(np.float32)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    R = np.asarray(jg.so3_exp(jnp.asarray([0.05, -0.2, 0.1])), np.float32)
    t = np.array([0.3, -0.1, 0.2], np.float32)
    uv = np.array(jg.project(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))[0])
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    return K, R, t, X, uv.astype(np.float32)


def test_pnp_refine_matches_jax():
    K, R_gt, t_gt, X, uv = _pnp_scene()
    xi = jnp.asarray([0.03, -0.02, 0.04, 0.1, -0.08, 0.1])
    R0, t0 = jg.pose_retract(jnp.asarray(R_gt), jnp.asarray(t_gt), xi)
    w = np.ones(len(X), np.float32)
    w[::7] = 0.0
    want = j_pnp_refine(jnp.asarray(K), R0, t0, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w),
                        iters=12)
    got = pnp_refine(*(torch.from_numpy(np.array(a)) for a in (K, R0, t0, X, uv, w)), iters=12)
    _close(got[0], want[0], rtol=1e-4, atol=1e-5)
    _close(got[1], want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    assert float(got[2]) < 0.5
    np.testing.assert_allclose(got[0].numpy(), R_gt, atol=5e-3)


def _vo_layout_problem():
    """tests/test_ba.py::test_lm_blocked_onehot_matches_default's problem:
    observations in per-camera blocks, zero-weight padding."""
    rng = np.random.default_rng(3)
    C, PN, OBS_F = 4, 32, 48
    P, M = C * PN, C * OBS_F
    K = jnp.asarray([[500.0, 0, 200], [0, 500.0, 150], [0, 0, 1]], jnp.float32)
    Rs = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (C, 3, 3)).copy()
    ts = jnp.asarray(rng.normal(size=(C, 3)) * 0.1, jnp.float32)
    X = jnp.asarray(rng.normal(size=(P, 3)) * 2 + [0, 0, 8], jnp.float32)
    cam = jnp.repeat(jnp.arange(C, dtype=jnp.int32), OBS_F)
    pt = jnp.asarray(rng.integers(0, P, M), jnp.int32)
    uv = jnp.asarray(rng.uniform(0, 400, (M, 2)), jnp.float32)
    w = jnp.asarray((rng.uniform(size=M) < 0.8), jnp.float32)
    return K, jba.BAParams(Rs, ts, X), jba.BAObs(uv=uv, cam=cam, pt=pt, w=w), P, C


@pytest.mark.parametrize("dense", [True, False])
def test_lm_iteration_matches_jax(dense):
    """Cost rtol 1e-6, accept equal, parameters rtol 5e-4 / atol 5e-5 (the
    JAX suite's own tolerances for the blocked one-hot layout)."""
    K, params, obs, P, C = _vo_layout_problem()
    free = jnp.arange(C) > 0
    kw = dict(huber_px=3.0, cg_iters=6, n_points=P, cam_blocked=True, pt_onehot=True,
              dense_schur=dense)
    jp, jlam, jcost, jacc = jba.lm_iteration(params, obs, K, jnp.float32(1e-3), free, **kw)
    tp, tlam, tcost, tacc = tba.lm_iteration(
        ba_params_from_jax(params), ba_obs_from_jax(obs), torch.from_numpy(np.array(K)),
        torch.tensor(1e-3), torch.arange(C) > 0, **kw)
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-6)
    assert bool(tacc) == bool(jacc)
    np.testing.assert_allclose(float(tlam), float(jlam), rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)


def test_ba_pieces_match_jax():
    K, params, obs, P, C = _vo_layout_problem()
    tparams, tobs = ba_params_from_jax(params), ba_obs_from_jax(obs)
    Kt = torch.from_numpy(np.array(K))
    r = tba.residuals(tparams, tobs, Kt)
    _close(r, jba.residuals(params, obs, K), rtol=1e-5, atol=1e-3)
    _close(tba.robust_weights(r, tobs.w, 3.0), jba.robust_weights(jnp.asarray(r.numpy()), obs.w, 3.0))
    np.testing.assert_allclose(float(tba.robust_cost(r, tobs.w, 3.0)),
                               float(jba.robust_cost(jnp.asarray(r.numpy()), obs.w, 3.0)), rtol=1e-6)
    A = np.random.default_rng(2).normal(size=(9, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    _close(tba._inv3(torch.from_numpy(A)), jba._inv3(jnp.asarray(A)), rtol=1e-5, atol=1e-6)
    G = tba._pt_onehot_matrix(tobs.pt, P)
    _close(G, jba._pt_onehot_matrix(obs.pt, P))
    vals = torch.from_numpy(np.random.default_rng(4).normal(size=(G.shape[1], 3)).astype(np.float32))
    jvals = jnp.asarray(vals.numpy())
    want_pt = jba._seg_pt(jvals, obs.pt, P, None)
    _close(tba._seg_pt(vals, None, G), want_pt, atol=1e-5)
    _close(tba._seg_pt(vals, segments(tobs.pt, P), None), want_pt, atol=1e-5)
    want_cam = jba._seg_cam(jvals, obs.cam, C, True)
    _close(tba._seg_cam(vals, None, C), want_cam, atol=1e-5)
    _close(tba._seg_cam(vals, segments(tobs.cam, C), C), want_cam, atol=1e-5)
    _close(tba._seg_cam(vals, segments(tobs.cam, C), C), jba._seg_cam(jvals, obs.cam, C, False),
           atol=1e-5)


def test_segment_sum_matches_segment_sum():
    """``segment.segment_sum`` against ``jax.ops.segment_sum``: ids out of
    range (negative, >= n) dropped, empty segments zero, repeated calls the
    same bits, within 1e-5 of JAX's scatter order."""
    rng = np.random.default_rng(6)
    ids = rng.integers(-2, 14, 300).astype(np.int32)
    vals = rng.normal(size=(300, 2, 3)).astype(np.float32)
    seg = segments(torch.from_numpy(ids), 12)
    got = segment_sum(torch.from_numpy(vals), seg)
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=12)
    _close(got, want, atol=1e-5)
    assert torch.equal(got, segment_sum(torch.from_numpy(vals), seg))
    empty = segment_sum(torch.from_numpy(vals), segments(torch.full((300,), 3), 5))
    assert float(empty[[0, 1, 2, 4]].abs().sum()) == 0.0


def test_ba_paths_not_ported_raise():
    """The dense Schur solve runs on one device (the JAX package's
    solve_step_dense takes no axis): with an axis_name it raises, before
    any collective."""
    K, params, obs, P, C = _vo_layout_problem()
    with pytest.raises(ValueError, match="one device"):
        tba.lm_iteration(ba_params_from_jax(params), ba_obs_from_jax(obs),
                         torch.from_numpy(np.array(K)), torch.tensor(1e-3),
                         torch.arange(C) > 0, n_points=P, axis_name="i",
                         cam_blocked=True, pt_onehot=True, dense_schur=True)


@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_ba.py::problem: 6 cameras, 120 points, noise 0.4 px, a
    perturbed start."""
    K, gt, obs, _ = make_problem(n_cams=6, n_points=120, noise_px=0.4, seed=0)
    start = perturb(gt, rot_deg=2.0, trans=0.12, point_sigma=0.08, seed=1, keep_fixed=(0,))
    return (jnp.asarray(K), jba.BAParams(*map(jnp.asarray, start)),
            jba.BAObs(*map(jnp.asarray, obs)), gt)


def _lm_pair(K, params, obs, C, **kw):
    free = jnp.arange(C) > 0
    want = jba.lm_iteration(params, obs, K, jnp.float32(1e-3), free, **kw)
    got = tba.lm_iteration(ba_params_from_jax(params), ba_obs_from_jax(obs),
                           torch.from_numpy(np.array(K)), torch.tensor(1e-3), torch.arange(C) > 0,
                           **kw)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    assert bool(got[3]) == bool(want[3])
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    return got, want


@pytest.mark.parametrize("cam_blocked,pt_onehot", [(False, False), (False, True), (True, False)])
def test_scatter_lm_iteration_matches_jax(cam_blocked, pt_onehot):
    """The scatter form (cam_blocked=False and/or pt_onehot=False, CG) on
    the VO-layout problem: cost rtol 1e-6, accept equal, parameters rtol
    5e-4 / atol 5e-5 (tests/test_ba.py's layout comparison)."""
    K, params, obs, P, C = _vo_layout_problem()
    got, want = _lm_pair(K, params, obs, C, huber_px=3.0, cg_iters=6, n_points=P,
                         cam_blocked=cam_blocked, pt_onehot=pt_onehot)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("pt_onehot", [False, True])
def test_scatter_lm_iteration_on_the_ba_problem(ba_problem, pt_onehot):
    """One LM step from tests/test_ba.py's perturbed start (cost 1.5e4, 30
    CG iterations): cost rtol 1e-6, accept and lam equal.  That step is
    ill-conditioned in f32: each package's lies 0.016-0.066 from the same
    step taken in float64, and 4e-4 from the other's (measured).  So the
    port's step is held to JAX's distance from the float64 step: no more
    than it plus 1e-3, entry by entry."""
    K, params, obs, _ = ba_problem
    C, P = params.Rs.shape[0], params.X.shape[0]
    kw = dict(huber_px=2.0, cg_iters=30, n_points=P, pt_onehot=pt_onehot)
    got, want = _lm_pair(K, params, obs, C, **kw)
    p64 = tba.BAParams(*(x.double() for x in ba_params_from_jax(params)))
    o = ba_obs_from_jax(obs)
    f64 = tba.lm_iteration(p64, tba.BAObs(o.uv.double(), o.cam, o.pt, o.w.double()),
                           torch.from_numpy(np.array(K)).double(),
                           torch.tensor(1e-3, dtype=torch.float64), torch.arange(C) > 0,
                           **dict(kw, pt_onehot=False))
    for a, b, c in zip(got[0], want[0], f64[0]):
        gap_port = np.abs(a.numpy() - c.numpy())
        gap_jax = np.abs(np.asarray(b) - c.numpy())
        assert (gap_port <= gap_jax + 1e-3).all(), (gap_port.max(), gap_jax.max())


def test_run_ba_matches_jax(ba_problem):
    """run_ba, 15 iterations from tests/test_ba.py's start, against the JAX
    run at that file's tolerances for two reduction orders of one solver:
    the first cost within rtol 1e-5, the last within 5 %; both converged
    (residual 0.8 px, ATE 0.02)."""
    K, params, obs, gt = ba_problem
    jparams, jcosts = jba.run_ba(params, obs, K, fixed_cams=(0,), iters=15)
    tparams, tcosts = tba.run_ba(params, obs, K, fixed_cams=(0,), iters=15, device="cpu")
    np.testing.assert_allclose(tcosts[0], jcosts[0], rtol=1e-5)
    assert abs(tcosts[-1] - jcosts[-1]) / jcosts[-1] < 0.05
    r = tba.residuals(tparams, ba_obs_from_jax(obs), torch.from_numpy(np.array(K))).numpy()
    assert float(np.sqrt((r ** 2).sum(1)).mean()) < 0.8
    ate = ate_rmse(camera_centers(tparams.Rs.numpy(), tparams.ts.numpy()),
                   camera_centers(gt.Rs, gt.ts))
    assert ate < 0.02
    _, last = tba.run_ba(params, obs, K, iters=15, fetch_costs=False, device="cpu")
    assert last == tcosts[-1:]


def test_checkpoints_load_across_packages(tmp_path, ba_problem):
    """A BA file written by the JAX package loads through the port (and
    back), with its extra arrays; a VO state likewise."""
    _, params, obs, _ = ba_problem
    jck.save_ba(tmp_path / "j.npz", params, cam=obs.cam)
    tparams, extra = tck.load_ba(tmp_path / "j.npz", device="cpu")
    for a, b in zip(tparams, params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(extra["cam"], np.asarray(obs.cam))
    tck.save_ba(tmp_path / "t.npz", tparams, cam=torch.from_numpy(extra["cam"]))
    back, extra = jck.load_ba(tmp_path / "t.npz")
    for a, b in zip(back, params):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(7)
    fields = {f: rng.normal(size=(2, 3)).astype(np.float32) for f in VOState._fields}
    fields["frame"] = np.int32(5)
    jck.save_vo(tmp_path / "vo.npz", JVOState(**{k: jnp.asarray(v) for k, v in fields.items()}))
    st = tck.load_vo(tmp_path / "vo.npz", device="cpu")
    assert isinstance(st, VOState) and int(st.frame) == 5
    tck.save_vo(tmp_path / "vo2.npz", st)
    back = jck.load_vo(tmp_path / "vo2.npz")
    for k, v in fields.items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), v)
