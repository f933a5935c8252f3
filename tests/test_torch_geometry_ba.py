"""Geometry, PnP and the windowed BA iteration: the port's ``sfm`` modules
against the JAX package's on the JAX suite's own scenes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.sfm import ba as jba
from sift_pyocl_tpu.sfm import geometry as jg
from sift_pyocl_tpu.sfm.pnp import pnp_refine as j_pnp_refine

from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm import geometry as tg
from sift_pyocl_tpu_torch.sfm.pnp import pnp_refine
from sift_pyocl_tpu_torch.utils.convert import ba_obs_from_jax, ba_params_from_jax

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
    _close(tba._seg_pt(vals, G), jba._seg_pt(jnp.asarray(vals.numpy()), obs.pt, P, None), atol=1e-5)
    _close(tba._seg_cam(vals, C), jba._seg_cam(jnp.asarray(vals.numpy()), obs.cam, C, True), atol=1e-5)


@pytest.mark.parametrize("kw", [{"cam_blocked": False}, {"pt_onehot": False}, {"axis_name": "i"}])
def test_ba_paths_not_ported_raise(kw):
    K, params, obs, P, C = _vo_layout_problem()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tba.lm_iteration(ba_params_from_jax(params), ba_obs_from_jax(obs),
                         torch.from_numpy(np.array(K)), torch.tensor(1e-3),
                         torch.arange(C) > 0, n_points=P, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tba.run_ba(params, obs, K)
