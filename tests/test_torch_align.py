"""The reference library's API in the port (``MatchPlan``, ``LinearAlign``,
``fit_affine``, the affine warp, affine RANSAC, ``par``, ``SiftPlan.compile``
and ``log_profile``) against the JAX package on the CPU.

Tolerances:
* the warp is bit-equal to ``affine_warp_jax`` at the identity and at integer
  offsets; elsewhere within 1e-2 abs on [0, 255] images, the reference
  suite's own warp check (``tests/test_transform.py``): XLA may contract
  ``m*r + m*c + off`` and the interpolation sums into FMAs, and one ulp of a
  source coordinate at a floor boundary moves a pixel by up to ~3e-3;
* ``fit_affine`` within 1e-12 (both are NumPy f64);
* ``ransac_affine`` fed the rows JAX drew: inliers, n_inliers and
  best_score equal, the model within 1e-4 abs on M and 1e-3 abs on t (f32
  normal equations; two LU solves in other libraries);
* ``MatchPlan`` indices and ``LinearAlign`` matches, matrix and offset
  exactly, given the same keypoint records.
"""

import ast
import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_pyocl_tpu as jpkg
from sift_pyocl_tpu import LinearAlign as JLinearAlign
from sift_pyocl_tpu import MatchPlan as JMatchPlan
from sift_pyocl_tpu import config as jcfg
from sift_pyocl_tpu.models.match_align import fit_affine as j_fit_affine
from sift_pyocl_tpu.ops.transform import affine_warp_jax
from sift_pyocl_tpu.utils.testimage import synthetic_scene, transformed_pair

import sift_pyocl_tpu_torch as port
from sift_pyocl_tpu_torch import (KP_DTYPE, LinearAlign, MatchPlan, SiftConfig, SiftPlan,
                                  affine_warp, config_from_par, fit_affine, ransac_affine)
from sift_pyocl_tpu_torch.config import from_jax_config

jr = importlib.import_module("sift_pyocl_tpu.sfm.ransac")
tr = importlib.import_module("sift_pyocl_tpu_torch.sfm.ransac")

SMALL = SiftConfig(kp_per_octave_cap=256)
INTERIOR = (slice(16, -16), slice(16, -16))
WARP_ATOL = 1e-2


def _jwarp(img, mat, off, fill=0.0):
    return np.asarray(affine_warp_jax(jnp.asarray(img), jnp.asarray(mat), jnp.asarray(off), fill))


# --- the warp ---------------------------------------------------------------

@pytest.mark.parametrize("off,fill", [((0.0, 0.0), 0.0), ((3.0, -5.0), 0.0),
                                      ((-7.0, 2.0), 7.0), ((40.0, 100.0), 7.0)])
def test_warp_is_bit_equal_at_identity_and_integer_offsets(scene128, off, fill):
    want = _jwarp(scene128, np.eye(2), np.array(off), fill)
    got = affine_warp(scene128, np.eye(2), np.array(off), fill, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def _rotation(deg, zoom=1.0):
    th = np.deg2rad(deg)
    return zoom * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])


@pytest.mark.parametrize("case", ["oracle", "rot90x70", "zoom_tilt"])
def test_warp_matches_jax(scene128, case):
    if case == "oracle":            # tests/test_transform.py::test_warp_vs_oracle
        img, mat, off, fill = scene128, np.array([[0.98, 0.05], [-0.04, 1.01]]), \
            np.array([2.5, -1.25]), 7.0
    elif case == "rot90x70":        # non-square, rotated
        img, mat, off, fill = synthetic_scene((90, 70), n_blobs=7, seed=5), _rotation(17.0), \
            np.array([4.0, -3.0]), 0.0
    else:                           # the battery's zoom and tilt, f32 arguments
        img = scene128
        mat = (_rotation(20.0, 0.5) @ np.diag([1.0, 1 / 1.4])).astype(np.float32)
        off, fill = np.array([31.7, 12.25], np.float32), 0.0
    want = _jwarp(img, mat, off, fill)
    got = affine_warp(torch.from_numpy(img), mat, off, fill).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)
    # outside the source the fill, inside a bilinear mix: the same pixels
    np.testing.assert_array_equal(got == fill, want == fill)


def test_warp_alias_and_tensor_inputs_stay_on_their_device(scene128):
    assert port.affine_warp_jax is affine_warp
    x = torch.from_numpy(scene128)
    out = affine_warp(x, torch.eye(2, dtype=torch.float64), torch.tensor([1.0, 2.0]))
    assert out.device == x.device
    np.testing.assert_array_equal(out.numpy(), _jwarp(scene128, np.eye(2), np.array([1.0, 2.0])))


def test_entry_points_raise_without_a_card_unless_given_the_cpu(monkeypatch, scene128):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((5, 2), np.float32)
    for call in (lambda: affine_warp(scene128, np.eye(2), np.zeros(2)),
                 lambda: ransac_affine(0, pts, pts, np.ones(5, bool)),
                 lambda: MatchPlan(),
                 lambda: LinearAlign(scene128, config=SMALL),
                 lambda: SiftPlan(scene128.shape)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert affine_warp(scene128, np.eye(2), np.zeros(2), device="cpu").device.type == "cpu"
    assert MatchPlan(device="cpu").device.type == "cpu"


# --- fit_affine and RANSAC --------------------------------------------------

@pytest.mark.parametrize("n,seed", [(3, 0), (40, 1)])
def test_fit_affine_matches_jax(n, seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 500, (n, 2))
    dst = src @ np.array([[1.01, 0.02], [-0.03, 0.99]]).T + [3.0, -2.0] + rng.normal(0, 0.3, (n, 2))
    for got, want in zip(fit_affine(dst, src), j_fit_affine(dst, src)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _affine_problem(n, n_out, seed, noise=0.2):
    rng = np.random.default_rng(seed)
    M = np.array([[0.98, 0.05], [-0.04, 1.02]])
    t = np.array([7.0, -3.0])
    p1 = rng.uniform(0, 300, (n, 2))
    p2 = p1 @ M.T + t + (rng.normal(0, noise, (n, 2)) if noise else 0.0)
    out = rng.choice(n, n_out, replace=False)
    p2[out] = rng.uniform(0, 300, (n_out, 2))
    gt = np.ones(n, bool)
    gt[out] = False
    return p1.astype(np.float32), p2.astype(np.float32), gt, M, t


@pytest.mark.parametrize("case", ["outliers30", "all_ties", "some_invalid"])
def test_ransac_affine_with_jax_draws_matches_jax(case):
    """Fed the (n_hypo, N) rows ``_sample_weights(PRNGKey(seed), ...)``
    drew: the same winner (the first of equal scores: in all_ties every
    hypothesis scores N), inliers and scores equal, the model within f32
    tolerance."""
    n = 60
    if case == "all_ties":
        p1, p2, _, _, _ = _affine_problem(n, 0, 4, noise=0.0)
    else:
        p1, p2, _, _, _ = _affine_problem(n, 18, 3)
    valid = np.ones(n, bool)
    if case == "some_invalid":
        valid[::7] = False
    key = jax.random.PRNGKey(5)
    rows = np.asarray(jr._sample_weights(key, jnp.asarray(valid), 256, 3))
    want = jr.ransac_affine(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    got = ransac_affine(5, p1, p2, valid, weights=rows, device="cpu")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    assert int(got.best_score) == int(want.best_score)
    assert got.n_inliers.dtype == torch.int32 and got.best_score.dtype == torch.int32
    m_got, m_want = got.model.numpy(), np.asarray(want.model)
    np.testing.assert_allclose(m_got[:, :2], m_want[:, :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(m_got[:, 2], m_want[:, 2], rtol=0, atol=1e-3)
    if case == "all_ties":
        assert int(got.best_score) == n and got.inliers.all()


def test_ransac_affine_own_draws_recovers_the_model():
    """tests/test_ransac.py::test_ransac_affine_with_outliers's scene and
    asserts, with the port's own draws."""
    rng = np.random.default_rng(2)
    M_gt = np.array([[0.98, 0.05], [-0.04, 1.02]])
    t_gt = np.array([7.0, -3.0])
    p1 = rng.uniform(0, 300, (100, 2))
    p2 = p1 @ M_gt.T + t_gt + rng.normal(0, 0.2, (100, 2))
    out_idx = rng.choice(100, 30, replace=False)
    p2[out_idx] = rng.uniform(0, 300, (30, 2))
    gt_in = np.ones(100, bool)
    gt_in[out_idx] = False
    res = ransac_affine(0, torch.tensor(p1, dtype=torch.float32),
                        torch.tensor(p2, dtype=torch.float32), torch.ones(100, dtype=torch.bool))
    got_in = res.inliers.numpy()
    assert (got_in & gt_in).sum() >= 0.97 * gt_in.sum()
    assert (got_in & ~gt_in).sum() <= 2
    model = res.model.numpy()
    assert np.allclose(model[:, :2], M_gt, atol=0.02)
    assert np.allclose(model[:, 2], t_gt, atol=1.0)


def test_sample_weights_draw_distinct_valid_indices_per_seed():
    valid = torch.ones(50, dtype=torch.bool)
    valid[::3] = False
    w = tr._sample_weights(7, valid, 64, 3)
    assert w.shape == (64, 50) and w.dtype == torch.float32
    assert torch.equal(w.sum(1), torch.full((64,), 3.0))
    assert not w[:, ~valid].any()
    assert torch.equal(w, tr._sample_weights(7, valid, 64, 3))
    assert not torch.equal(w, tr._sample_weights(8, valid, 64, 3))


def test_normalize_points_matches_jax():
    geo = importlib.import_module("sift_pyocl_tpu.sfm.geometry")
    from sift_pyocl_tpu_torch.sfm.geometry import _normalize_points

    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 400, (30, 2)).astype(np.float32)
    w = (rng.uniform(size=(4, 30)) < 0.5).astype(np.float32)
    pn, T = _normalize_points(torch.from_numpy(pts), torch.from_numpy(w))
    for i in range(4):
        jpn, jT = geo._normalize_points(jnp.asarray(pts), jnp.asarray(w[i]))
        np.testing.assert_allclose(pn[i].numpy(), np.asarray(jpn), rtol=0, atol=1e-5)
        np.testing.assert_allclose(T[i].numpy(), np.asarray(jT), rtol=1e-6, atol=1e-4)


# --- MatchPlan --------------------------------------------------------------

def _records(n1, n2, seed):
    """KP_DTYPE records: set 2 a noisy permutation of set 1 plus strangers,
    positions near each other, so the ratio test and the radius gate both
    keep and drop pairs."""
    rng = np.random.default_rng(seed)
    a = np.zeros(n1, KP_DTYPE)
    a["x"], a["y"] = rng.uniform(0, 120, n1), rng.uniform(0, 100, n1)
    a["scale"], a["angle"] = rng.uniform(1, 4, n1), rng.uniform(-3, 3, n1)
    a["desc"] = rng.integers(0, 256, (n1, 128))
    b = np.zeros(n2, KP_DTYPE)
    k = min(n1, n2) * 3 // 4
    perm = rng.permutation(n1)[:k]
    b[:k] = a[perm]
    b["x"][:k] += rng.normal(0, 4, k)
    b["y"][:k] += rng.normal(0, 4, k)
    noisy = b["desc"][:k].astype(int) + rng.integers(-40, 41, (k, 128))
    b["desc"][:k] = np.clip(noisy, 0, 255)
    b["desc"][k:] = rng.integers(0, 256, (n2 - k, 128))
    b["x"][k:], b["y"][k:] = rng.uniform(0, 120, n2 - k), rng.uniform(0, 100, n2 - k)
    return a, b


MATCH_CASES = {
    "plain": {},
    "roi": {"roi": True},
    "radius": {"match_xradius": 6.0, "match_yradius": 9.0},
    "xradius_only": {"match_xradius": 5.0},
    "past_size": {"size": 64},
    "ratio": {"ratio_th": 0.8},
}


@pytest.mark.parametrize("metric", ["L1", "L2"])
@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_match_plan_matches_jax(metric, case):
    kw = dict(MATCH_CASES[case])
    roi = kw.pop("roi", None)
    a, b = _records(150, 170, 3)
    jp = JMatchPlan(metric=metric, **kw)
    tp = MatchPlan(metric=metric, device="cpu", **kw)
    if roi:
        mask = np.zeros((100, 120), np.uint8)
        mask[20:80, 10:70] = 1
        jp.set_roi(mask)
        tp.set_roi(mask)
    want = jp.match_index(a, b)
    got = tp.match_index(a, b)
    assert got.dtype == np.int32 and got.shape[1] == 2
    np.testing.assert_array_equal(got, want)
    assert 10 < len(got) < 150
    recs = tp.match(a, b)
    np.testing.assert_array_equal(recs, jp.match(a, b))
    np.testing.assert_array_equal(tp(a, b), recs)
    if roi:
        tp.unset_roi()
        jp.unset_roi()
        np.testing.assert_array_equal(tp.match_index(a, b), jp.match_index(a, b))
        assert len(tp.match_index(a, b)) > len(got)


@pytest.mark.parametrize("n1,n2", [(0, 5), (5, 0), (0, 0)])
def test_match_plan_empty_inputs(n1, n2):
    a, b = np.zeros(n1, KP_DTYPE), np.zeros(n2, KP_DTYPE)
    got = MatchPlan(device="cpu").match(a, b)
    assert got.shape == JMatchPlan().match(a, b).shape == (0, 2)
    assert MatchPlan(device="cpu").match_index(a, b).shape == (0, 2)


# --- LinearAlign ------------------------------------------------------------

def _frames(scenario):
    """(ref, [frames], config, align kwargs) of the four tests/test_align.py
    scenarios."""
    small = jcfg.SiftConfig(kp_per_octave_cap=256)
    if scenario == "plain":
        ref, img = transformed_pair((128, 128), seed=2, dx=6, dy=-4)
        return ref, [img], small, {}
    if scenario == "shift_only":
        ref, img = transformed_pair((128, 128), seed=4, dx=3, dy=2)
        return ref, [img], small, {"shift_only": True}
    if scenario == "orsa":
        ref, img = transformed_pair((128, 128), seed=7, dx=5, dy=3)
        return ref, [img], small, {"orsa": True}
    base = synthetic_scene((220, 220), n_blobs=35, seed=5)
    ref, f1, f2 = base[10:170, 10:170], base[10:170, 14:174], base[10:170, 18:178]
    if scenario == "double_check":
        return ref, [f1], None, {"shift_only": True, "double_check": True}
    return ref, [f1, f2], None, {"shift_only": True, "relative": True}


@pytest.fixture(scope="module")
def jax_runs():
    """Per scenario: the JAX LinearAlign's records (reference and frames)
    and its align outputs."""
    out = {}
    for scenario in ("plain", "shift_only", "orsa", "double_check", "relative"):
        ref, frames, cfg, kw = _frames(scenario)
        la = JLinearAlign(ref, config=cfg)
        ref_kp = la.ref_kp
        kps = [la.sift.keypoints(f) for f in frames]
        results = [la.align(f, return_all=True, **kw) for f in frames]
        out[scenario] = (ref_kp, kps, results)
    return out


@pytest.mark.parametrize("scenario", ["plain", "shift_only", "orsa", "double_check", "relative"])
def test_linear_align_matches_jax_given_its_keypoints(jax_runs, monkeypatch, scenario):
    ref, frames, cfg, kw = _frames(scenario)
    ref_kp, kps, want = jax_runs[scenario]
    la = LinearAlign(ref, config=None if cfg is None else from_jax_config(cfg), device="cpu")
    la.ref_kp = ref_kp
    feed = iter(kps)
    la.sift.keypoints = lambda img: next(feed)
    if kw.get("orsa"):
        # the rows JAX drew for this seed and match count
        monkeypatch.setattr(tr, "_sample_weights", lambda seed, valid, n_hypo, k: torch.from_numpy(
            np.array(jr._sample_weights(jax.random.PRNGKey(seed),
                                          jnp.ones(valid.shape[0], bool), n_hypo, k))))
    for frame, w in zip(frames, want):
        got = la.align(frame, return_all=True, **kw)
        np.testing.assert_array_equal(got["matches"], w["matches"])
        np.testing.assert_array_equal(got["matrix"], w["matrix"])
        np.testing.assert_array_equal(got["offset"], w["offset"])
        assert got["result"].dtype == np.float32 and isinstance(got["result"], np.ndarray)
        np.testing.assert_allclose(got["result"], w["result"], rtol=0, atol=WARP_ATOL)
    if kw.get("relative"):
        assert la.ref_kp is kps[-1]


def _port_align(scenario):
    ref, frames, cfg, kw = _frames(scenario)
    la = LinearAlign(ref, config=None if cfg is None else from_jax_config(cfg), device="cpu")
    return la, ref, frames, [la.align(f, return_all=True, **kw) for f in frames]


def test_port_align_recovers_translation():
    _, ref, _, (out,) = _port_align("plain")
    assert out is not None and len(out["matches"]) >= 5
    np.testing.assert_allclose(out["matrix"], np.eye(2), atol=0.02)
    np.testing.assert_allclose(out["offset"], [4.0, -6.0], atol=0.3)
    assert np.median(np.abs(out["result"][INTERIOR] - ref[INTERIOR])) < 2.0


def test_port_align_shift_only():
    _, ref, _, (out,) = _port_align("shift_only")
    assert out is not None
    np.testing.assert_allclose(out["offset"], [-2.0, -3.0], atol=0.3)
    assert np.median(np.abs(out["result"][INTERIOR] - ref[INTERIOR])) < 2.0


def test_port_align_double_check_and_relative():
    _, _, _, (out,) = _port_align("double_check")
    assert out is not None
    assert abs(out["offset"][1] + 4.0) < 0.5
    _, _, _, (o1, o2) = _port_align("relative")
    assert abs(o1["offset"][1] + 4.0) < 0.5
    assert abs(o2["offset"][1] + 8.0) < 0.8


def test_port_align_orsa_robust():
    la, _, (img,), (out,) = _port_align("orsa")
    assert out is not None and len(out["matches"]) >= 4
    np.testing.assert_allclose(out["matrix"], np.eye(2), atol=0.02)
    np.testing.assert_allclose(out["offset"], [-3.0, -5.0], atol=0.6)
    p_ref = np.stack([la.ref_kp["y"][out["matches"][:, 0]],
                      la.ref_kp["x"][out["matches"][:, 0]]], axis=1)
    kp = la.sift.keypoints(img)
    p_img = np.stack([kp["y"][out["matches"][:, 1]], kp["x"][out["matches"][:, 1]]], axis=1)
    resid = p_ref @ np.asarray(out["matrix"]).T + out["offset"] - p_img
    assert np.all(np.sum(resid**2, axis=1) < 9.0 + 1e-3)


def test_align_returns_none_with_too_few_matches():
    ref = synthetic_scene((128, 128), n_blobs=15, seed=0)
    la = LinearAlign(ref, config=SMALL, device="cpu")
    assert la.align(np.zeros_like(ref)) is None
    assert la.align(np.zeros_like(ref), shift_only=True, return_all=True) is None


# --- par, SiftPlan.compile / log_profile, exports ---------------------------

@pytest.mark.parametrize("p,overrides", [
    (None, {}),
    ({"Scales": 4, "EdgeThresh": 0.1, "DoubleImSize": 1}, {}),
    ({"InitSigma": 1.8, "Unknown": 3}, {"kp_per_octave_cap": 512}),
])
def test_par_and_config_from_par_match_jax(p, overrides):
    assert port.par == jpkg.par
    from sift_pyocl_tpu_torch.config import DEFAULT_CONFIG

    assert dataclasses.asdict(DEFAULT_CONFIG) == dataclasses.asdict(jcfg.DEFAULT_CONFIG)
    got = config_from_par(p, **overrides)
    assert isinstance(got, SiftConfig)
    assert got == from_jax_config(jpkg.config_from_par(p, **overrides))


def test_sift_plan_compile_and_log_profile_on_the_cpu(scene128):
    plan = SiftPlan(scene128.shape, config=SMALL, device="cpu")
    assert plan.compile() is plan
    kp = plan.keypoints(scene128)
    assert len(kp) > 10
    prof = plan.log_profile()
    assert {"upload", "pyramid", "K3 compact", "K6 orient_desc"} <= set(prof)
    assert all(np.isfinite(v) and v >= 0 for v in prof.values())


def _jax_exports():
    tree = ast.parse(Path(jpkg.__file__).read_text())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            and node.level == 1 for a in node.names}


def test_exports_are_a_superset_of_the_jax_package():
    want = _jax_exports()
    assert {"SiftPlan", "MatchPlan", "LinearAlign", "par", "config_from_par"} <= want
    missing = {n for n in want if not hasattr(port, n)}
    assert not missing, missing
    assert "affine_warp_jax" in dir(port) and "ransac_affine" in dir(port)
