"""The reference library's API on a CUDA card (skipped without one):
``MatchPlan(metric="L2")`` on K7, the warp, RANSAC and ``LinearAlign``.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_align.py -q
"""

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import (LinearAlign, MatchPlan, SiftConfig, SiftPlan, affine_warp,
                                  ransac_affine)
from sift_pyocl_tpu_torch.ops.kernels import matchk, reset_launch_counts
from sift_pyocl_tpu_torch.utils.profiling import kernel_launches
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene, transformed_pair

pytestmark = pytest.mark.gpu
SMALL = SiftConfig(kp_per_octave_cap=256)
SHAPE = (256, 256)
INTERIOR = (slice(16, -16), slice(16, -16))
# CUDA launches a detection of K1 (six level launches), K2-K6, and K7's
FRONTEND_LAUNCHES = {"blur_level_kernel": 6, "small_octaves_kernel": 1, "compact_kernel": 1,
                     "refine_kernel": 1, "grad_kernel": 1, "orient_desc_kernel": 1,
                     "best2_l2_kernel": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_match_plan_l2_on_the_card_equals_the_cpu_with_one_k7_launch(cuda):
    a, b = transformed_pair(SHAPE, seed=1, dx=7, dy=-4)
    plan = SiftPlan(SHAPE, config=SMALL, device=cuda)
    kp1, kp2 = plan.keypoints(a), plan.keypoints(b)
    assert min(len(kp1), len(kp2)) > 50
    for kw in ({}, {"match_xradius": 12.0, "match_yradius": 12.0}):
        gpu = MatchPlan(metric="L2", device=cuda, **kw)
        cpu = MatchPlan(metric="L2", device="cpu", **kw)
        reset_launch_counts()
        got = gpu.match_index(kp1, kp2)
        assert matchk.best2_l2.launches == 1
        np.testing.assert_array_equal(got, cpu.match_index(kp1, kp2))
        assert len(got) > 30


def test_warp_on_the_card_equals_the_cpu(cuda):
    img = synthetic_scene(SHAPE, n_blobs=40, seed=3)
    th = np.deg2rad(2.0)
    for mat, off, fill in [(np.eye(2), np.array([3.0, -5.0]), 0.0),
                           (1.02 * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]),
                            np.array([2.5, -4.25]), 7.0)]:
        got = affine_warp(img, mat, off, fill, device=cuda)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        want = affine_warp(img, mat, off, fill, device="cpu")
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_ransac_affine_on_the_card_draws_as_the_cpu(cuda):
    rng = np.random.default_rng(2)
    p1 = rng.uniform(0, 300, (100, 2)).astype(np.float32)
    p2 = (p1 @ np.array([[0.98, 0.05], [-0.04, 1.02]]).T + [7.0, -3.0]).astype(np.float32)
    p2[:30] = rng.uniform(0, 300, (30, 2))
    valid = np.ones(100, bool)
    got = ransac_affine(0, p1, p2, valid, device=cuda)
    want = ransac_affine(0, p1, p2, valid, device="cpu")
    assert got.inliers.device.type == "cuda"
    assert torch.equal(got.inliers.cpu(), want.inliers)
    assert int(got.best_score) == int(want.best_score) >= 70
    assert int(got.n_inliers) == int(want.n_inliers) >= 70
    np.testing.assert_allclose(got.model.cpu().numpy(), want.model.numpy(), rtol=0, atol=1e-3)


def _orsa_residuals(la, img, out):
    """Squared residuals of orsa's returned matches under the fitted model."""
    kp = la.sift.keypoints(img)
    m = out["matches"]
    p_ref = np.stack([la.ref_kp["y"][m[:, 0]], la.ref_kp["x"][m[:, 0]]], 1)
    p_img = np.stack([kp["y"][m[:, 1]], kp["x"][m[:, 1]]], 1)
    return np.sum((p_ref @ np.asarray(out["matrix"]).T + out["offset"] - p_img) ** 2, axis=1)


def test_linear_align_on_the_card(cuda):
    """tests/test_align.py's outcome asserts at 256x256, with K1-K6 once
    per align call (read from the device's trace: the plan's detector is a
    replayed CUDA graph).  orsa's returned matches are the inliers of the RANSAC
    model, and the returned fit is their least squares refit: on this scene
    one of 46 lies 16 px^2 from the refit in the JAX package as in the
    port, so its test_align assert is held on test_align's own scene
    (test_linear_align_orsa_on_the_card)."""
    ref, img = transformed_pair(SHAPE, seed=2, dx=6, dy=-4)
    la = LinearAlign(ref, config=SMALL, device=cuda)
    out = la.align(img, return_all=True)
    # K1 is six level launches; the default metric is L1, so no K7
    counts = kernel_launches(lambda: la.align(img, return_all=True), FRONTEND_LAUNCHES)
    assert counts == FRONTEND_LAUNCHES, counts
    assert out is not None and len(out["matches"]) >= 5
    np.testing.assert_allclose(out["matrix"], np.eye(2), atol=0.02)
    np.testing.assert_allclose(out["offset"], [4.0, -6.0], atol=0.3)
    assert isinstance(out["result"], np.ndarray)
    assert np.median(np.abs(out["result"][INTERIOR] - ref[INTERIOR])) < 2.0

    sh = la.align(img, shift_only=True, double_check=True, return_all=True)
    np.testing.assert_allclose(sh["offset"], [4.0, -6.0], atol=0.3)

    o = la.align(img, orsa=True, return_all=True)
    assert 4 <= len(o["matches"]) <= len(out["matches"])
    np.testing.assert_allclose(o["matrix"], np.eye(2), atol=0.02)
    np.testing.assert_allclose(o["offset"], [4.0, -6.0], atol=0.6)


def test_linear_align_orsa_on_the_card(cuda):
    """tests/test_align.py::test_align_orsa_robust on the card."""
    ref, img = transformed_pair((128, 128), seed=7, dx=5, dy=3)
    la = LinearAlign(ref, config=SMALL, device=cuda)
    out = la.align(img, orsa=True, return_all=True)
    assert out is not None and len(out["matches"]) >= 4
    np.testing.assert_allclose(out["matrix"], np.eye(2), atol=0.02)
    np.testing.assert_allclose(out["offset"], [-3.0, -5.0], atol=0.6)
    assert np.all(_orsa_residuals(la, img, out) < 9.0 + 1e-3)
