"""BASELINE config 2 (pairwise matching with a RANSAC homography,
tools/bench_configs.py's config2_pairwise step) through the port against
the JAX package on the CPU, at a reference-suite size: 256x256 crops of
synthetic_scene, kp_per_octave_cap=256.

The JAX step detects both frames, ratio-matches them (L2, 0.5329^2) and
fits RANSAC-H.  On the same keypoint buffers (JAX's, converted) the port's
match gives the same keep, idx2 and distances bit for bit; fed the RANSAC
rows JAX draws, its homography has JAX's inliers and its model within the
RANSAC tests' tolerance.  The pairs: a crop and its vertical flip (the
tool's pair) and a crop and the crop moved by (3, -5) px (known geometry).
The port's own detection of the frames is held to JAX's keypoints, and its
whole step (its own detection, JAX's rows) recovers the translation.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_pyocl_tpu.config as jcfg
from sift_pyocl_tpu.models.sift import detect_and_describe as j_detect
from sift_pyocl_tpu.ops.match import match_descriptors_dense as j_match

from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe
from sift_pyocl_tpu_torch.models.sift import to_keypoint_records
from sift_pyocl_tpu_torch.utils.convert import keypoint_buffer_from_jax
from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets, synthetic_scene

import chip_smoke
from _torch_threads import _one_torch_thread  # noqa: F401

jr = importlib.import_module("sift_pyocl_tpu.sfm.ransac")

CFG = SiftConfig(kp_per_octave_cap=256)
JCFG = jcfg.SiftConfig(kp_per_octave_cap=256)
RATIO_SQ = 0.5329 ** 2          # tools/bench_configs.py's
SHIFT = (3, -5)                 # (dy, dx) of the second crop


@pytest.fixture(scope="module")
def pairs():
    """{name: (frame 1, frame 2, JAX buffer 1, JAX buffer 2)} for the flip
    and the shift pair (three distinct 256x256 frames, one JAX compile)."""
    base = synthetic_scene((288, 288), n_blobs=80, seed=0)
    c = np.ascontiguousarray(base[16:272, 16:272])
    dy, dx = SHIFT
    moved = np.ascontiguousarray(base[16 + dy:272 + dy, 16 + dx:272 + dx])
    flip = np.ascontiguousarray(c[::-1])
    det = jax.jit(lambda f: j_detect(f, JCFG))
    bufs = {k: det(jnp.asarray(v)) for k, v in (("c", c), ("flip", flip), ("moved", moved))}
    return {"flip": (c, flip, bufs["c"], bufs["flip"]),
            "shift": (moved, c, bufs["moved"], bufs["c"])}


def _jax_step(b1, b2, key):
    keep, mid, d, d2 = j_match(b1.desc, b1.valid, b2.desc, b2.valid, metric="L2",
                               ratio_sq=RATIO_SQ)
    uv1 = jnp.stack([b1.x, b1.y], -1)
    uv2 = jnp.stack([b2.x, b2.y], -1)[mid]
    return keep, mid, d, d2, jr.ransac_homography(key, uv1, uv2, keep)


@pytest.mark.parametrize("name", ["flip", "shift"])
def test_config2_match_and_homography_match_jax(pairs, name):
    _, _, jb1, jb2 = pairs[name]
    key = jax.random.key(3)
    keep, mid, d, d2, want = _jax_step(jb1, jb2, key)
    rows = np.asarray(jr._sample_weights(key, keep, 256, 4))
    got = chip_smoke.config2_match_fit(keypoint_buffer_from_jax(jb1), keypoint_buffer_from_jax(jb2),
                                       0, weights=torch.from_numpy(rows.copy()))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(keep))
    for g, w in zip(got[1:4], (mid, d, d2)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    res = got[4]
    assert int(res.n_inliers) == int(want.n_inliers)
    assert int(res.best_score) == int(want.best_score)
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(want.inliers))
    if name == "shift":
        # the flip pair's few chance inliers leave its fit degenerate (no
        # unique H), so only this pair's model is compared
        np.testing.assert_allclose(res.model.numpy(), np.asarray(want.model), rtol=1e-4,
                                   atol=1e-6)
        assert int(keep.sum()) >= 30 and int(res.n_inliers) >= 30
        assert chip_smoke.corner_error(res.model.numpy(), (256, 256), *SHIFT) < 0.5


@pytest.mark.parametrize("name", ["flip", "shift"])
def test_config2_port_step_matches_jax(pairs, name):
    """The port's detection of each frame against JAX's (counts within 2 %,
    every keypoint matched at 0.1 px, mean u8 descriptor L1 < 0.1); its
    whole step from its own buffers, with the rows JAX draws for its own
    step, keeps the ratio-match count within 5 % of JAX's, and on the
    shift pair fits the translation within 0.5 px at the corners."""
    f1, f2, jb1, jb2 = pairs[name]
    b1, b2 = (detect_and_describe(torch.from_numpy(f), CFG) for f in (f1, f2))
    for b, jb in ((b1, jb1), (b2, jb2)):
        m = np.asarray(jb.valid)
        ref = np.zeros(int(m.sum()), dtype=to_keypoint_records(b).dtype)
        for f in ("x", "y", "scale", "angle", "desc"):
            ref[f] = np.asarray(getattr(jb, f))[m]
        kp = to_keypoint_records(b)
        hits, l1 = match_keypoint_sets(ref, kp)
        assert abs(len(kp) - len(ref)) <= max(2, len(ref) // 50)
        assert hits >= 0.98 * len(ref) and l1 < 0.1, (hits, len(ref), l1)
    key = jax.random.key(3)
    keep_j, *_ = _jax_step(jb1, jb2, key)
    got = chip_smoke.config2_match_fit(b1, b2, 0)
    n, n_j = int(got[0].sum()), int(keep_j.sum())
    assert abs(n - n_j) <= max(2, n_j // 20), (n, n_j)
    if name == "shift":
        rows = np.asarray(jr._sample_weights(key, jnp.asarray(got[0].numpy()), 256, 4))
        res = chip_smoke.config2_match_fit(b1, b2, 0, weights=torch.from_numpy(rows.copy()))[4]
        assert int(res.n_inliers) >= 30
        assert chip_smoke.corner_error(res.model.numpy(), (256, 256), *SHIFT) < 0.5
