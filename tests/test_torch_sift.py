"""The slice end to end: the port's SiftPlan.keypoints under SLICE_CONFIG
(the kernel wrappers take their plain versions on the CPU) against the JAX
package's detect_and_describe with the same config, its Pallas kernels in
interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.models import sift as jsift
from sift_pyocl_tpu.oracle import KP_DTYPE as J_KP_DTYPE

from sift_pyocl_tpu_torch import SLICE_CONFIG, KP_DTYPE, SiftConfig, SiftPlan
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

from conftest import match_keypoint_sets

CFG = dataclasses.replace(SLICE_CONFIG, kp_per_octave_cap=256)


def _jax_keypoints(img):
    cfg = JaxConfig(**{**dataclasses.asdict(CFG), "pallas_interpret": True})
    buf = jsift.detect_and_describe(jnp.asarray(img), cfg)
    m = np.asarray(buf.valid)
    out = np.zeros(int(m.sum()), dtype=J_KP_DTYPE)
    for f in ("x", "y", "scale", "angle", "desc"):
        out[f] = np.asarray(getattr(buf, f))[m]
    return out, np.asarray(buf.counts)


@pytest.mark.parametrize("scene", ["scene128", "scene160"])
def test_slice_matches_jax(scene, request):
    """Counts equal, every JAX keypoint matched (x/y 0.1 px, scale 0.05,
    angle 0.05 rad) and mean u8 descriptor L1 < 0.01: tighter than the
    issue's max(2, 2%) / 98% / 0.1 because the port comes out that close
    (same refinement arithmetic; histogram sums differ only in order)."""
    img = request.getfixturevalue(scene)
    want, want_counts = _jax_keypoints(img)
    plan = SiftPlan(img.shape, config=CFG, device="cpu")
    reset_launch_counts()
    got = plan.keypoints(img)
    assert sum(launch_counts().values()) == 0    # CPU tensors: plain versions only
    assert got.dtype == KP_DTYPE and len(want) > 10
    assert len(got) == len(want)
    hits, desc_l1 = match_keypoint_sets(want, got)
    assert hits == len(want)
    assert desc_l1 < 0.01
    np.testing.assert_array_equal(plan.keypoints_raw(img).counts.numpy(), want_counts)


@pytest.mark.parametrize("shape,kw", [
    ((1080, 1920), {}),
    ((1080, 1920), {"kp_per_octave_cap": 256, "pix_per_kp": 4}),
    ((333, 517), {"double_im_size": True}),
])
def test_octave_capacities_match_jax(shape, kw):
    assert tsift.octave_capacities(shape, SiftConfig(**kw)) == \
        jsift.octave_capacities(shape, JaxConfig(**kw))


@pytest.mark.parametrize("kw,match", [
    ({"kp_backend": "xla"}, "kp_backend"),
    ({"kp_multi_launch": False}, "kp_multi_launch"),
    ({"desc_buckets": 2}, "desc_buckets"),
])
def test_paths_not_ported_yet_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        SiftPlan((64, 64), config=SiftConfig(**kw), device="cpu")


def test_plan_api(scene128):
    plan = SiftPlan(template=scene128, config=CFG, device="cpu", PIX_PER_KP=8)
    assert plan.cfg.pix_per_kp == 8 and plan.shape == (128, 128)
    assert plan.device == torch.device("cpu")
    assert 0 < plan.calc_memory() < 64 << 20
    with pytest.raises(MemoryError):
        plan._check_memory(limit_bytes=1 << 20)
    with pytest.raises(ValueError, match="shape"):
        plan.keypoints(np.zeros((64, 64), np.float32))
    buf = plan.keypoints_raw(torch.from_numpy(scene128))
    n_slots = sum(c for c, _ in tsift.octave_capacities((128, 128), plan.cfg)) * CFG.max_ori
    assert buf.desc.shape == (n_slots, 128) and buf.desc.dtype == torch.uint8
    assert buf.x.shape == buf.valid.shape == (n_slots,)
    assert int(buf.counts[:, 1].sum()) == int(buf.valid.sum())
    assert tsift._detector(plan.cfg) is plan._fn    # one detector per config
