"""The frontend end to end: the port's SiftPlan.keypoints under SLICE_CONFIG,
under the kernel configurations K8 (mask_backend="pallas"), per-octave
launches (kp_multi_launch=False), bucketed K6 (desc_buckets=2), the
per-level K9 pyramid (scales=2) and the fused masks (mask_backend="fused"),
and on the plain path kp_backend="xla" --
the kernel wrappers take their plain versions on the CPU -- against the JAX
package's detect_and_describe with the same config, its Pallas kernels in
interpret mode."""

import dataclasses
import inspect

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
from _torch_threads import _one_torch_thread  # noqa: F401

CFG = dataclasses.replace(SLICE_CONFIG, kp_per_octave_cap=256)


def _jax_keypoints(img, cfg=CFG):
    cfg = JaxConfig(**{**dataclasses.asdict(cfg), "pallas_interpret": True})
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


@pytest.mark.parametrize("kw", [{"kp_multi_launch": False}, {"mask_backend": "pallas"},
                                {"desc_buckets": 2}, {"scales": 2, "conv_backend": "auto"}],
                         ids=["per_octave", "mask_k8", "buckets", "scales2_k9"])
def test_kernel_configurations_match_jax(kw, scene160, monkeypatch):
    """Each kernel configuration end to end on scene160, held as the default
    is above.  desc_buckets=2 must make its two K6 calls at this config.
    scales=2 takes the per-level K9 octave 0 here; on the JAX side "auto"
    is its XLA pyramid on the CPU, since its small-octaves ladder is wrong
    at scales=2 (tests/test_torch_conv.py)."""
    cfg = dataclasses.replace(CFG, **kw)
    want, want_counts = _jax_keypoints(scene160, cfg)
    calls = []
    fused = tsift.orient_desc_fused
    monkeypatch.setattr(tsift, "orient_desc_fused",
                        lambda *a, **k: calls.append(a[7]) or fused(*a, **k))
    plan = SiftPlan(scene160.shape, config=cfg, device="cpu")
    reset_launch_counts()
    got = plan.keypoints(scene160)
    assert sum(launch_counts().values()) == 0
    if "desc_buckets" in kw:
        win_s, _ = tsift._desc_buckets(cfg)
        assert calls == [win_s, tsift._desc_window_size(cfg)] and win_s < calls[1]
    assert len(got) == len(want) > 10
    hits, desc_l1 = match_keypoint_sets(want, got)
    assert hits == len(want)
    assert desc_l1 < 0.01
    np.testing.assert_array_equal(plan.keypoints_raw(scene160).counts.numpy(), want_counts)


@pytest.mark.parametrize("scene", ["scene128", "scene160"])
def test_per_octave_path_equals_multi_launch(scene, request):
    """kp_multi_launch=False (K10a, K10b and one K6 call an octave over the
    plain gradients) gives the multi-launch buffer with grad_backend="xla"
    bit for bit, every field and every slot."""
    img = torch.from_numpy(request.getfixturevalue(scene))
    a = tsift.detect_and_describe(img, dataclasses.replace(CFG, kp_multi_launch=False))
    b = tsift.detect_and_describe(img, dataclasses.replace(CFG, grad_backend="xla"))
    assert int(a.valid.sum()) > 10
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("shape,kw", [
    ((1080, 1920), {}),
    ((1080, 1920), {"kp_per_octave_cap": 256, "pix_per_kp": 4}),
    ((333, 517), {"double_im_size": True}),
])
def test_octave_capacities_match_jax(shape, kw):
    assert tsift.octave_capacities(shape, SiftConfig(**kw)) == \
        jsift.octave_capacities(shape, JaxConfig(**kw))


@pytest.mark.parametrize("kw,match", [
    ({"kp_backend": "xla", "mask_backend": "fused"}, "mask_cfg"),
    ({"mask_backend": "fused"}, "mask_cfg"),
    ({"mask_backend": "fused", "conv_backend": "xla"}, "mask_cfg"),
])
def test_paths_not_ported_yet_raise(kw, match, scene128):
    """Every mask_backend="fused" configuration, once the last to raise, now
    runs: the ladder wrappers take `match` (mask_cfg), and SiftPlan on
    scene128 matches the JAX package with the same config, held as the
    kernel configurations are above.  On the CPU the JAX package's "auto"
    pyramid is its XLA one, which fuses no mask; the port's "auto" runs
    K1/K2's mask forms (their plain versions here), equal to the stencil,
    and the JAX side takes its keypoint kernels (interpret mode) where the
    port takes its kernel path.  An unknown kp_backend is an error."""
    from sift_pyocl_tpu_torch.ops.kernels import ladder

    assert match in inspect.signature(ladder.octave0_ladder).parameters
    assert match in inspect.signature(ladder.small_octaves_ladder).parameters
    cfg = SiftConfig(kp_per_octave_cap=256, **kw)
    jkw = {} if cfg.kp_backend == "xla" else {"kp_backend": "pallas"}
    want, want_counts = _jax_keypoints(scene128, dataclasses.replace(cfg, **jkw))
    plan = SiftPlan(scene128.shape, config=cfg, device="cpu")
    got = plan.keypoints(scene128)
    assert len(got) == len(want) > 10
    hits, desc_l1 = match_keypoint_sets(want, got)
    assert hits == len(want) and desc_l1 < 0.01
    np.testing.assert_array_equal(plan.keypoints_raw(scene128).counts.numpy(), want_counts)
    with pytest.raises(ValueError, match="kp_backend"):
        SiftPlan((64, 64), config=SiftConfig(kp_backend="numpy"), device="cpu")


@pytest.mark.parametrize("scene", ["scene128", "scene160"])
def test_plain_keypoint_path_matches_jax(scene, request):
    """kp_backend="xla" (plain detection, orientations compacted to each
    octave's descriptor capacity, plain descriptors) against the JAX
    package's XLA path with the same config: the same counts and buffer
    layout, every keypoint matched, descriptor L1 < 0.01."""
    img = request.getfixturevalue(scene)
    cfg = dataclasses.replace(CFG, kp_backend="xla")
    want, want_counts = _jax_keypoints(img, cfg)
    plan = SiftPlan(img.shape, config=cfg, device="cpu")
    got = plan.keypoints(img)
    assert len(got) == len(want) > 10
    hits, desc_l1 = match_keypoint_sets(want, got)
    assert hits == len(want) and desc_l1 < 0.01
    buf = plan.keypoints_raw(img)
    np.testing.assert_array_equal(buf.counts.numpy(), want_counts)
    assert buf.valid.shape == (sum(d for _, d in tsift.octave_capacities(img.shape, cfg)),)


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


def test_plan_without_a_card_raises_unless_asked_for_the_cpu():
    """device=None means the CUDA card; without one the plan raises and
    names device="cpu" (no silent fall back to the CPU)."""
    from sift_pyocl_tpu_torch.ops import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SiftPlan((64, 64))
    assert SiftPlan((64, 64), device="cpu").device == torch.device("cpu")
