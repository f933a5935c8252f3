"""K1/K2, the blur ladders: their plain versions and ``build_scale_space``
with the ladder route (``conv_backend="pallas"`` or ``"auto"`` on a CPU
tensor) against the JAX package's Pallas ladders in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.ops import pyramid as jp

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops import pyramid as tp
from sift_pyocl_tpu_torch.ops.kernels import ladder, launch_counts, reset_launch_counts
from sift_pyocl_tpu_torch.ops.kernels.maskk import extrema_masks_ref
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene
from _torch_threads import _one_torch_thread  # noqa: F401

# The JAX suite holds its ladders to 2e-3 on [0, 255] (tests/test_pyramid.py);
# the two sides sum up to 27 taps a pass in different orders.
ATOL = 1e-3


def _jax_octaves(img, **kw):
    cfg = JaxConfig(conv_backend="pallas", pallas_interpret=True, **kw)
    return jp.build_scale_space_jax(jnp.asarray(img), cfg)


def _assert_octaves_close(got, want):
    assert len(got) == len(want)
    for (tb, td), (jb, jd) in zip(got, want):
        assert tuple(tb.shape) == tuple(jb.shape) and tuple(td.shape) == tuple(jd.shape)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=0)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)


# Each JAX ladder compiles for a few seconds in interpret mode, so each
# scene takes one downsample mode (the odd-size case below takes "bin" too).
@pytest.mark.parametrize("scene,mode,backend", [
    ("scene128", "shrink", "pallas"),
    ("scene160", "bin", "auto"),
])
def test_ladder_route_matches_jax_kernels(scene, mode, backend, request):
    img = request.getfixturevalue(scene)
    want = _jax_octaves(img, downsample_mode=mode)
    cfg = SiftConfig(conv_backend=backend, downsample_mode=mode)
    assert tp.resolve_conv_backend(cfg) == "pallas"
    reset_launch_counts()
    got = tp.build_scale_space(torch.from_numpy(img), cfg)
    assert sum(launch_counts().values()) == 0      # CPU tensors: plain versions
    _assert_octaves_close(got, want)


def test_ladder_plain_versions_match_jax_on_odd_sizes():
    """(135, 241): odd octaves 68x121, 34x61, 17x31, each ceil-sized; K1
    from the normalized image with the pre-blur, K2 from its level 3."""
    img = np.random.default_rng(7).uniform(0, 255, (135, 241)).astype(np.float32)
    want = _jax_octaves(img, downsample_mode="bin")
    cfg = SiftConfig(downsample_mode="bin")
    x = tp.normalize_image(torch.from_numpy(img))
    pre = float(np.sqrt(cfg.init_sigma**2 - cfg.orig_sigma**2))
    b0, d0 = ladder.octave0_ladder_ref(x, pre, cfg.sigma_increments())
    small = ladder.small_octaves_ladder_ref(tp.downsample2_bin(b0[cfg.scales]),
                                            cfg.sigma_increments(), len(want) - 1,
                                            cfg.scales, "bin")
    _assert_octaves_close([(b0, d0)] + small, want)
    assert [tuple(b.shape[1:]) for b, _ in small] == [(68, 121), (34, 61), (17, 31)]


def test_ladder_without_pre_blur_and_double_size():
    """init_sigma <= the doubled input's blur: level 0 is the image itself,
    and octave 0 takes the per-level route (K9), which on a CPU tensor
    equals the plain route exactly (same plain ops)."""
    img = synthetic_scene((40, 52), n_blobs=6, seed=1)
    kw = dict(double_im_size=True, init_sigma=0.9)
    got = tp.build_scale_space(torch.from_numpy(img), SiftConfig(**kw))
    want = tp.build_scale_space(torch.from_numpy(img), SiftConfig(conv_backend="xla", **kw))
    for (gb, gd), (wb, wd) in zip(got, want):
        assert torch.equal(gb, wb) and torch.equal(gd, wd)
    np.testing.assert_array_equal(got[0][0][0].numpy(),
                                  tp.upscale2(tp.normalize_image(torch.from_numpy(img))).numpy())


@pytest.mark.parametrize("kw,exc", [
    ({"mask_backend": "fused"}, NotImplementedError),
    ({"conv_backend": "cudnn"}, ValueError),
])
def test_ladder_options_not_ported_raise(kw, exc):
    """An unknown conv_backend raises.  mask_backend="fused", which raised
    NotImplementedError until the ladders' mask forms were ported, now
    runs: the unfused octaves, and one mask an octave equal to the plain
    stencil's on their DoGs."""
    img = torch.from_numpy(synthetic_scene((64, 64), n_blobs=6, seed=2))
    cfg = SiftConfig(**kw)
    if exc is ValueError:
        with pytest.raises(exc):
            tp.build_scale_space(img, cfg)
        return
    octs, masks = tp.build_scale_space_and_masks(img, cfg)
    for (a, b), (c, d), m, st in zip(octs, tp.build_scale_space(img, SiftConfig()), masks,
                                     extrema_masks_ref([d for _, d in octs], cfg)):
        assert torch.equal(a, c) and torch.equal(b, d) and torch.equal(m, st)


def test_ladder_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        ladder.octave0_ladder(torch.zeros(2, 8, 8), 1.0, (1.0,))
    with pytest.raises(ValueError):
        ladder.small_octaves_ladder(torch.zeros(8, 8), (1.0, 1.2), 2, 3)
    with pytest.raises(ValueError):
        ladder.small_octaves_ladder(torch.zeros(8, 8), (1.0,), 1, 1, ds_mode="nearest")
    assert dataclasses.replace(SiftConfig(), conv_backend="auto").conv_backend == "auto"
