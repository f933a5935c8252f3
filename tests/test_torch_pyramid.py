"""Pyramid parity: the port's plain PyTorch scale space against the JAX
package's ``conv_backend="xla"`` path on the same images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.ops import detect as jd
from sift_pyocl_tpu.ops import pyramid as jp

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops import pyramid as tp
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene
from _torch_threads import _one_torch_thread  # noqa: F401

# Both sides sum up to 27 Gaussian taps per pass in f32, in different
# orders (XLA's convolution vs PyTorch's); one f32 ulp at 255 is 1.5e-5 and
# five blur levels compound it.  Measured max difference: 7.6e-5 on blur
# stacks, 1.1e-4 on DoGs.
ATOL = 2e-4


@pytest.mark.parametrize("shape,mode,double", [
    ((150, 118), "shrink", False),   # odd octaves: 75x59, 38x30, 19x15
    ((150, 118), "bin", False),
    ((75, 59), "shrink", True),      # doubled to 150x118 (same JAX op shapes)
])
def test_scale_space_matches_jax(shape, mode, double):
    img = synthetic_scene(shape, n_blobs=20, seed=3)
    kw = dict(conv_backend="xla", downsample_mode=mode, double_im_size=double)
    want = jp.build_scale_space_jax(jnp.asarray(img), JaxConfig(**kw))
    got = tp.build_scale_space(torch.from_numpy(img), SiftConfig(**kw))
    assert len(got) == len(want)
    for (jb, jd), (tb, td) in zip(want, got):
        assert tuple(tb.shape) == tuple(jb.shape) and tuple(td.shape) == tuple(jd.shape)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=0)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(37, 53), (64, 64)])
def test_resampling_matches_jax(shape):
    """Shrink and 2x2 bin are exact rewrites of the JAX selection/averaging
    matmuls; the bilinear upscale sums two halves in both."""
    img = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    np.testing.assert_array_equal(tp.downsample2(t).numpy(), np.asarray(jp.downsample2(j)))
    np.testing.assert_array_equal(tp.downsample2_bin(t).numpy(),
                                  np.asarray(jp.downsample2_bin(j)))
    np.testing.assert_allclose(tp.upscale2(t).numpy(), np.asarray(jp.upscale2_jax(j)),
                               atol=3e-5, rtol=0)


@pytest.mark.parametrize("rgb", [False, True])
def test_normalize_matches_jax(rgb):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1000, (40, 30, 3) if rgb else (40, 30)).astype(np.float32)
    np.testing.assert_allclose(tp.normalize_image(torch.from_numpy(img)).numpy(),
                               np.asarray(jp.normalize_image_jax(jnp.asarray(img))),
                               atol=1e-4, rtol=0)
    flat = tp.normalize_image(torch.full((8, 8), 7.0))
    assert float(flat.abs().max()) == 0.0


def test_pallas_conv_backend_is_not_ported_yet():
    """The ladder kernels K1/K2 are ported ("pallas" and "auto" take them),
    and so are their in-ladder extrema masks: with mask_backend="fused"
    build_scale_space gives the unfused octaves and
    build_scale_space_and_masks adds one border-stripped mask an octave,
    equal to the JAX package's extrema_mask on those DoGs."""
    img = torch.from_numpy(synthetic_scene((96, 80), n_blobs=12, seed=5))
    cfg = SiftConfig(conv_backend="pallas", mask_backend="fused")
    octs = tp.build_scale_space(img, cfg)
    for (a, b), (c, d) in zip(octs, tp.build_scale_space(img, SiftConfig(conv_backend="pallas"))):
        assert torch.equal(a, c) and torch.equal(b, d)
    _, masks = tp.build_scale_space_and_masks(img, cfg)
    bd = cfg.border_dist
    assert len(masks) == len(octs)
    for o, ((_, d), m) in enumerate(zip(octs, masks)):
        assert m.shape == (cfg.scales, d.shape[1] - 2 * bd, d.shape[2] - 2 * bd)
        want = np.asarray(jd.extrema_mask(jnp.asarray(d.numpy()), JaxConfig(), o))
        np.testing.assert_array_equal(m.numpy(), want)
    assert tp.build_scale_space_and_masks(img, SiftConfig(conv_backend="xla",
                                                          mask_backend="fused"))[1] is None
    assert tp.resolve_conv_backend(SiftConfig()) == "pallas"
    assert tp.resolve_conv_backend(SiftConfig(conv_backend="xla")) == "xla"
