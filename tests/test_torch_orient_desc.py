"""Orientation/descriptor parity: K5 gradient atlas and K6 fused
orientation + descriptor (plain versions, as the wrappers run them on the
CPU) against the JAX package on the same gradient planes and keypoints."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.ops import orient_desc as jod
from sift_pyocl_tpu.ops.detect import detect_octave
from sift_pyocl_tpu.ops.pallas.window import orient_desc_fused_pallas, pad_grad_planes
from sift_pyocl_tpu.ops.pyramid import build_scale_space_jax

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops import orient_desc as tod
from sift_pyocl_tpu_torch.ops.kernels.gradpad import grad_atlas
from sift_pyocl_tpu_torch.ops.kernels.window import orient_desc_fused
from sift_pyocl_tpu_torch.utils.convert import to_torch


@pytest.fixture(scope="module")
def octs128(scene128):
    cfg = JaxConfig(kp_per_octave_cap=256, conv_backend="xla")
    return cfg, build_scale_space_jax(jnp.asarray(scene128), cfg)


@pytest.fixture(scope="module")
def octave1(octs128):
    """Octave 1 of scene128 (where its blobs put most extrema): blur stack,
    JAX gradient planes and refined keypoints."""
    cfg, octs = octs128
    blurs, dogs = octs[1]
    kps = detect_octave(dogs, cfg, 1, 64)
    mags, oris = jod.gradient_planes(blurs, cfg)
    return cfg, blurs, kps, mags, oris


def _fused_args(octave1, win):
    """The port's orient_desc_fused arguments for octave1's keypoints, with
    the octave alone as the atlas (row offset 0)."""
    cfg, _, kps, mags, oris = octave1
    cap = int(kps.valid.shape[0])
    _, H, W = mags.shape
    sigma = cfg.init_sigma * 2.0 ** (np.asarray(kps.fs) / cfg.scales)
    full = [torch.full((cap,), v, dtype=torch.int32) for v in (0, H, W)]
    arrays = [to_torch(np.asarray(x)) for x in (mags, oris, kps.s_int, kps.fr, kps.fc)]
    return (*arrays, to_torch(sigma.astype(np.float32)), to_torch(np.asarray(kps.valid)),
            win, cfg.max_ori, *full)


def test_grad_atlas_matches_jax_gradients(octs128):
    """mag within 1e-5; ori within 1e-5 modulo 2 pi (torch.atan2 against
    jnp.arctan2, wrapping at +-pi); zeros outside each octave."""
    cfg, octs = octs128
    mag, ori, row_starts = grad_atlas([to_torch(np.asarray(b)) for b, _ in octs], cfg.scales)
    mag, ori = mag.numpy(), ori.numpy()
    assert mag.shape == (cfg.scales, sum(b.shape[1] for b, _ in octs), octs[0][0].shape[2])
    covered = np.zeros(mag.shape, bool)
    for r0, (b, _) in zip(row_starts, octs):
        jm, jo = (np.asarray(x) for x in jod.gradient_planes(b, cfg))
        _, h, w = jm.shape
        np.testing.assert_allclose(mag[:, r0:r0 + h, :w], jm, atol=1e-5, rtol=0)
        d = np.abs(ori[:, r0:r0 + h, :w] - jo)
        assert np.minimum(d, 2 * np.pi - d).max() <= 1e-5
        covered[:, r0:r0 + h, :w] = True
    assert not mag[~covered].any() and not ori[~covered].any()
    tm, _ = tod.gradient_planes(to_torch(np.asarray(octs[0][0])), SiftConfig())
    np.testing.assert_array_equal(tm.numpy(), mag[:, : tm.shape[1], : tm.shape[2]])


def _u8(raw):
    return np.asarray(jod.quantize_descriptors(jnp.asarray(raw.reshape(-1, 128))))


def test_fused_orient_desc_matches_jax_kernel(octave1):
    """Count equal, angles within 1e-4, u8 descriptors within 1 count and
    mean difference < 0.01 (the bounds of the JAX suite's own fused-kernel
    test: both sides sum histogram bins in different orders)."""
    cfg, blurs, kps, mags, oris = octave1
    valid = np.asarray(kps.valid)
    assert valid.sum() > 5
    sigma = cfg.init_sigma * 2.0 ** (kps.fs / cfg.scales)
    win = jod._desc_window_size(cfg)
    mag_p, ori_p = pad_grad_planes(mags, oris)
    ja, jok, jraw = (np.asarray(x) for x in orient_desc_fused_pallas(
        mag_p, ori_p, kps.s_int, kps.fr, kps.fc, sigma, kps.valid,
        win=win, max_ori=cfg.max_ori, interpret=True))
    ta, tok, traw = (x.numpy() for x in orient_desc_fused(*_fused_args(octave1, win)))
    assert tok.sum() == jok.sum() > 5
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(ta[tok], ja[jok], atol=1e-4, rtol=0)
    diff = np.abs(_u8(traw[tok]).astype(int) - _u8(jraw[jok]).astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.01
    assert not traw[~tok].any() and not ta[~valid].any()


def test_window_size_is_not_capped(octave1):
    """A wider static window only adds zero-weight samples: the results at
    win=104 and win=136 agree (the TPU kernel's win <= 128 was a lane limit;
    the port runs any window)."""
    assert tod._desc_window_size(SiftConfig(init_sigma=1.8, scales=2)) > 128
    (a0, k0, r0), (a1, k1, r1) = (orient_desc_fused(*_fused_args(octave1, win))
                                  for win in (104, 136))
    assert torch.equal(k0, k1) and int(k0.sum()) > 5
    np.testing.assert_allclose(a1[k0].numpy(), a0[k0].numpy(), atol=1e-5)
    np.testing.assert_allclose(r1.numpy(), r0.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("cfg_kw", [{}, {"init_sigma": 1.8, "scales": 2}, {"scales": 5}])
def test_window_sizes_match_jax(cfg_kw):
    j, t = JaxConfig(**cfg_kw), SiftConfig(**cfg_kw)
    assert tod._ori_window_size(t) == jod._ori_window_size(j)
    assert tod._desc_window_size(t) == jod._desc_window_size(j)
    assert tod._desc_window_for_sigma(t, 2.0) == jod._desc_window_for_sigma(j, 2.0)


def test_quantize_descriptors_matches_jax():
    rng = np.random.default_rng(3)
    raw = (rng.gamma(0.5, 1.0, (40, 128)) * rng.uniform(0, 50, (40, 1))).astype(np.float32)
    raw[3] = 0.0
    raw[5, :4] = 1000.0                       # clipping at 0.2, saturation at 255
    got = tod.quantize_descriptors(torch.from_numpy(raw)).numpy()
    want = np.asarray(jod.quantize_descriptors(jnp.asarray(raw)))
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 0.01
    assert not got[3].any()
