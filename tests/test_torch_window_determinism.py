"""The plain histogram arithmetic of K11a, K11b and K6 gives the same bits
whatever the number of torch threads, and its Gaussian weights are the
correctly rounded f32 exp (``window._exp_f32``: exp2 in f64, rounded once).
PyTorch's exp on the CPU computed one worker thread's chunk of a process's
first exp call at up to 1.5e-4 relative error in 10 of 240 processes,
which moved K11a's plain histograms by up to 2.5e-3 against the JAX
kernel; its exp2 never did.  Port only: no JAX."""

import math

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch.ops.kernels import window
from sift_pyocl_tpu_torch.ops.orient_desc import PAD_C, PAD_R

H, W, S, N = 72, 104, 5, 48
ORI_WIN, DESC_WIN = 48, 104


@pytest.fixture(scope="module")
def slots():
    """Padded gradient planes and N keypoint slots (a quarter invalid),
    made with numpy from a seed."""
    rng = np.random.default_rng(8)
    mag = np.zeros((S, H + 2 * PAD_R, W + 2 * PAD_C), np.float32)
    ori = np.zeros_like(mag)
    mag[:, PAD_R:PAD_R + H, PAD_C:PAD_C + W] = rng.uniform(0, 30, (S, H, W))
    ori[:, PAD_R:PAD_R + H, PAD_C:PAD_C + W] = rng.uniform(-math.pi, math.pi, (S, H, W))
    s_int = rng.integers(1, S - 1, N).astype(np.int32)
    sigma = (1.6 * 2.0 ** (s_int / 3.0) * rng.uniform(1.0, 1.25, N)).astype(np.float32)
    t = torch.from_numpy
    return dict(mag_p=t(mag), ori_p=t(ori), s_int=t(s_int),
                fr=t(rng.uniform(-2, H + 2, N).astype(np.float32)),
                fc=t(rng.uniform(-2, W + 2, N).astype(np.float32)), sigma=t(sigma),
                angle=t(rng.uniform(-math.pi, math.pi, N).astype(np.float32)),
                valid=t(rng.uniform(size=N) < 0.75))


def _k11a(k):
    return (window.orientation_hist(k["mag_p"], k["ori_p"], k["s_int"], k["fr"], k["fc"],
                                    k["sigma"], k["valid"], ORI_WIN),)


def _k11b(k):
    return (window.descriptor_hist(k["mag_p"], k["ori_p"], k["s_int"], k["fr"], k["fc"],
                                   k["sigma"], k["angle"], k["valid"], DESC_WIN),)


def _k6(k):
    """K6's plain version on the same planes as a one-octave atlas."""
    mags = k["mag_p"][:, PAD_R:PAD_R + H, PAD_C:PAD_C + W].contiguous()
    oris = k["ori_p"][:, PAD_R:PAD_R + H, PAD_C:PAD_C + W].contiguous()
    n = k["fr"].shape[0]
    full = lambda v: torch.full((n,), v, dtype=torch.int32)  # noqa: E731
    return window.orient_desc_fused_ref(mags, oris, k["s_int"], k["fr"], k["fc"], k["sigma"],
                                        k["valid"], DESC_WIN, 4, full(0), full(H), full(W))


@pytest.mark.parametrize("fn", [_k11a, _k11b, _k6], ids=["k11a", "k11b", "k6"])
def test_plain_histograms_same_bits_at_1_2_8_threads(slots, fn):
    before = torch.get_num_threads()
    outs = {}
    try:
        for nt in (1, 2, 8):
            torch.set_num_threads(nt)
            outs[nt] = [t.clone() for t in fn(slots)]
    finally:
        torch.set_num_threads(before)
    assert any(bool(t.any()) for t in outs[1])
    for nt in (2, 8):
        for a, b in zip(outs[1], outs[nt]):
            assert torch.equal(a, b), f"{fn.__name__}: other bits at {nt} threads"


def test_gaussian_weights_are_the_rounded_f64_exp():
    """``_exp_f32`` equals numpy's f64 exp rounded to f32 on the weights'
    range of arguments, whatever the thread count."""
    x = np.concatenate([-np.geomspace(1e-6, 90.0, 40_000, dtype=np.float32),
                        np.zeros(1, np.float32)])
    want = np.exp(x.astype(np.float64)).astype(np.float32)
    before = torch.get_num_threads()
    try:
        for nt in (1, 8):
            torch.set_num_threads(nt)
            np.testing.assert_array_equal(window._exp_f32(torch.from_numpy(x)).numpy(), want)
    finally:
        torch.set_num_threads(before)
