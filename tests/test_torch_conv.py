"""K9, the separable blur, and the pyramid's per-level route: the plain
version (what the wrapper runs on the CPU) against ``separable_blur_pallas``
in interpret mode, the routing of ``blur`` and ``build_scale_space``, and
the per-level octave 0 of ``SiftConfig(scales=2)`` against the JAX
package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.ops import pyramid as jp
from sift_pyocl_tpu.ops.pallas.conv import blur_taps, separable_blur_pallas

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops import pyramid as tp
from sift_pyocl_tpu_torch.ops.kernels import conv, ladder, launch_counts, reset_launch_counts
from _torch_threads import _one_torch_thread  # noqa: F401

# the JAX suite's bound for its blur kernel against the XLA blur
# (tests/test_pallas.py): up to 39 taps a pass summed in other orders
BLUR_ATOL = 2e-4
# the ladder tests' bound on [0, 255] (tests/test_torch_ladder.py)
ATOL = 1e-3


@pytest.mark.parametrize("shape", [(64, 96), (200, 300)])
@pytest.mark.parametrize("sigma", [1.226, 1.6, 3.09])
def test_separable_blur_matches_jax_kernel(shape, sigma):
    img = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(separable_blur_pallas(jnp.asarray(img), blur_taps(sigma), tile_rows=64,
                                            tile_cols=128, interpret=True))
    taps = torch.from_numpy(np.asarray(blur_taps(sigma), np.float32))
    reset_launch_counts()
    got = conv.separable_blur(torch.from_numpy(img), taps)
    assert conv.separable_blur.launches == 0     # CPU tensor: the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=BLUR_ATOL, rtol=0)


def test_blur_routes_by_backend(monkeypatch):
    """"pallas" and "auto" go through K9's wrapper, "xla" to the plain
    passes; all give the plain blur on a CPU tensor."""
    img = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (40, 52)).astype(np.float32))
    calls = []
    k9 = conv.separable_blur
    monkeypatch.setattr(conv, "separable_blur", lambda *a: calls.append(1) or k9(*a))
    want = tp.separable_blur_ref(img, tp._taps(1.6, img.device))
    for backend, n in (("pallas", 1), ("auto", 2), ("xla", 2)):
        assert torch.equal(tp.blur(img, 1.6, backend), want)
        assert len(calls) == n, backend
    with pytest.raises(ValueError, match="backend"):
        tp.blur(img, 1.6, "cudnn")
    with pytest.raises(ValueError):
        conv.separable_blur(img, torch.ones(4))


@pytest.mark.parametrize("kw,route", [
    ({}, "k1"),
    ({"scales": 2}, "k9"),
    ({"init_sigma": 1.8, "scales": 2}, "k9"),
    ({"init_sigma": 2.1}, "k9"),
    ({"double_im_size": True, "init_sigma": 0.9}, "k9"),   # no pre-blur
])
def test_octave0_route(kw, route, monkeypatch):
    """Octave 0 takes K1 exactly where the JAX package's strip ladder holds
    the sigmas, else K9 once per level (pre-blur included); K2 once."""
    calls = {"k1": 0, "k9": 0, "k2": 0}

    def counted(name, fn):
        return lambda *a, **k: calls.__setitem__(name, calls[name] + 1) or fn(*a, **k)

    monkeypatch.setattr(ladder, "octave0_ladder", counted("k1", ladder.octave0_ladder))
    monkeypatch.setattr(ladder, "small_octaves_ladder", counted("k2", ladder.small_octaves_ladder))
    monkeypatch.setattr(conv, "separable_blur", counted("k9", conv.separable_blur))
    cfg = SiftConfig(**kw)
    tp.build_scale_space(torch.zeros(64, 80), cfg)
    n_blurs = len(cfg.sigma_increments()) + (tp.pre_blur_sigma(cfg) is not None)
    want = {"k1": 1, "k9": 0} if route == "k1" else {"k1": 0, "k9": n_blurs}
    assert calls == {**want, "k2": 1}
    tp.build_scale_space(torch.zeros(64, 80), cfg, plain=True)
    assert calls == {**want, "k2": 1}                 # plain: no wrapper at all


@pytest.mark.parametrize("kw", [{"scales": 2}, {"init_sigma": 1.8, "scales": 2}])
def test_per_level_scale_space_matches_jax(scene128, kw):
    """Octave 0 through K9 (its plain version here) against the JAX
    package's per-level route through ``separable_blur_pallas`` in interpret
    mode, and every octave against its XLA pyramid; blurs and DoGs within
    1e-3, the same octave geometry.  (The JAX package's small-octaves
    ladder is wrong at these configs: see the next test.)"""
    reset_launch_counts()
    got = tp.build_scale_space(torch.from_numpy(scene128), SiftConfig(**kw))
    assert sum(launch_counts().values()) == 0        # CPU tensors: plain versions
    j_k9 = jp.build_scale_space_jax(jnp.asarray(scene128),
                                    JaxConfig(conv_backend="pallas", pallas_interpret=True, **kw))
    j_xla = jp.build_scale_space_jax(jnp.asarray(scene128), JaxConfig(conv_backend="xla", **kw))
    assert len(got) == len(j_k9) == len(j_xla)
    for want in ([j_k9[0]], j_xla):
        for (tb, td), (jb, jd) in zip(got, want):
            assert tuple(tb.shape) == jb.shape and tuple(td.shape) == jd.shape
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=0)
            np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)


def test_jax_small_octaves_ladder_is_wrong_past_its_margin():
    """A fault of the reference, recorded in ROADMAP.md: the JAX package's
    K2 (``ops/pallas/ladder.py``, row margin MR = 16) takes the taps of
    ``SiftConfig(scales=2)``'s last increment (half-width 19) without a
    check, and its last level then differs from the XLA blur by far more
    than rounding; the port's K2 (plain version here) agrees with XLA."""
    from sift_pyocl_tpu.ops.pallas.ladder import small_octaves_ladder as j_k2

    cfg = SiftConfig(scales=2)
    incs = cfg.sigma_increments()
    assert max((len(tp.gaussian_kernel(s)) - 1) // 2 for s in incs) == 19
    base = np.random.default_rng(2).uniform(0, 255, (48, 64)).astype(np.float32)
    jb = np.asarray(j_k2(jnp.asarray(base), incs, 1, cfg.scales, interpret=True)[0][0])
    xb = np.asarray(jp.build_octave_jax(jnp.asarray(base),
                                        JaxConfig(scales=2, conv_backend="xla"))[0])
    tb = ladder.small_octaves_ladder(torch.from_numpy(base), incs, 1, cfg.scales)[0][0].numpy()
    np.testing.assert_allclose(tb, xb, atol=ATOL, rtol=0)
    np.testing.assert_allclose(jb[:-1], xb[:-1], atol=ATOL, rtol=0)
    assert np.abs(jb[-1] - xb[-1]).max() > 1.0
