"""The last kernel forms of the port against the JAX package: the in-ladder
extrema masks of K1/K2 (``SiftConfig(mask_backend="fused")``; on the CPU
the wrappers run their plain versions, the plain ladder and the stencil),
K7's f32 operands, and the mode arguments of K3 (``extract_mode``), K6
(``reduce_mode``) and K7 (``two_pass``), each against the JAX function in
that mode, its Pallas kernels in interpret mode."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.models import sift as jsift
from sift_pyocl_tpu.ops import detect as jd
from sift_pyocl_tpu.ops import orient_desc as jod
from sift_pyocl_tpu.ops.pallas.compact import compact_masks_multi as j_compact
from sift_pyocl_tpu.ops.pallas.matchk import best2_l2_pallas
from sift_pyocl_tpu.ops.pallas.window import orient_desc_fused_pallas, pad_grad_planes
from sift_pyocl_tpu.ops.pyramid import build_scale_space_and_masks_jax, build_scale_space_jax
from sift_pyocl_tpu.oracle import KP_DTYPE as J_KP_DTYPE

from sift_pyocl_tpu_torch import SiftConfig, SiftPlan
from sift_pyocl_tpu_torch.ops.kernels import (compact, ladder, launch_counts, matchk,
                                              reset_launch_counts, window)
from sift_pyocl_tpu_torch.ops.kernels.maskk import extrema_masks_ref, stencil_mask
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space, build_scale_space_and_masks
from sift_pyocl_tpu_torch.utils.convert import to_torch

from conftest import match_keypoint_sets
from _torch_threads import _one_torch_thread  # noqa: F401

FUSED = SiftConfig(mask_backend="fused", kp_per_octave_cap=256)


def _jax_cfg(cfg: SiftConfig, **kw) -> JaxConfig:
    return JaxConfig(**{**dataclasses.asdict(cfg), "pallas_interpret": True, **kw})


def _jax_keypoints(img, jcfg: JaxConfig):
    buf = jsift.detect_and_describe(jnp.asarray(img), jcfg)
    m = np.asarray(buf.valid)
    out = np.zeros(int(m.sum()), dtype=J_KP_DTYPE)
    for f in ("x", "y", "scale", "angle", "desc"):
        out[f] = np.asarray(getattr(buf, f))[m]
    return out, np.asarray(buf.counts)


def _neighbourhood_max(x: np.ndarray, bd: int) -> np.ndarray:
    """Per mask element (S-2, H-2bd, W-2bd), the largest of `x` (S, H, W)
    over its 3x3x3 neighbourhood."""
    S, H, W = x.shape
    out = np.zeros((S - 2, H - 2 * bd, W - 2 * bd), x.dtype)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                out = np.maximum(out, x[1 + ds:S - 1 + ds, bd + dr:H - bd + dr, bd + dc:W - bd + dc])
    return out


def test_fused_masks_match_stencil_and_jax_fused_ladders(scene160):
    """Every octave's fused mask equals, exactly, the JAX extrema_mask on
    the port's own DoGs and the port's plain stencil; and the JAX package's
    own fused masks (its K1/K2 mask forms in interpret mode) equal the
    port's wherever the two pyramids' DoGs agree within 1e-3 around the
    pixel.  Measured: no pixel differs at all on scene160 (nor on scene128):
    the two pyramids' DoGs agree within 9.2e-5 everywhere, far inside every
    comparison the mask makes on this scene."""
    octs, masks = build_scale_space_and_masks(torch.from_numpy(scene160), FUSED)
    assert masks is not None and len(masks) == len(octs)
    jcfg = _jax_cfg(FUSED, conv_backend="pallas")
    jocts, jmasks = build_scale_space_and_masks_jax(jnp.asarray(scene160), jcfg)
    bd = FUSED.border_dist
    total = 0
    for o, ((_, d), m, st, (_, jdog), jm) in enumerate(zip(octs, masks, extrema_masks_ref(
            [d for _, d in octs], FUSED), jocts, jmasks)):
        assert m is not None and m.dtype == torch.bool
        want = np.asarray(jd.extrema_mask(jnp.asarray(d.numpy()), jcfg, o))
        np.testing.assert_array_equal(m.numpy(), want, err_msg=f"octave {o}")
        assert torch.equal(m, st)
        agree = _neighbourhood_max(np.abs(np.asarray(jdog) - d.numpy()), bd) <= 1e-3
        differ = (np.asarray(jm) != 0) != m.numpy()
        assert not (differ & agree).any(), f"octave {o}"
        assert not differ.any(), f"octave {o}: {int(differ.sum())} pixels differ"
        total += int(want.sum())
    assert total > 5


@pytest.mark.parametrize("scene", ["scene128", "scene160"])
def test_fused_keypoints_match_jax_fused_path(scene, request):
    """SiftPlan.keypoints with mask_backend="fused" against the JAX
    package's fused path (its ladder kernels and keypoint kernels in
    interpret mode): the same counts, every JAX keypoint matched, mean u8
    descriptor L1 < 0.01; no launch on the CPU."""
    img = request.getfixturevalue(scene)
    want, want_counts = _jax_keypoints(
        img, _jax_cfg(FUSED, conv_backend="pallas", kp_backend="pallas"))
    plan = SiftPlan(img.shape, config=FUSED, device="cpu")
    reset_launch_counts()
    got = plan.keypoints(img)
    assert sum(launch_counts().values()) == 0
    assert len(got) == len(want) > 10
    hits, desc_l1 = match_keypoint_sets(want, got)
    assert hits == len(want) and desc_l1 < 0.01
    np.testing.assert_array_equal(plan.keypoints_raw(img).counts.numpy(), want_counts)


def test_fused_scales2_takes_the_stencil_for_octave0(scene160):
    """SiftConfig(mask_backend="fused", scales=2): octave 0 goes level by
    level (K9's route), so its mask entry is None and detection takes the
    stencil there, the small octaves come from K2m's form.  Held to the JAX
    package's XLA pyramid (its K2 is wrong at scales=2, ROADMAP Queue 3)
    with its keypoint kernels in interpret mode."""
    cfg = dataclasses.replace(FUSED, scales=2)
    octs, masks = build_scale_space_and_masks(torch.from_numpy(scene160), cfg)
    assert masks[0] is None and all(m is not None for m in masks[1:])
    stencil_mask.calls = 0
    got = SiftPlan(scene160.shape, config=cfg, device="cpu").keypoints(scene160)
    # the CPU's plain K2m runs the stencil on each small octave, and the
    # None entry of octave 0 one more
    assert stencil_mask.calls == len(octs)
    want, _ = _jax_keypoints(scene160, _jax_cfg(cfg, conv_backend="xla", kp_backend="pallas",
                                                mask_backend="xla"))
    assert len(got) == len(want) > 10
    hits, desc_l1 = match_keypoint_sets(want, got)
    assert hits == len(want) and desc_l1 < 0.01


def test_ladder_mask_forms_take_mask_cfg():
    """K1m and K2m's plain versions (what the wrappers run on the CPU)
    return the plain ladders' stacks and the stencil's masks; malformed
    mask_cfg raises."""
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.uniform(0, 255, (70, 90)).astype(np.float32))
    cfg = SiftConfig()
    incs = cfg.sigma_increments()
    b, d, m = ladder.octave0_ladder(img, 1.5, incs, mask_cfg=(cfg.peak_thresh, 0.08, 5))
    rb, rd = ladder.octave0_ladder(img, 1.5, incs)
    assert torch.equal(b, rb) and torch.equal(d, rd) and m.shape == (3, 60, 80)
    assert torch.equal(m, stencil_mask(d, cfg.peak_thresh, 0.08, 5))
    small = ladder.small_octaves_ladder(img, incs, 2, 3, mask_cfg=(cfg.peak_thresh, (0.06, 0.07), 5))
    for (sb, sd, sm), (rb, rd), eth in zip(small, ladder.small_octaves_ladder(img, incs, 2, 3),
                                           (0.06, 0.07)):
        assert torch.equal(sb, rb) and torch.equal(sd, rd)
        assert torch.equal(sm, stencil_mask(sd, cfg.peak_thresh, eth, 5))
    with pytest.raises(ValueError, match="edge threshold"):
        ladder.small_octaves_ladder(img, incs, 2, 3, mask_cfg=(cfg.peak_thresh, (0.06,), 5))
    with pytest.raises(ValueError, match="wider than"):
        ladder.octave0_ladder(img, 1.5, incs, mask_cfg=(cfg.peak_thresh, 0.08, 40))


@pytest.mark.parametrize("mode", ["sum", "rowmm"])
def test_compaction_extract_modes_match_jax(mode):
    """K3 with each extract_mode against compact_masks_multi in that mode:
    exact indices in np.nonzero order, written and total."""
    rng = np.random.default_rng(5)
    masks = [rng.random((3, h, w)) < p for (h, w), p in
             [((100, 150), 0.001), ((50, 75), 0.004), ((40, 70), 0.03)]]
    masks[0][0, :10, :50] = True          # past the tile's 128-index limit
    caps = [256, 128, 64]
    idx, wr, tot = (np.asarray(x) for x in j_compact(
        [jnp.asarray(m) for m in masks], caps, interpret=True, extract_mode=mode))
    g_idx, g_wr, g_tot = compact.compact_masks_multi([torch.from_numpy(m) for m in masks], caps,
                                                     extract_mode=mode)
    np.testing.assert_array_equal(g_wr.numpy(), wr)
    np.testing.assert_array_equal(g_tot.numpy(), tot)
    off = 0
    for o, cap in enumerate(caps):
        np.testing.assert_array_equal(g_idx.numpy()[off:off + wr[o]], idx[off:off + wr[o]])
        off += cap
    assert int(tot[0]) > int(wr[0]) and int(wr[2]) == caps[2]


@pytest.fixture(scope="module")
def octave1_window(scene128):
    """Octave 1 of scene128: JAX gradient planes and keypoints, and the
    port's orient_desc_fused arguments for them (the octave alone as the
    atlas)."""
    cfg = JaxConfig(kp_per_octave_cap=256, conv_backend="xla")
    blurs, dogs = build_scale_space_jax(jnp.asarray(scene128), cfg)[1]
    kps = jd.detect_octave(dogs, cfg, 1, 64)
    mags, oris = jod.gradient_planes(blurs, cfg)
    win = jod._desc_window_size(cfg)
    sigma = cfg.init_sigma * 2.0 ** (kps.fs / cfg.scales)
    cap = int(kps.valid.shape[0])
    _, H, W = mags.shape
    full = [torch.full((cap,), v, dtype=torch.int32) for v in (0, H, W)]
    targs = ([to_torch(np.asarray(x)) for x in (mags, oris, kps.s_int, kps.fr, kps.fc)]
             + [to_torch(np.asarray(sigma, np.float32)), to_torch(np.asarray(kps.valid)), win,
                cfg.max_ori, *full])
    jargs = (*pad_grad_planes(mags, oris), kps.s_int, kps.fr, kps.fc, sigma, kps.valid)
    return cfg, win, targs, jargs


@pytest.mark.parametrize("mode", ["scalar", "colsum"])
def test_fused_orient_desc_reduce_modes_match_jax(octave1_window, mode):
    """K6 with each reduce_mode against orient_desc_fused_pallas in that
    mode, at the JAX suite's own bounds for the two modes
    (tests/test_pallas.py:405-408): the same ok flags, angles within 1e-5,
    raw descriptors within 1e-5 of the largest entry."""
    cfg, win, targs, jargs = octave1_window
    ja, jok, jraw = (np.asarray(x) for x in orient_desc_fused_pallas(
        *jargs, win=win, max_ori=cfg.max_ori, interpret=True, reduce_mode=mode))
    ta, tok, traw = (x.numpy() for x in window.orient_desc_fused(*targs, reduce_mode=mode))
    assert jok.sum() > 5 and np.array_equal(tok, jok)
    np.testing.assert_allclose(ta[jok], ja[jok], atol=1e-5)
    scale = np.abs(jraw).max() + 1e-9
    np.testing.assert_allclose(traw[jok] / scale, jraw[jok] / scale, atol=1e-5)


def _descriptors(n1, n2, seed):
    """u8 descriptors with a planted tie at the minimum (row 0 is column 3,
    column 5 equals column 3) and near-duplicates."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 256, (n1, 128), dtype=np.uint8)
    d2 = rng.integers(0, 256, (n2, 128), dtype=np.uint8)
    d2[5] = d2[3]
    d1[0] = d2[3]
    d1[2:6] = d2[10:14]
    d1[2:6, 0] ^= 1
    v2 = rng.uniform(size=n2) < 0.8
    v2[[3, 5, 10, 11, 12, 13]] = True
    return d1, d2, v2


def _finite(x):
    x = np.asarray(x)
    return np.where(np.isinf(x), 1e30, x)


@pytest.mark.parametrize("two_pass", [False, True])
def test_best2_two_pass_matches_jax(two_pass):
    """K7 with each two_pass against best2_l2_pallas in that mode, at the
    JAX suite's bounds (tests/test_match.py:109-114): distances within
    rtol 1e-6, argmins equal, ties included."""
    d1, d2, v2 = _descriptors(300, 200, 4)
    p1, p2, pi = best2_l2_pallas(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2),
                                 interpret=True, two_pass=two_pass)
    g1, g2, gi = matchk.best2_l2(*(torch.from_numpy(a) for a in (d1, d2, v2)), two_pass=two_pass)
    np.testing.assert_allclose(g1.numpy(), np.asarray(p1), rtol=1e-6)
    np.testing.assert_allclose(_finite(g2.numpy()), _finite(p2), rtol=1e-6)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(pi))
    assert gi[0] == 3 and g1[0] == g2[0] == 0


@pytest.mark.parametrize("mixed", [False, True])
def test_best2_f32_operands_match_jax(mixed):
    """K7's f32 operand form: the plain version (what the wrapper runs on
    the CPU) against best2_l2_pallas on the same f32 inputs (or u8 queries
    against f32 columns, which both cast to f32).  The two sum the dot
    products in other orders: d1/d2 within 1e-5 of |a|^2 + max |b|^2, i1
    equal except where the two best distances are that close."""
    d1, d2, v2 = _descriptors(300, 257, 6)
    a = d1 if mixed else d1.astype(np.float32) / 255.0
    b = d2.astype(np.float32) / 255.0
    p1, p2, pi = (np.asarray(x) for x in best2_l2_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(v2), interpret=True))
    g1, g2, gi = (x.numpy() for x in matchk.best2_l2(
        *(torch.from_numpy(x) for x in (a, b, v2))))
    af, bf = a.astype(np.float32), b
    mag = (af * af).sum(1) + (bf[v2] * bf[v2]).sum(1).max()
    assert np.all(np.abs(g1 - p1) <= 1e-5 * mag)
    assert np.all(np.abs(_finite(g2) - _finite(p2)) <= 1e-5 * mag)
    near = (p2 - p1) <= 1e-5 * mag
    assert not np.any((gi != pi) & ~near)
    assert gi[0] == 3


@pytest.mark.parametrize("call", ["compact", "window", "match"])
def test_mode_arguments_reject_other_values(call):
    """Each mode argument takes the JAX values only."""
    if call == "compact":
        with pytest.raises(ValueError, match="extract_mode"):
            compact.compact_masks_multi([torch.zeros(4, 4, dtype=torch.bool)], [8],
                                        extract_mode="scan")
    elif call == "window":
        assert inspect.signature(window.orient_desc_fused).parameters["reduce_mode"].default \
            == "scalar"
        z = torch.zeros(1, 4, 4)
        n = torch.zeros(64)
        with pytest.raises(ValueError, match="reduce_mode"):
            window.orient_desc_fused(z, z, n, n, n, n, n.bool(), 8, 2, n, n, n, reduce_mode="row")
    else:
        d = torch.zeros(3, 128, dtype=torch.uint8)
        with pytest.raises(ValueError, match="two_pass"):
            matchk.best2_l2(d, d, torch.ones(3, dtype=torch.bool), two_pass="yes")


def test_build_scale_space_is_element_zero(scene128):
    """build_scale_space returns the octaves of build_scale_space_and_masks,
    fused or not; unfused configs have no masks."""
    img = torch.from_numpy(scene128)
    for cfg in (FUSED, SiftConfig(), SiftConfig(mask_backend="fused", conv_backend="xla")):
        octs, masks = build_scale_space_and_masks(img, cfg)
        assert (masks is not None) == (cfg is FUSED)
        for (a, b), (c, d) in zip(build_scale_space(img, cfg), octs):
            assert torch.equal(a, c) and torch.equal(b, d)
