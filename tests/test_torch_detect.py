"""Detection parity: extrema masks (the plain stencil and K8), K3 and K10a
compaction, K4 and K10b refinement (plain versions, as the wrappers run
them on the CPU) and the plain detection of kp_backend="xla" against the
JAX package, its Pallas kernels in interpret mode, on the same DoGs and
candidates."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.models.sift import octave_capacities as j_caps
from sift_pyocl_tpu.ops import detect as jd
from sift_pyocl_tpu.ops.pallas.compact import compact_mask_pallas
from sift_pyocl_tpu.ops.pallas.compact import compact_masks_multi as j_compact
from sift_pyocl_tpu.ops.pallas.maskk import extrema_masks_atlas_pallas
from sift_pyocl_tpu.ops.pallas.refine import (build_dog_atlas, pad_dogs, refine_atlas_pallas,
                                              refine_pallas)
from sift_pyocl_tpu.ops.pyramid import build_scale_space_jax

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops import detect as td
from sift_pyocl_tpu_torch.ops.kernels.compact import (MAX_PER_TILE, TILE, compact_mask,
                                                      compact_masks_multi,
                                                      compact_masks_multi_ref)
from sift_pyocl_tpu_torch.ops.kernels.maskk import extrema_masks, extrema_masks_ref
from sift_pyocl_tpu_torch.ops.kernels.refine import (refine_candidates_ref, refine_multi,
                                                     refine_octave)
from sift_pyocl_tpu_torch.utils.convert import to_torch
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def dogs160(scene160):
    cfg = JaxConfig(conv_backend="xla", kp_per_octave_cap=256)
    return cfg, [np.asarray(d) for _, d in build_scale_space_jax(jnp.asarray(scene160), cfg)]


def _random_masks(case: str = "random"):
    """(masks, caps) of a compaction case: "random", three octaves with a
    dense tile and a cut at the cap; "tile_edges", a 10-tile mask whose
    tiles 1 and 2 hold exactly 128 and 129 set bits and whose cap ends
    exactly at the end of tile 4, beside a small second octave."""
    if case == "random":
        rng = np.random.default_rng(5)
        a = rng.random((3, 100, 150)) < 0.001
        a[0, :10, :50] = True            # 500 bits in tile 0: past MAX_PER_TILE
        b = rng.random((3, 50, 75)) < 0.004
        c = rng.random((2, 40, 70)) < 0.03   # ~170 bits, cap 64: overflows its cap
        return [a, b, c], [256, 128, 64]
    rng = np.random.default_rng(8)
    a = rng.random((7, 313, 137)) < 0.001           # 300167 elements: 10 tiles
    flat = a.reshape(-1)
    for t, n in ((1, 128), (2, 129)):
        flat[t * TILE:(t + 1) * TILE] = False
        flat[t * TILE + rng.choice(TILE, n, replace=False)] = True
    kept = np.minimum(np.add.reduceat(flat, np.arange(0, flat.size, TILE)), MAX_PER_TILE)
    b = rng.random((3, 60, 90)) < 0.01
    return [a, b], [int(kept[:5].sum()), 40]


@pytest.mark.parametrize("case", ["random", "tile_edges"])
def test_compaction_matches_jax_kernel(case):
    """Exact: same indices in np.nonzero order, same written and total."""
    masks, caps = _random_masks(case)
    idx, wr, tot = (np.asarray(x) for x in
                    j_compact([jnp.asarray(m) for m in masks], caps, interpret=True))
    got_idx, got_wr, got_tot = compact_masks_multi([torch.from_numpy(m) for m in masks], caps)
    np.testing.assert_array_equal(got_wr.numpy(), wr)
    np.testing.assert_array_equal(got_tot.numpy(), tot)
    off = 0
    for o, (m, cap) in enumerate(zip(masks, caps)):
        w = int(wr[o])
        np.testing.assert_array_equal(got_idx.numpy()[off:off + w], idx[off:off + w])
        assert not got_idx.numpy()[off + w:off + cap].any()   # zeros after written
        off += cap
    if case == "random":   # the dense tile and the capacity cut were both exercised
        assert int(tot[0]) > int(wr[0]) >= MAX_PER_TILE and int(wr[2]) == caps[2]
    else:                  # the cap fell on a tile's end, past two full tiles
        assert int(wr[0]) == caps[0] and int(tot[0]) == int(masks[0].sum()) > caps[0]
        assert masks[0].size > 9 * TILE


def test_compaction_plain_version_semantics():
    """Against np.nonzero directly, where no tile overflows."""
    rng = np.random.default_rng(7)
    m = rng.random((4, 90, 101)) < 0.002
    idx, wr, tot = compact_masks_multi_ref([torch.from_numpy(m)], [512])
    want = np.nonzero(m.reshape(-1))[0]
    assert int(tot[0]) == int(wr[0]) == len(want)
    np.testing.assert_array_equal(idx.numpy()[: len(want)], want)


@pytest.mark.parametrize("double", [False, True])
def test_extrema_mask_matches_jax(dogs160, double):
    """Exact (comparisons only), every octave; with double_im_size octave 1
    takes edge_thresh1 too (octsize <= 1 rule)."""
    _, dogs = dogs160
    cfg = dict(double_im_size=double)
    total = 0
    for o, d in enumerate(dogs):
        want = np.asarray(jd.extrema_mask(jnp.asarray(d), JaxConfig(**cfg), o))
        got = td.extrema_mask(to_torch(d), SiftConfig(**cfg), o).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"octave {o}")
        total += want.sum()
    assert total > 5
    assert td.octave_edge_thresh(SiftConfig(double_im_size=True), 1) == SiftConfig().edge_thresh1


def _jax_atlas_refine(dogs, masks, caps, cfg):
    """K4's reference: the JAX compaction (interpret mode), its decode and
    refine_atlas_pallas in interpret mode.  Returns the compaction's
    (idx, written), the decoded (s, valid), the JAX outputs (fs, fr, fc,
    peak, accept) with fr octave-local, and the ulp of the largest atlas row
    a kept candidate refined to."""
    jdogs = [jnp.asarray(d) for d in dogs]
    jmasks = [jnp.asarray(m) for m in masks]
    idx, written, _ = j_compact(jmasks, caps, interpret=True)
    atlas, row_starts = build_dog_atlas(jdogs)
    s, r_a, c, valid, rlo, rhi, clo, chi = jd.decode_compacted(
        jdogs, jmasks, caps, row_starts, idx, written, cfg.border_dist)
    want = [np.asarray(x) for x in refine_atlas_pallas(
        atlas, s, r_a, c, valid, rlo, rhi, clo, chi, peak_thresh=cfg.peak_thresh,
        max_moves=cfg.max_interp_moves, interpret=True)]
    kept = np.asarray(valid) & (want[4] > 0)
    # The JAX kernel adds the row offset to an ATLAS row and the caller
    # subtracts the octave's start afterwards, so its fr carries one f32
    # rounding at the atlas row's magnitude; the port's octave rows do not.
    atlas_ulp = float(np.spacing(np.float32(want[1][kept].max()))) if kept.any() else 0.0
    want[1] = want[1] - np.repeat(row_starts, caps)
    return ((np.array(idx), np.array(written)), (np.asarray(s), np.asarray(valid)), want,
            atlas_ulp)


def _assert_refined_like_jax(got, s, v, want, fr_atol, label=""):
    """The port's (s_int, fs, fr, fc, peak, keep) against the JAX kernel's
    outputs: keep equal to accept at valid slots and False elsewhere, s_int
    the decode's, fs/fc/peak within 1e-5 and fr within `fr_atol` at kept
    slots.  Returns the number of kept slots."""
    got = [x.numpy() for x in got]
    assert got[5].dtype == np.bool_
    np.testing.assert_array_equal(got[5][v], want[4][v] > 0, err_msg=label)
    assert not got[5][~v].any(), label
    np.testing.assert_array_equal(got[0][v], s[v], err_msg=label)
    acc = v & (want[4] > 0)
    for f, g, w in zip(("fs", "fr", "fc", "peak"), got[1:5], want[:4]):
        np.testing.assert_allclose(g[acc], w[acc], atol=fr_atol if f == "fr" else 1e-5, rtol=0,
                                   err_msg=f"{label} {f}")
    return int(acc.sum())


def test_refinement_matches_jax_kernel(dogs160, scene160):
    """K4's plain version, fed the JAX compaction's idx/written as they are,
    against refine_atlas_pallas on the JAX decode: same accepts; fs/fc/peak
    within 1e-5 and fr within one atlas-row ulp (the port follows the
    Pallas kernel's operation order; XLA on the CPU may still fuse
    differently)."""
    cfg, dogs = dogs160
    caps = [c for c, _ in j_caps(scene160.shape, cfg)]
    masks = [np.asarray(jd.extrema_mask(jnp.asarray(d), cfg, o)) for o, d in enumerate(dogs)]
    (idx, written), (s, v), want, atlas_ulp = _jax_atlas_refine(dogs, masks, caps, cfg)
    got = refine_multi(to_torch(dogs), [torch.from_numpy(np.array(m)) for m in masks], caps,
                       torch.from_numpy(idx), torch.from_numpy(written), cfg.border_dist,
                       cfg.peak_thresh, cfg.max_interp_moves)
    assert v.sum() > 5
    assert _assert_refined_like_jax(got, s, v, want, max(1e-5, atlas_ulp)) > 5


def _edge_octaves(cfg):
    """Three odd-sized DoG octaves (5 planes) and masks for K4/K10b's edge
    cases: octave 0 a quadratic bowl centred outside the plane (plus noise),
    so moves run into the clamp, with its mask's four border rows and
    columns set (candidates on the clamp border) and more set bits than
    its cap (written == cap); octave 1 an empty mask (written == 0);
    octave 2 noise with a sparse mask.  Returns (dogs, masks, caps)."""
    rng = np.random.default_rng(17)
    bd = cfg.border_dist
    shapes = [(5, 37, 53), (5, 23, 19), (5, 17, 29)]
    dogs, masks = [], []
    for o, (S, H, W) in enumerate(shapes):
        noise = rng.normal(0, 4.0 if o == 2 else 0.05, (S, H, W))
        if o == 0:
            s_, r_, c_ = np.meshgrid(np.arange(S), np.arange(H), np.arange(W), indexing="ij")
            bowl = 0.2 * ((r_ + 9.0) ** 2 + (c_ - W - 7.0) ** 2) - 3.0 * (s_ - 2.2) ** 2
            noise = bowl + noise
        dogs.append(noise.astype(np.float32))
        m = np.zeros((S - 2, H - 2 * bd, W - 2 * bd), bool)
        if o == 0:
            m[:, [0, -1], :] = True
            m[:, :, [0, -1]] = True
        elif o == 2:
            m = rng.random(m.shape) < 0.05
        masks.append(m)
    return dogs, masks, [64, 16, 48]


def test_refinement_edge_cases_match_jax_kernel():
    """K4's plain version against refine_atlas_pallas (interpret mode) on
    odd octave sizes, an octave at written == cap (its mask overflows),
    one at written == 0, and candidates on the clamp border that the moves
    push against it; K10b's against refine_pallas(pad_dogs(...)) on each
    octave alone."""
    cfg = JaxConfig(kp_per_octave_cap=256)
    dogs, masks, caps = _edge_octaves(cfg)
    bd = cfg.border_dist
    (idx, written), (s, v), want, atlas_ulp = _jax_atlas_refine(dogs, masks, caps, cfg)
    assert written.tolist()[:2] == [caps[0], 0] and 0 < written[2] < caps[2]
    got = refine_multi(to_torch(dogs), [torch.from_numpy(np.array(m)) for m in masks], caps,
                       torch.from_numpy(idx), torch.from_numpy(written), bd, cfg.peak_thresh,
                       cfg.max_interp_moves)
    assert _assert_refined_like_jax(got, s, v, want, max(1e-5, atlas_ulp), "K4") > 5
    for o, (d, m, cap) in enumerate(zip(dogs, masks, caps)):
        jidx, jwr, _ = compact_mask_pallas(jnp.asarray(m), cap, interpret=True)
        tidx, twr = torch.from_numpy(np.array(jidx)), torch.from_numpy(np.array(jwr))
        s1, r1, c1, v1 = td.decode_compacted([to_torch(d)], [torch.from_numpy(m)], [cap], tidx,
                                             twr, bd)
        want1 = [np.asarray(x) for x in refine_pallas(
            pad_dogs(jnp.asarray(d)), *(jnp.asarray(t.numpy()) for t in (s1, r1, c1, v1)),
            H=d.shape[1], W=d.shape[2], bd=bd, peak_thresh=cfg.peak_thresh,
            max_moves=cfg.max_interp_moves, interpret=True)]
        got1 = refine_octave(to_torch(d), torch.from_numpy(m), tidx, twr, bd, cfg.peak_thresh,
                             cfg.max_interp_moves)
        _assert_refined_like_jax(got1, s1.numpy(), v1.numpy(), want1, 1e-5, f"K10b octave {o}")


def test_decode_and_detect_all_octaves(dogs160, scene160):
    """decode_compacted gives the JAX decode's (s, r, c, valid) with octave
    rows; detect_all_octaves counts every true extremum."""
    cfg, dogs = dogs160
    tcfg = SiftConfig(**dataclasses.asdict(cfg))
    caps = [c for c, _ in j_caps(scene160.shape, cfg)]
    tdogs = to_torch(dogs)
    masks = [td.extrema_mask(d, tcfg, o) for o, d in enumerate(tdogs)]
    idx, written, total = compact_masks_multi(masks, caps)
    s, r, c, valid = td.decode_compacted(tdogs, masks, caps, idx, written, cfg.border_dist)
    jdogs = [jnp.asarray(d) for d in dogs]
    _, row_starts = build_dog_atlas(jdogs)
    js, jr, jc, jv, *_ = (np.asarray(x) for x in jd.decode_compacted(
        jdogs, [jnp.asarray(m.numpy()) for m in masks], caps, row_starts,
        jnp.asarray(idx.numpy()), jnp.asarray(written.numpy()), cfg.border_dist))
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_array_equal(s.numpy()[jv], js[jv])
    np.testing.assert_array_equal(r.numpy()[jv], (jr - np.repeat(row_starts, caps))[jv])
    np.testing.assert_array_equal(c.numpy()[jv], jc[jv])
    out = td.detect_all_octaves(tdogs, tcfg, caps)
    assert [int(t) for _, t in out] == [int(m.sum()) for m in masks]
    assert sum(int(k.valid.sum()) for k, _ in out) > 5


def test_mask_kernel_backends_are_not_ported_yet(dogs160, scene160):
    """Every mask backend is ported: with mask_backend="fused",
    detect_all_octaves takes the ladders' masks as given, the stencil for a
    None entry and for no masks at all (as the JAX package does when its
    ladders did not run), and counts the JAX package's extrema and accepts
    (detect_all_octaves_pallas with the same masks, interpret mode); an
    unknown backend is an error."""
    cfg, dogs = dogs160
    caps = [c for c, _ in j_caps(scene160.shape, cfg)]
    tdogs = to_torch(dogs)
    fused = SiftConfig(**{**dataclasses.asdict(cfg), "mask_backend": "fused"})
    masks = [td.extrema_mask(d, fused, o) for o, d in enumerate(tdogs)]
    plain = td.detect_all_octaves(tdogs, SiftConfig(**dataclasses.asdict(cfg)), caps)
    for given in (None, masks, [None] + masks[1:]):
        out = td.detect_all_octaves(tdogs, fused, caps, masks=given)
        for (k, t), (pk, pt) in zip(out, plain):
            assert int(t) == int(pt)
            for a, b in zip(k, pk):
                assert torch.equal(a, b)
    jcfg = JaxConfig(**{**dataclasses.asdict(cfg), "mask_backend": "fused"})
    jout = jd.detect_all_octaves_pallas(
        [jnp.asarray(d) for d in dogs], jcfg, caps, interpret=True,
        masks=[None] + [jnp.asarray(m.numpy()) for m in masks[1:]])
    assert [int(t) for _, t in jout] == [int(t) for _, t in plain]
    assert [int(np.asarray(k.valid).sum()) for k, _ in jout] == \
        [int(k.valid.sum()) for k, _ in plain]
    assert sum(int(t) for _, t in plain) > 5
    with pytest.raises(ValueError, match="mask_backend"):
        td.octave_masks(to_torch(dogs), SiftConfig(mask_backend="stencil"))


@pytest.mark.parametrize("double", [False, True])
def test_mask_kernel_plain_version_matches_jax_atlas_kernel(dogs160, double):
    """K8's plain version (what the wrapper runs on the CPU) against
    extrema_masks_atlas_pallas in interpret mode: exact on every octave,
    also under double_im_size's edge-threshold rule."""
    _, dogs = dogs160
    jcfg, tcfg = JaxConfig(double_im_size=double), SiftConfig(double_im_size=double)
    atlas, row_starts = build_dog_atlas([jnp.asarray(d) for d in dogs])
    want = extrema_masks_atlas_pallas(atlas, row_starts, [d.shape for d in dogs], jcfg,
                                      interpret=True)
    got = extrema_masks(to_torch(dogs), tcfg)
    assert len(got) == len(want) == len(dogs)
    for o, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"octave {o}")
    assert sum(int(np.asarray(w).sum()) for w in want) > 5
    for g, r in zip(got, extrema_masks_ref(to_torch(dogs), tcfg)):
        assert torch.equal(g, r)


def test_mask_backends_detect_the_same(dogs160, scene160):
    """detect_all_octaves gives the same keypoints with the plain stencil
    and with K8 (its plain version here)."""
    cfg, dogs = dogs160
    caps = [c for c, _ in j_caps(scene160.shape, cfg)]
    tdogs = to_torch(dogs)
    a = td.detect_all_octaves(tdogs, SiftConfig(kp_per_octave_cap=256), caps)
    b = td.detect_all_octaves(tdogs, SiftConfig(kp_per_octave_cap=256, mask_backend="pallas"),
                              caps)
    for (ka, ta), (kb, tb) in zip(a, b):
        assert int(ta) == int(tb)
        for x, y in zip(ka, kb):
            assert torch.equal(x, y)


def _single_masks():
    rng = np.random.default_rng(11)
    dense = rng.random((3, 100, 150)) < 0.002
    dense[1, 20:30, 100:150] = True      # 500 bits in one tile: past MAX_PER_TILE
    crowded = rng.random((2, 40, 70)) < 0.03   # ~170 bits for a cap of 64
    return {"dense_tile": (dense, 256), "cap_cut": (crowded, 64)}


@pytest.mark.parametrize("case", ["dense_tile", "cap_cut"])
def test_single_mask_compaction_matches_jax_kernel(case):
    """K10a's plain version against compact_mask_pallas in interpret mode:
    exact idx[:written], written and total."""
    mask, cap = _single_masks()[case]
    idx, written, total = (np.asarray(x) for x in
                           compact_mask_pallas(jnp.asarray(mask), cap, interpret=True))
    got_idx, got_wr, got_tot = compact_mask(torch.from_numpy(mask), cap)
    assert got_idx.shape == (cap,) and got_wr.shape == got_tot.shape == ()
    assert int(got_wr) == int(written) and int(got_tot) == int(total)
    np.testing.assert_array_equal(got_idx.numpy()[: int(written)], idx[: int(written)])
    assert not got_idx.numpy()[int(written):].any()
    if case == "dense_tile":
        assert int(total) > int(written) >= MAX_PER_TILE
    else:
        assert int(written) == cap < int(total)


def test_octave_refinement_matches_jax_kernel(dogs160):
    """K10b's plain version, fed K10a's idx/written as they are, against
    refine_pallas(pad_dogs(...)) in interpret mode on the decoded
    candidates of the octave that has the most: same accepts, floats
    within the 1e-5 of the atlas test (fr included: both are octave
    rows)."""
    cfg, dogs = dogs160
    tcfg = SiftConfig(**dataclasses.asdict(cfg))
    masks = [td.extrema_mask(to_torch(d), tcfg, o) for o, d in enumerate(dogs)]
    o = max(range(len(dogs)), key=lambda i: int(masks[i].sum()))
    d, mask = dogs[o], masks[o]
    _, H, W = d.shape
    bd, cap = cfg.border_dist, 256
    idx, written, _ = compact_mask(mask, cap)
    s, r, c, valid = td.decode_compacted([to_torch(d)], [mask], [cap], idx, written, bd)
    want = [np.asarray(x) for x in refine_pallas(
        pad_dogs(jnp.asarray(d)), *(jnp.asarray(t.numpy()) for t in (s, r, c, valid)),
        H=H, W=W, bd=bd, peak_thresh=cfg.peak_thresh, max_moves=cfg.max_interp_moves,
        interpret=True)]
    got = refine_octave(to_torch(d), mask, idx, written, bd, cfg.peak_thresh,
                        cfg.max_interp_moves)
    v = valid.numpy()
    assert v.sum() > 5
    assert _assert_refined_like_jax(got, s.numpy(), v, want, 1e-5) > 5


def _detect_before(tdogs, tcfg, caps):
    """detect_all_octaves and detect_octave_pallas as they were composed
    before the refinement took the compaction's output: the plain masks
    and compactions, decode_compacted and the plain refinement of the
    decoded candidates, keep = accept & valid per octave."""
    bd = tcfg.border_dist
    masks = [td.extrema_mask(d, tcfg, o) for o, d in enumerate(tdogs)]
    idx, written, total = compact_masks_multi_ref(masks, caps)
    s, r, c, valid = td.decode_compacted(tdogs, masks, caps, idx, written, bd)
    multi, single = [], []
    off = 0
    for o, (d, cap) in enumerate(zip(tdogs, caps)):
        sl = slice(off, off + cap)
        off += cap
        fs, fr, fc, peak, acc = refine_candidates_ref(d, s[sl], r[sl], c[sl], valid[sl], bd,
                                                      tcfg.peak_thresh, tcfg.max_interp_moves)
        multi.append((td.RefinedKeypoints(s[sl], fs, fr, fc, peak, acc & valid[sl]), total[o]))
        i1, w1, t1 = compact_mask(masks[o], cap)
        s1, r1, c1, v1 = td.decode_compacted([d], [masks[o]], [cap], i1, w1.reshape(1), bd)
        fs, fr, fc, peak, acc = refine_candidates_ref(d, s1, r1, c1, v1, bd, tcfg.peak_thresh,
                                                      tcfg.max_interp_moves)
        single.append((td.RefinedKeypoints(s1, fs, fr, fc, peak, acc & v1), t1))
    return multi, single


def test_detection_bits_unchanged(dogs160, scene160):
    """detect_all_octaves and detect_octave_pallas (plain versions, as on the
    CPU) give the same bits as the decode-then-refine composition they
    replace, octave by octave, field by field; the multi-launch path's
    whole-slot outputs are those octaves end to end."""
    cfg, dogs = dogs160
    tcfg = SiftConfig(**dataclasses.asdict(cfg))
    caps = [c for c, _ in j_caps(scene160.shape, cfg)]
    tdogs = to_torch(dogs)
    multi, single = _detect_before(tdogs, tcfg, caps)
    got = td.detect_all_octaves(tdogs, tcfg, caps)
    whole, total = td.detect_all_slots(tdogs, tcfg, caps)
    assert len(got) == len(multi) == len(dogs)
    for o, ((k, t), (bk, bt)) in enumerate(zip(got, multi)):
        assert int(t) == int(bt) == int(total[o])
        for f, a, b in zip(k._fields, k, bk):
            assert a.dtype == b.dtype and torch.equal(a, b), f"octave {o}: {f}"
    for f, a, parts in zip(whole._fields, whole, zip(*(k for k, _ in multi))):
        assert torch.equal(a, torch.cat(parts)), f
    for o, (d, cap) in enumerate(zip(tdogs, caps)):
        k, t = td.detect_octave_pallas(d, tcfg, o, cap)
        bk, bt = single[o]
        assert int(t) == int(bt)
        for f, a, b in zip(k._fields, k, bk):
            assert a.dtype == b.dtype and torch.equal(a, b), f"per-octave {o}: {f}"
    assert sum(int(k.valid.sum()) for k, _ in got) > 5


def test_refine_wrappers_check_the_compaction_layout(dogs160):
    """The wrappers refuse masks of another shape than the (S-2, H-2bd,
    W-2bd) the in-thread decode assumes, idx or written of the wrong type
    or length, and a border of 0."""
    cfg, dogs = dogs160
    tcfg = SiftConfig(**dataclasses.asdict(cfg))
    d = to_torch(dogs[0])
    bd = tcfg.border_dist
    mask = td.extrema_mask(d, tcfg, 0)
    idx, written, _ = compact_mask(mask, 64)
    args = (tcfg.peak_thresh, tcfg.max_interp_moves)
    with pytest.raises(ValueError, match="mask"):
        refine_octave(d, mask[:, 1:], idx, written, bd, *args)
    with pytest.raises(ValueError, match="idx"):
        refine_octave(d, mask, idx.long(), written, bd, *args)
    with pytest.raises(ValueError, match="written"):
        refine_multi([d], [mask], [64], idx, torch.zeros(2, dtype=torch.int32), bd, *args)
    with pytest.raises(ValueError, match="border"):
        refine_octave(d, mask, idx, written, 0, *args)
    out = refine_octave(d, mask, idx, written, bd, *args)
    assert [t.dtype for t in out] == [torch.int32] + [torch.float32] * 4 + [torch.bool]


def test_wrappers_refuse_other_devices():
    m = torch.zeros(4, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        compact_masks_multi([m], [64])


def test_plain_compaction_matches_jax(dogs160):
    """compact_extrema (the kp_backend="xla" path) against the JAX
    function: exact (s, r, c, valid, count), also when the octave overflows
    its capacity (no per-tile limit on this path)."""
    cfg, _ = dogs160
    tcfg = SiftConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(13)
    mask = rng.random((3, 60, 90)) < 0.02
    mask[1, :4, :] = True                  # 360 bits in a row
    for cap in (64, 2048):
        want = jd.compact_extrema(jnp.asarray(mask), cfg, cap)
        got = td.compact_extrema(torch.from_numpy(mask), tcfg, cap)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f"cap {cap}: {f}")


def test_plain_detect_octave_matches_jax(dogs160):
    """The XLA detect_octave, octave by octave: accepts exact, floats within
    1e-5 (the adjugate solve in the JAX XLA function's order;
    tests/test_pallas.py:78-84)."""
    cfg, dogs = dogs160
    tcfg = SiftConfig(**dataclasses.asdict(cfg))
    n_acc = 0
    for o, d in enumerate(dogs):
        want = jd.detect_octave(jnp.asarray(d), cfg, o, 128)
        got = td.detect_octave(to_torch(d), tcfg, o, 128)
        acc = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), acc, err_msg=f"octave {o}")
        np.testing.assert_array_equal(got.s_int.numpy(), np.asarray(want.s_int))
        for f in ("fs", "fr", "fc", "peak"):
            np.testing.assert_allclose(getattr(got, f).numpy()[acc], np.asarray(getattr(want, f))[acc],
                                       atol=1e-5, rtol=0, err_msg=f"octave {o}: {f}")
        n_acc += int(acc.sum())
    assert n_acc > 5


def test_plain_and_kernel_detection_agree(dogs160):
    """detect_octave (plain, adjugate solve) and detect_octave_pallas (K10a,
    K10b; plain versions here) accept the same keypoints where no octave
    overflows a tile, at floats within 1e-5."""
    cfg, dogs = dogs160
    tcfg = SiftConfig(**dataclasses.asdict(cfg))
    for o, d in enumerate(dogs):
        a = td.detect_octave(to_torch(d), tcfg, o, 128)
        b, total = td.detect_octave_pallas(to_torch(d), tcfg, o, 128)
        assert int(total) == int(td.extrema_mask(to_torch(d), tcfg, o).sum())
        assert torch.equal(a.valid, b.valid) and torch.equal(a.s_int[a.valid], b.s_int[b.valid])
        for f in ("fs", "fr", "fc", "peak"):
            np.testing.assert_allclose(getattr(a, f)[a.valid].numpy(), getattr(b, f)[b.valid].numpy(),
                                       atol=1e-5, rtol=0)
