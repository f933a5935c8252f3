"""Detection parity: extrema mask, K3 compaction and K4 refinement (plain
versions, as the wrappers run them on the CPU) against the JAX package, its
Pallas kernels in interpret mode, on the same DoGs and candidates."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.models.sift import octave_capacities as j_caps
from sift_pyocl_tpu.ops import detect as jd
from sift_pyocl_tpu.ops.pallas.compact import compact_masks_multi as j_compact
from sift_pyocl_tpu.ops.pallas.refine import build_dog_atlas, refine_atlas_pallas
from sift_pyocl_tpu.ops.pyramid import build_scale_space_jax

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops import detect as td
from sift_pyocl_tpu_torch.ops.kernels.compact import (MAX_PER_TILE, compact_masks_multi,
                                                      compact_masks_multi_ref)
from sift_pyocl_tpu_torch.ops.kernels.refine import refine_multi
from sift_pyocl_tpu_torch.utils.convert import to_torch


@pytest.fixture(scope="module")
def dogs160(scene160):
    cfg = JaxConfig(conv_backend="xla", kp_per_octave_cap=256)
    return cfg, [np.asarray(d) for _, d in build_scale_space_jax(jnp.asarray(scene160), cfg)]


def _random_masks():
    rng = np.random.default_rng(5)
    a = rng.random((3, 100, 150)) < 0.001
    a[0, :10, :50] = True            # 500 bits in tile 0: past MAX_PER_TILE
    b = rng.random((3, 50, 75)) < 0.004
    c = rng.random((2, 40, 70)) < 0.03   # ~170 bits, cap 64: overflows its cap
    return [a, b, c], [256, 128, 64]


def test_compaction_matches_jax_kernel():
    """Exact: same indices in np.nonzero order, same written and total."""
    masks, caps = _random_masks()
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
    # the dense tile and the capacity cut were both exercised
    assert int(tot[0]) > int(wr[0]) >= MAX_PER_TILE and int(wr[2]) == caps[2]


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


def test_refinement_matches_jax_kernel(dogs160, scene160):
    """Same accepts; fs/fc/peak within 1e-5 and fr within one atlas-row ulp
    (the port follows the Pallas kernel's operation order; XLA on the CPU
    may still fuse differently)."""
    cfg, dogs = dogs160
    caps = [c for c, _ in j_caps(scene160.shape, cfg)]
    jdogs = [jnp.asarray(d) for d in dogs]
    masks = [jd.extrema_mask(d, cfg, o) for o, d in enumerate(jdogs)]
    idx, written, _ = j_compact(masks, caps, interpret=True)
    atlas, row_starts = build_dog_atlas(jdogs)
    s, r_a, c, valid, rlo, rhi, clo, chi = jd.decode_compacted(
        jdogs, masks, caps, row_starts, idx, written, cfg.border_dist)
    want = [np.asarray(x) for x in refine_atlas_pallas(
        atlas, s, r_a, c, valid, rlo, rhi, clo, chi, peak_thresh=cfg.peak_thresh,
        max_moves=cfg.max_interp_moves, interpret=True)]
    r_local = np.asarray(r_a) - np.repeat(row_starts, caps)
    got = [x.numpy() for x in refine_multi(
        to_torch(dogs), to_torch(np.asarray(s)), torch.from_numpy(r_local),
        to_torch(np.asarray(c)), to_torch(np.asarray(valid)), caps, cfg.border_dist,
        cfg.peak_thresh, cfg.max_interp_moves)]
    v = np.asarray(valid)
    assert v.sum() > 5
    np.testing.assert_array_equal(got[4][v], want[4][v])
    acc = v & (want[4] > 0)
    assert acc.sum() > 5
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_allclose(g[acc], w[acc], atol=1e-5, rtol=0)
    # The JAX kernel adds the row offset to an ATLAS row and the caller
    # subtracts the octave's start afterwards, so its fr carries one f32
    # rounding at the atlas row's magnitude; the port's octave rows do not.
    atlas_ulp = float(np.spacing(np.float32(want[1][acc].max())))
    want_fr = want[1] - np.repeat(row_starts, caps)
    np.testing.assert_allclose(got[1][acc], want_fr[acc], atol=max(1e-5, atlas_ulp), rtol=0)
    assert not got[4][~v].any()


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


def test_mask_kernel_backends_are_not_ported_yet(dogs160):
    _, dogs = dogs160
    with pytest.raises(NotImplementedError, match="K8"):
        td.detect_all_octaves(to_torch(dogs), SiftConfig(mask_backend="pallas"),
                              [64] * len(dogs))


def test_wrappers_refuse_other_devices():
    m = torch.zeros(4, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        compact_masks_multi([m], [64])
