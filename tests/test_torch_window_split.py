"""K11a and K11b, the split orientation and descriptor histograms, and the
plain orientation / descriptor path of ``kp_backend="xla"``: the port's
entry points (kernel wrappers on the CPU run their plain versions) against
the JAX package's on the same padded gradient planes and keypoints, its
Pallas kernels in interpret mode, on octave 1 of scene128 (where its blobs
put most extrema; ``tests/test_pallas.py:104-115``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.ops import orient_desc as jod
from sift_pyocl_tpu.ops.detect import detect_octave
from sift_pyocl_tpu.ops.pallas.window import (descriptor_hist_pallas, orientation_hist_pallas,
                                              pad_grad_planes)
from sift_pyocl_tpu.ops.pyramid import build_scale_space_jax

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops import orient_desc as tod
from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts, window
from sift_pyocl_tpu_torch.utils.convert import (oriented_keypoints_from_jax,
                                                refined_keypoints_from_jax, to_torch)
from _torch_threads import _one_torch_thread  # noqa: F401

CFG = dict(kp_per_octave_cap=256)


@pytest.fixture(scope="module")
def octave1(scene128):
    """JAX gradient planes (plain and padded) and refined keypoints of
    octave 1, with the port's copies of each."""
    cfg = JaxConfig(**CFG)
    blurs, dogs = build_scale_space_jax(jnp.asarray(scene128), cfg)[1]
    kps = detect_octave(dogs, cfg, 1, 64)
    mags, oris = jod.gradient_planes(blurs, cfg)
    mag_p, ori_p = pad_grad_planes(mags, oris)
    port = dict(mags=to_torch(np.asarray(mags)), oris=to_torch(np.asarray(oris)),
                mag_p=to_torch(np.asarray(mag_p)), ori_p=to_torch(np.asarray(ori_p)),
                kps=refined_keypoints_from_jax(kps))
    assert int(np.asarray(kps.valid).sum()) > 5
    return cfg, dict(mags=mags, oris=oris, mag_p=mag_p, ori_p=ori_p, kps=kps), port


def _rows(o):
    """The valid slots' (s, fr, fc, angle) rows, sorted: slot orders differ
    between the dense (o-major) and compacted (keypoint-major) layouts."""
    m = np.asarray(o.valid)
    r = np.stack([np.asarray(o.s_int)[m].astype(np.float32), np.asarray(o.fr)[m],
                  np.asarray(o.fc)[m], np.asarray(o.angle)[m]], axis=1)
    return r[np.lexsort(r.T[::-1])]


def test_pad_grad_planes_matches_jax(octave1):
    _, j, t = octave1
    mp, op = tod.pad_grad_planes(t["mags"], t["oris"])
    np.testing.assert_array_equal(mp.numpy(), np.asarray(j["mag_p"]))
    np.testing.assert_array_equal(op.numpy(), np.asarray(j["ori_p"]))


def test_orientation_hist_matches_jax_kernel(octave1):
    """K11a's plain version against orientation_hist_pallas: within 1e-6 of
    the largest bin (about 8 f32 ulps of it; each bin sums up to win^2
    weighted samples in another order than Pallas), zeros for invalid
    slots, no launch on the CPU."""
    cfg, j, t = octave1
    kps, win = j["kps"], jod._ori_window_size(cfg)
    sigma = cfg.init_sigma * 2.0 ** (kps.fs / cfg.scales)
    want = np.asarray(orientation_hist_pallas(j["mag_p"], j["ori_p"], kps.s_int, kps.fr, kps.fc,
                                              sigma, kps.valid, win=win, interpret=True))
    tk = t["kps"]
    reset_launch_counts()
    got = window.orientation_hist(t["mag_p"], t["ori_p"], tk.s_int, tk.fr, tk.fc,
                                  to_torch(np.asarray(sigma)), tk.valid, win).numpy()
    assert sum(launch_counts().values()) == 0
    assert got.shape == want.shape == (64, 36) and want.max() > 10
    np.testing.assert_allclose(got, want, atol=1e-6 * want.max(), rtol=0)
    assert not got[~np.asarray(kps.valid)].any()


def test_assign_orientations_pallas_matches_jax(octave1):
    """Same count, the same dense slot order (valid masks equal, slot
    cap*o + i), angles within 1e-4."""
    cfg, j, t = octave1
    want = jod.assign_orientations_pallas(j["mag_p"], j["ori_p"], j["kps"], cfg, interpret=True)
    got = tod.assign_orientations_pallas(t["mag_p"], t["ori_p"], t["kps"], SiftConfig(**CFG))
    assert int(got.count) == int(want.count) > 5
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(_rows(got), _rows(want), atol=1e-4, rtol=0)


def test_compute_descriptors_pallas_matches_jax(octave1):
    """On the same oriented keypoints (JAX's dense slots): u8 descriptors
    within 1 count, mean difference < 0.05 (tests/test_pallas.py:172); the
    raw histograms of K11b's plain version against descriptor_hist_pallas
    within 1e-3 relative to the largest bin."""
    cfg, j, t = octave1
    okps = jod.assign_orientations_pallas(j["mag_p"], j["ori_p"], j["kps"], cfg, interpret=True)
    m = np.asarray(okps.valid)
    want = np.asarray(jod.compute_descriptors_pallas(j["mag_p"], j["ori_p"], okps, cfg,
                                                     interpret=True))
    tok = oriented_keypoints_from_jax(okps)
    got = tod.compute_descriptors_pallas(t["mag_p"], t["ori_p"], tok, SiftConfig(**CFG)).numpy()
    diff = np.abs(got[m].astype(int) - want[m].astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.05
    assert not got[~m].any()
    sigma = cfg.init_sigma * 2.0 ** (okps.fs / cfg.scales)
    win = jod._desc_window_size(cfg)
    raw_j = np.asarray(descriptor_hist_pallas(j["mag_p"], j["ori_p"], okps.s_int, okps.fr,
                                              okps.fc, sigma, okps.angle, okps.valid, win=win,
                                              interpret=True))
    raw_t = window.descriptor_hist(t["mag_p"], t["ori_p"], tok.s_int, tok.fr, tok.fc,
                                   to_torch(np.asarray(sigma)), tok.angle, tok.valid, win).numpy()
    np.testing.assert_allclose(raw_t[m], raw_j[m], atol=1e-3 * np.abs(raw_j).max(), rtol=0)


def test_plain_orientations_and_descriptors_match_jax_xla(octave1):
    """The kp_backend="xla" functions against the JAX package's: the same
    count and compacted slot order (dcap 96, keypoint-major nonzero order),
    angles within 1e-4, u8 descriptors within 1 count (mean < 0.05)."""
    cfg, j, t = octave1
    tcfg = SiftConfig(**CFG)
    want = jod.assign_orientations(j["mags"], j["oris"], j["kps"], cfg, dcap=96)
    got = tod.assign_orientations(t["mags"], t["oris"], t["kps"], tcfg, 96)
    assert int(got.count) == int(want.count) > 5
    m = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), m)
    for f in ("s_int", "fs", "fr", "fc"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[m], np.asarray(getattr(want, f))[m])
    np.testing.assert_allclose(got.angle.numpy()[m], np.asarray(want.angle)[m], atol=1e-4)
    dj = np.asarray(jod.compute_descriptors(j["mags"], j["oris"], want, cfg))
    dt = tod.compute_descriptors(t["mags"], t["oris"], oriented_keypoints_from_jax(want),
                                 tcfg).numpy()
    diff = np.abs(dt[m].astype(int) - dj[m].astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.05


def test_orientation_compaction_overflow(octave1):
    """dcap smaller than the oriented count: the first dcap slots in
    keypoint-major order, count still the true number (as
    jnp.nonzero(size=dcap))."""
    cfg, j, t = octave1
    want = jod.assign_orientations(j["mags"], j["oris"], j["kps"], cfg, dcap=4)
    got = tod.assign_orientations(t["mags"], t["oris"], t["kps"], SiftConfig(**CFG), 4)
    assert int(got.count) == int(want.count) > 4
    assert bool(got.valid.all())
    np.testing.assert_array_equal(got.fr.numpy(), np.asarray(want.fr))
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle), atol=1e-4)


def test_split_path_agrees_with_fused_kernel_path(octave1):
    """K11a then K11b against K6 (plain versions) on the same keypoints:
    the same oriented set, descriptors within 1 count."""
    cfg, _, t = octave1
    tcfg = SiftConfig(**CFG)
    split = tod.assign_orientations_pallas(t["mag_p"], t["ori_p"], t["kps"], tcfg)
    d_split = tod.compute_descriptors_pallas(t["mag_p"], t["ori_p"], split, tcfg)
    fused, d_fused = tod.orient_and_describe_fused(t["mags"], t["oris"], t["kps"], tcfg)
    assert int(split.count) == int(fused.count) > 5
    np.testing.assert_allclose(_rows(split), _rows(fused), atol=1e-4, rtol=0)

    def by_row(o, d):
        m = o.valid.numpy()
        r = np.stack([o.s_int.numpy()[m], o.fr.numpy()[m], o.fc.numpy()[m]], axis=1)
        order = np.lexsort(np.concatenate([r, o.angle.numpy()[m, None]], 1).T[::-1])
        return d.numpy()[m][order].astype(int)

    assert np.abs(by_row(split, d_split) - by_row(fused, d_fused)).max() <= 1


def test_split_wrappers_check_their_inputs(octave1):
    _, _, t = octave1
    k = t["kps"]
    small = torch.zeros(3, 100, 400)                  # smaller than its padding
    with pytest.raises(ValueError, match="padding"):
        window.orientation_hist(small, small, k.s_int, k.fr, k.fc, k.fs, k.valid, 48)
    with pytest.raises(ValueError, match="per-keypoint"):
        window.descriptor_hist(t["mag_p"], t["ori_p"], k.s_int, k.fr, k.fc, k.fs, k.fs[:3],
                               k.valid, 104)
