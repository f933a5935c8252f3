"""Incremental SfM (BASELINE config 4): the port's sfm/pipeline.py against
the JAX package's, on rendered sequences (utils/render3d.py).

Drift between the two, and how each test holds it:
* ``jnp.nanmedian`` averages the two middle values where ``torch.nanmedian``
  returns the lower one; the bootstrap flow gate takes JAX's convention
  (``_nanmedian``, tested on an even count and through the probe).
* PnP draws: ``register_from_buffers`` is fed the draws JAX's
  ``ransac_pnp`` takes from its key, and the JAX package's detection
  buffer.
* The key stream: the JAX package splits one key a call, the port draws
  each call's seed from one CPU generator, so whole runs are held by
  outcome (tests/test_sfm_pipeline.py's fences, `slow` as there), not by
  bits, and the bootstrap's choice is held given JAX's two-view draws.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_pyocl_tpu.config as jcfg
from sift_pyocl_tpu.models.sift import detect_and_describe as j_detect
from sift_pyocl_tpu.ops.match import match_descriptors_jax as j_match
from sift_pyocl_tpu.sfm import geometry as jg
from sift_pyocl_tpu.sfm import pipeline as jpipe

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm.evaluate import ate_rmse, camera_centers
from sift_pyocl_tpu_torch.sfm.pipeline import IncrementalSfM, register_from_buffers
from sift_pyocl_tpu_torch.utils.convert import keypoint_buffer_from_jax
from sift_pyocl_tpu_torch.utils.render3d import render_sequence

from test_torch_sfm_geometry import jax_pnp_draws
from _torch_threads import _one_torch_thread  # noqa: F401

CFG = SiftConfig(kp_per_octave_cap=256)
JCFG = jcfg.SiftConfig(kp_per_octave_cap=256)


@pytest.fixture(scope="module")
def seq3():
    """Three frames 6 deg apart, and the JAX package's keypoint buffers."""
    K, frames, gtR, gtT = render_sequence(n_frames=3, n_points=70, image_size=(320, 240),
                                          seed=0, arc_deg=12.0)
    det = jax.jit(lambda f: j_detect(f, JCFG))
    return K, frames, gtR, gtT, [det(jnp.asarray(f)) for f in frames]


def _uv(buf):
    return np.stack([np.asarray(buf.x), np.asarray(buf.y)], -1)


def test_nanmedian_takes_the_jax_convention():
    """Even count: the mean of the two middle values (torch's nanmedian
    gives the lower); odd count, ties, none finite."""
    cases = [[3.0, np.nan, 1.0, 7.0, 2.0, np.nan], [5.0, 1.0, np.nan, 2.0], [2.0, 2.0, 9.0, 1.0],
             [np.nan, np.nan], [4.0]]
    for c in cases:
        x = np.asarray(c, np.float32)
        got = float(tpipe._nanmedian(torch.from_numpy(x)))
        want = float(jnp.nanmedian(jnp.asarray(x)))
        assert (np.isnan(got) and np.isnan(want)) or got == want, (c, got, want)
    assert float(tpipe._nanmedian(torch.tensor([1.0, 2.0, 4.0, 8.0]))) == 3.0


def test_register_from_buffers_matches_jax(seq3, monkeypatch):
    """Frame 1 registered against a map of frames 0 and 2 (their matches
    triangulated at the true poses), frame 0 as the previous frame, from
    the JAX package's detection buffer and with JAX's PnP draws: match and
    inlier counts, the keep / inlier rows, the new-point ok rows, their
    keypoints and descriptors equal; R and t within 1e-4, new points within
    1e-3."""
    K, frames, gtR, gtT, jbufs = seq3
    d0, d2 = jbufs[0], jbufs[2]
    m = j_match(d0.desc, d0.valid, d2.desc, d2.valid, ratio_sq=0.7)
    ok = np.asarray(m.valid)
    i0, i2 = np.asarray(m.idx1)[ok], np.asarray(m.idx2)[ok]
    X = np.asarray(jg.triangulate_two_view(
        jnp.asarray(K), jnp.asarray(gtR[0]), jnp.asarray(gtT[0]), jnp.asarray(K),
        jnp.asarray(gtR[2]), jnp.asarray(gtT[2]), jnp.asarray(_uv(d0)[i0]),
        jnp.asarray(_uv(d2)[i2]))[0])
    P = len(X)
    assert P >= 20
    args = [np.asarray(d0.desc)[i0], np.ones(P, bool), X, np.asarray(d0.desc), _uv(d0),
            np.asarray(d0.valid), gtR[0], gtT[0], gtR[0], gtT[0], K]
    key = jax.random.key(7)
    monkeypatch.setattr(jpipe, "detect_and_describe", lambda frame, cfg: jbufs[1])
    fused = jax.jit(functools.partial(jpipe.register_frame_fused.__wrapped__, cfg=JCFG,
                                      new_cap=256, ratio_sq=0.7, reproj_px=3.0, metric="L1"))
    packed = np.asarray(fused(jnp.asarray(frames[1]), key, *(jnp.asarray(a) for a in args))[0])
    head, rows, new = packed[0], packed[1:1 + P], packed[1 + P:]
    keep = rows[:, 0] > 0
    draws = [torch.from_numpy(np.array(d))
             for d in jax_pnp_draws(key, jnp.asarray(keep, jnp.float32))]
    got = register_from_buffers(keypoint_buffer_from_jax(jbufs[1]), 0,
                                *(torch.from_numpy(np.array(a)) for a in args),
                                new_cap=256, ratio_sq=0.7, reproj_px=3.0, metric="L1",
                                draws=draws)
    assert int(got.n_match) == int(head[13]) and int(got.n_inl) == int(head[12])
    assert int(head[12]) >= 10
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.inl.numpy(), rows[:, 1] > 0)
    np.testing.assert_array_equal(got.uv.numpy()[keep], rows[keep, 2:4])
    np.testing.assert_array_equal(got.desc.numpy()[keep], packed[1:1 + P, 8:][keep])
    np.testing.assert_allclose(got.R.numpy(), head[:9].reshape(3, 3), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), head[9:12], atol=1e-4)
    new_ok = new[:, 0] > 0
    assert new_ok.sum() >= 5
    np.testing.assert_array_equal(got.new_ok.numpy(), new_ok)
    np.testing.assert_allclose(got.new_X.numpy()[new_ok], new[new_ok, 1:4], atol=1e-3)
    np.testing.assert_array_equal(got.new_uv_prev.numpy()[new_ok], new[new_ok, 4:6])
    np.testing.assert_array_equal(got.new_uv_cur.numpy()[new_ok], new[new_ok, 6:8])
    np.testing.assert_array_equal(got.new_desc.numpy()[new_ok], new[new_ok, 8:])


def test_boot_probe_matches_jax(seq3):
    """The bootstrap probe (match count and median flow against frame 0) on
    the JAX package's buffers, over a stacked chunk of 2 candidates, one of
    3 (a frame twice) and a short last chunk of 1 (each its own shape, as
    each is its own compile in JAX): counts equal, flows within rtol 1e-6."""
    K, frames, _, _, jbufs = seq3
    b0 = jbufs[0]
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, device="cpu")
    sfm._bufs = {i: keypoint_buffer_from_jax(b) for i, b in enumerate(jbufs)}
    for chunk in ([1, 2], [1, 2, 1], [2]):
        want = np.asarray(jpipe._boot_probe_batched(
            b0.desc, b0.valid, jnp.asarray(_uv(b0)), jnp.stack([jbufs[f].desc for f in chunk]),
            jnp.stack([jbufs[f].valid for f in chunk]),
            jnp.stack([jnp.asarray(_uv(jbufs[f])) for f in chunk]),
            ratio_sq=0.7))
        got = sfm._boot_probe(chunk)
        assert got.shape == (len(chunk), 2)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
        assert (want[:, 0] > 10).all()
    assert len(tpipe.BOOT_PROBE_GRAPHS) == 0


def test_incremental_sfm_runs_on_three_frames(seq3):
    """The whole port pipeline on three frames on the CPU: bootstrap on
    frames (0, 2), frame 1 registered, each frame detected once, the final
    BA's poses finite and near the truth."""
    K, frames, gtR, gtT, _ = seq3
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, min_matches=20, device="cpu")
    res = sfm.run(frames)
    assert res is not None and sorted(res.frames_registered) == [0, 1, 2]
    assert sfm.n_detected == 3
    assert set(sfm.phase_times) == {"bootstrap", "register", "periodic_ba", "loop_closure",
                                    "final_ba"}
    assert np.isfinite(res.Rs).all() and np.isfinite(res.points).all() and len(res.points) >= 20
    reg = res.frames_registered
    assert ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg])) < 0.1


def test_incremental_sfm_device_and_host_loop(seq3, monkeypatch):
    """fused=False (the JAX package's host loop) runs on the CPU over the
    three frames: bootstrap on frames (0, 2), frame 1 registered, each
    frame detected once, poses near the truth; device=None means the CUDA
    card and raises without one, in both architectures."""
    K, frames, gtR, gtT, _ = seq3
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, min_matches=20, fused=False,
                         device="cpu")
    res = sfm.run(frames)
    assert res is not None and sorted(res.frames_registered) == [0, 1, 2]
    assert sfm.n_detected == 3 and len(res.points) >= 20
    assert np.isfinite(res.Rs).all() and np.isfinite(res.points).all()
    reg = res.frames_registered
    assert ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg])) < 0.1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fused in (True, False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IncrementalSfM(np.eye(3, dtype=np.float32), (64, 64), fused=fused)


def _test_sequence():
    return render_sequence(n_frames=7, n_points=70, image_size=(320, 240), seed=0, arc_deg=25.0)


@pytest.mark.slow
def test_incremental_sfm_ate():
    """tests/test_sfm_pipeline.py::test_incremental_sfm_ate through the
    port, with its own draws."""
    K, frames, gtR, gtT = _test_sequence()
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, ba_every=6, device="cpu")
    res = sfm.run(frames)
    assert res is not None, "bootstrap failed"
    assert len(res.frames_registered) == len(frames)
    assert len(res.points) > 40
    reg = res.frames_registered
    ate = ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg]))
    assert ate < 0.15, ate


def test_triangulate_new_matches_jax(seq3):
    """The host loop's new points (frame 1 against frame 0 at the true
    poses, the first 15 of frame 1's keypoints claimed by map matches) on
    the JAX package's keypoints: the same accepted matches, their
    keypoints and descriptors equal, points within 1e-3."""
    K, frames, gtR, gtT, jbufs = seq3
    kps = [_host_kps(b) for b in jbufs[:2]]
    used = np.arange(15)
    js = jpipe.IncrementalSfM(K, frames[0].shape, cfg=JCFG)
    obs_cam, obs_pt, obs_uv = [], [], []
    Rs = [gtR[0].astype(np.float32), gtR[1].astype(np.float32)]
    ts = [gtT[0].astype(np.float32), gtT[1].astype(np.float32)]
    js._triangulate_new(kps, 1, 0, {0: 0, 1: 1}, Rs, ts, np.stack([used, used], 1),
                        np.zeros((0, 3), np.float32), np.zeros((0, 128), np.uint8),
                        obs_cam, obs_pt, obs_uv)
    want_X, want_desc, n = js._map_arrays
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, device="cpu")
    X, uva, uvb, desc = sfm._triangulate_new(kps[0], kps[1], Rs[0], ts[0], Rs[1], ts[1], used)
    assert n >= 20 and len(X) == n
    assert obs_cam == [0, 1] * n and obs_pt == [k for k in range(n) for _ in (0, 1)]
    np.testing.assert_array_equal(uva, np.asarray(obs_uv[0::2], np.float32))
    np.testing.assert_array_equal(uvb, np.asarray(obs_uv[1::2], np.float32))
    np.testing.assert_array_equal(desc, want_desc)
    np.testing.assert_allclose(X, want_X, atol=1e-3)
    X0, *_ = sfm._triangulate_new(kps[0], kps[1], Rs[0], ts[0], Rs[1], ts[1],
                                  np.arange(len(kps[1]["x"])))
    assert X0.shape == (0, 3)          # every keypoint claimed: nothing fresh


def _host_kps(buf):
    """A JAX keypoint buffer compacted to the host as SiftPlan.keypoints
    gives it ("x", "y", "desc" of the valid slots)."""
    m = np.asarray(buf.valid)
    return {"x": np.asarray(buf.x)[m], "y": np.asarray(buf.y)[m], "desc": np.asarray(buf.desc)[m]}


def _jax_two_view_rows(monkeypatch):
    """``initialize_two_view`` as ``IncrementalSfM`` calls it (the matches
    padded to their power-of-two bucket, as the JAX package pads them) fed
    the RANSAC rows the JAX package draws over the `valid` mask it is
    given: its key stream from key 0, one split a call, rows over the whole
    bucket."""
    jr = importlib.import_module("sift_pyocl_tpu.sfm.ransac")
    keys = [jax.random.key(0)]
    init = tpipe.initialize_two_view

    def init_with_jax_rows(seed, K, uv1, uv2, valid, **kw):
        keys[0], k = jax.random.split(keys[0])
        rows = jr._sample_weights(k, jnp.asarray(valid), 256, 8)
        return init(seed, K, uv1, uv2, valid, weights=np.asarray(rows), **kw)

    monkeypatch.setattr(tpipe, "initialize_two_view", init_with_jax_rows)


@pytest.mark.slow
def test_sequential_bootstrap_matches_jax_given_its_draws(monkeypatch):
    """The host loop's sequential bootstrap (``_bootstrap``: each candidate
    matched on the host, the flow gate there) on the 7-frame sequence picks
    the JAX package's frame, with its inlier count and matches, when each
    two-view init is fed JAX's RANSAC rows."""
    K, frames, _, _ = _test_sequence()
    js = jpipe.IncrementalSfM(K, frames[0].shape, cfg=JCFG, ba_every=6, fused=False)
    want = js._bootstrap([js.sift.keypoints(np.asarray(f)) for f in frames], len(frames))
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, ba_every=6, fused=False, device="cpu")
    sfm._frames, sfm._bufs, sfm._kps_cache = frames, {}, {}
    _jax_two_view_rows(monkeypatch)
    got = sfm._bootstrap(len(frames))
    assert got[0] == want[0]
    assert int(got[4].n_inliers) == int(want[4].n_inliers)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("draws", [
    "jax_two_view",
    pytest.param("own", marks=pytest.mark.slow),
])
def test_host_loop_registers_the_test_sequence(draws, monkeypatch):
    """IncrementalSfM(fused=False) on tests/test_sfm_pipeline.py's 7-frame
    sequence: 7 of 7 registered, each frame detected once, phase times
    filled.  With the two-view rows the JAX package draws (its bootstrap
    then picks frame 5): ATE < 0.1.  With the port's own draws the
    bootstrap picks frame 4, where the JAX package's own host loop also
    ends at ATE 0.108 (its seed 1; 0.031 from frame 5 at seeds 0 and 2):
    ATE < 0.15, tests/test_sfm_pipeline.py's bound."""
    K, frames, gtR, gtT = _test_sequence()
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, ba_every=6, fused=False, device="cpu")
    if draws == "jax_two_view":
        _jax_two_view_rows(monkeypatch)
    res = sfm.run(frames)
    assert res is not None, "bootstrap failed"
    reg = res.frames_registered
    assert sorted(reg) == list(range(7)) and sfm.n_detected == 7
    assert reg[1] == (5 if draws == "jax_two_view" else 4)
    assert len(res.points) > 40 and res.n_obs > 2 * len(res.points)
    assert all(v >= 0 for v in sfm.phase_times.values()) and sfm.phase_times["register"] > 0
    ate = ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg]))
    assert ate < (0.1 if draws == "jax_two_view" else 0.15), ate


@pytest.mark.slow
def test_bootstrap_matches_jax_given_its_draws(monkeypatch):
    """The bootstrap on the 7-frame sequence picks the JAX package's frame,
    with its inlier count, when each two-view init is fed the RANSAC rows
    JAX draws there (its key stream: one split a call, rows over the
    power-of-two padded matches).  With the port's own draws the pick can
    differ: on this sequence candidate 4 scores 27 inliers under most draws
    and 18 under JAX's, so JAX's fallback picks frame 5 and the port's
    frame 4 (both then register all 7 frames)."""
    K, frames, _, _ = _test_sequence()
    js = jpipe.IncrementalSfM(K, frames[0].shape, cfg=JCFG, ba_every=6)
    js._frames, js._bufs, js._kps_cache = frames, {}, {}
    want = js._bootstrap_fast(js._LazyKps(js), len(frames))
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, ba_every=6, device="cpu")
    sfm._frames, sfm._bufs, sfm._kps_cache = frames, {}, {}
    _jax_two_view_rows(monkeypatch)
    got = sfm._bootstrap_fast(len(frames))
    assert got[0] == want[0]
    assert int(got[4].n_inliers) == int(want[4].n_inliers)
    np.testing.assert_array_equal(got[1], want[1])


def _loop_sequence():
    return render_sequence(n_frames=12, n_points=160, image_size=(320, 240), seed=1,
                           arc_deg=50.0, out_and_back=True)


@pytest.mark.slow
def test_loop_closure_cuts_ate():
    """tests/test_sfm_pipeline.py::test_loop_closure_cuts_ate through the
    port (drift forced by a 3-camera match window, no relocalization)."""
    K, frames, gtR, gtT = _loop_sequence()
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, ba_every=100, map_match_window=3,
                         loop_closure=True, reloc_fallback=False, device="cpu")
    res = sfm.run(frames)
    assert res is not None
    reg = res.frames_registered
    assert len(reg) >= 7
    assert sfm.n_loop_edges >= 2
    gt_c = camera_centers(gtR[reg], gtT[reg])
    R0, t0, Rn, tn, _ = sfm._pgo_debug
    ate_pre = ate_rmse(camera_centers(R0, t0), gt_c)
    ate_post = ate_rmse(camera_centers(Rn, tn), gt_c)
    ate_final = ate_rmse(camera_centers(res.Rs, res.ts), gt_c)
    if ate_pre > 0.1:
        assert ate_post < 0.7 * ate_pre, (ate_pre, ate_post)
    assert ate_post < 0.12, (ate_pre, ate_post)
    assert ate_final < 0.10, ate_final


@pytest.mark.slow
def test_reloc_registers_revisits():
    """tests/test_sfm_pipeline.py::test_reloc_registers_revisits through
    the port: every frame of the loop sequence registers."""
    K, frames, gtR, gtT = _loop_sequence()
    sfm = IncrementalSfM(K, frames[0].shape, cfg=CFG, ba_every=100, map_match_window=3,
                         loop_closure=True, device="cpu")
    res = sfm.run(frames)
    assert res is not None
    assert len(res.frames_registered) == len(frames)
    reg = res.frames_registered
    ate_final = ate_rmse(camera_centers(res.Rs, res.ts), camera_centers(gtR[reg], gtT[reg]))
    assert ate_final < 0.06, ate_final
