"""``SiftPlan``'s detector, config 4's fused registration and the host
loop's RANSAC-PnP as CUDA graphs on a card (skipped without one): each
replay against the eager function on the same inputs, bit for bit.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_sfm_graph.py -q
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import (SLICE_CONFIG, SiftConfig, SiftPlan, VOConfig, vo_init,
                                  vo_step)
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.models import vo as tvo
from sift_pyocl_tpu_torch.models.sift import _desc_buckets, octave_capacities
from sift_pyocl_tpu_torch.ops import orient_desc as od
from sift_pyocl_tpu_torch.ops.detect import detect_octave_pallas
from sift_pyocl_tpu_torch.ops.match import match_descriptors_jax
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
from sift_pyocl_tpu_torch.sfm import IncrementalSfM
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import pnp as tpnp
from sift_pyocl_tpu_torch.sfm.geometry import triangulate_two_view
from sift_pyocl_tpu_torch.utils import graphs
from sift_pyocl_tpu_torch.utils.profiling import vo_frames
from sift_pyocl_tpu_torch.utils.render3d import render_sequence
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

pytestmark = pytest.mark.gpu
SHAPE = (256, 256)
SMALL = SiftConfig(kp_per_octave_cap=256)
# every SiftConfig route SiftPlan takes: the default, K8, K1m/K2m, the
# per-octave path (K10a/K10b), two K6 launches, K9 at scales=2 (with and
# without the fused masks), the plain keypoint path and SLICE_CONFIG (the
# cuDNN pyramid)
CONFIGS = {
    "default": SMALL,
    "k8": dataclasses.replace(SMALL, mask_backend="pallas"),
    "fused": dataclasses.replace(SMALL, mask_backend="fused"),
    "per_octave": dataclasses.replace(SMALL, kp_multi_launch=False),
    "buckets": dataclasses.replace(SMALL, desc_buckets=2),
    "scales2": dataclasses.replace(SMALL, scales=2),
    "fused_scales2": dataclasses.replace(SMALL, mask_backend="fused", scales=2),
    "xla": dataclasses.replace(SMALL, kp_backend="xla"),
    "slice": dataclasses.replace(SLICE_CONFIG, kp_per_octave_cap=256),
}
CACHES = (tsift.DETECT_GRAPHS, tpipe.REGISTER_GRAPHS, tpnp.PNP_GRAPHS, tvo.STEP_GRAPHS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for c in CACHES:
        c.clear()
    yield torch.device("cuda", 0)
    for c in CACHES:
        c.clear()


def _frames(n, shape=SHAPE):
    return [synthetic_scene(shape, n_blobs=40, seed=s) for s in range(n)]


def _assert_equal(tag, got, want):
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{tag}: {name}"
        assert torch.equal(g, w), f"{tag}: {name} differs in {int((g != w).sum())} places"


def _eager_keypoints_raw(self, image):
    img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
    return self._fn(img.to(self.device))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_detector_replay_equals_eager(cuda, name):
    """Each route's replays (the first frame captures, host and device
    frames alike) equal the eager detector bit for bit, and the eager
    detector gives the same bits twice; ``keypoints`` (one copy home) equals
    the eager buffer's records; a second plan of the config replays the
    same graph; a replay on a device frame synchronises no host (the sync
    debug mode set to raise lets it through)."""
    cfg = CONFIGS[name]
    if name == "buckets":
        assert _desc_buckets(cfg) is not None
    plan = SiftPlan(SHAPE, config=cfg, device=cuda)
    before = tsift.DETECT_GRAPHS.captures
    for i, f in enumerate(_frames(3)):
        x = torch.from_numpy(f).to(cuda)
        want = tsift._detector(cfg)(x)
        _assert_equal(f"{name}: eager twice, frame {i}", tsift._detector(cfg)(x), want)
        _assert_equal(f"{name}: replay, frame {i}", plan.keypoints_raw(x), want)
        _assert_equal(f"{name}: host frame {i}", plan.keypoints_raw(f), want)
        got = plan.keypoints(f)
        np.testing.assert_array_equal(got, tsift.to_keypoint_records(want))
    assert tsift.DETECT_GRAPHS.captures == before + 1
    SiftPlan(SHAPE, config=cfg, device=cuda).keypoints(f)
    assert tsift.DETECT_GRAPHS.captures == before + 1 and len(got) > 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        buf = plan.keypoints_raw(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_equal(f"{name}: replay in sync debug mode", buf, want)


def _split_detector(cfg, img):
    """The split entry points per octave (K10a, K10b, padded plain
    gradients, K11a, K11b): no SiftConfig reaches them, as in the JAX
    package, so they are captured here as a graph body of their own."""
    caps = [c for c, _ in octave_capacities(tuple(img.shape), cfg)]
    out = []
    for o, (blurs, dogs) in enumerate(build_scale_space(img, cfg)):
        kps, _ = detect_octave_pallas(dogs, cfg, o, caps[o])
        mag_p, ori_p = od.pad_grad_planes(*od.gradient_planes(blurs, cfg))
        okps = od.assign_orientations_pallas(mag_p, ori_p, kps, cfg, max_ori=cfg.max_ori)
        out += [okps.angle, okps.valid, od.compute_descriptors_pallas(mag_p, ori_p, okps, cfg)]
    return tuple(out)


def test_split_window_path_replays_as_eager(cuda):
    cache = graphs.GraphCache(_split_detector)
    for f in _frames(3):
        x = torch.from_numpy(f).to(cuda)
        got, want = cache(cuda, SMALL, (x,)), _split_detector(SMALL, x)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cache.captures == 1 and int(want[1].sum()) > 0
    cache.clear()


def _map_scene(dev):
    """Frame 1 of three frames 6 deg apart, its map: the matches of frames
    0 and 2 triangulated at the true poses (as tests/test_torch_sfm_pipeline.py
    builds it from the JAX package's buffers); the buffers on the card."""
    K, frames, gtR, gtT = render_sequence(n_frames=3, n_points=70, image_size=(320, 240),
                                          seed=0, arc_deg=12.0)
    plan = SiftPlan(frames[0].shape, config=SMALL, device=dev)
    bufs = [plan.keypoints_raw(np.asarray(f, np.float32)) for f in frames]
    d0, d2 = bufs[0], bufs[2]
    m = match_descriptors_jax(d0.desc, d0.valid, d2.desc, d2.valid, ratio_sq=0.7)
    ok = m.valid.cpu().numpy()
    i0, i2 = m.idx1.long()[m.valid], m.idx2.long()[m.valid]
    Kt = torch.from_numpy(K).to(dev)
    X = triangulate_two_view(Kt, *(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                                   for a in (gtR[0], gtT[0])), Kt,
                             *(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                               for a in (gtR[2], gtT[2])),
                             torch.stack([d0.x, d0.y], -1)[i0], torch.stack([d2.x, d2.y], -1)[i2])[0]
    assert ok.sum() >= 20
    return K, gtR, gtT, bufs, d0.desc[i0].cpu().numpy(), X.cpu().numpy()


def _register_args(scene, P, dev=None):
    """register_from_buffers's arguments with the map padded to P rows."""
    K, gtR, gtT, bufs, desc, X = scene
    d0 = bufs[0]
    host = [tpipe._pad_rows(desc, P, np.uint8), tpipe._pad_rows(np.ones(len(X)), P, bool),
            tpipe._pad_rows(X, P, np.float32)]
    poses = [np.asarray(a, np.float32) for a in (gtR[0], gtT[0], gtR[0], gtT[0], K)]
    if dev is not None:
        host = [torch.from_numpy(a).to(dev) for a in host]
        poses = [torch.from_numpy(a).to(dev) for a in poses]
    return (bufs[1], 7, *host, d0.desc, torch.stack([d0.x, d0.y], -1), d0.valid, *poses)


KW = dict(new_cap=256, ratio_sq=0.7, reproj_px=3.0, metric="L1")


def test_registration_replay_equals_eager_at_three_buckets(cuda):
    """register_from_buffers at P = 256, 512, 1024 map rows: one graph a
    bucket, each replay (two seeds) bit-equal to the eager registration on
    the same inputs; the bucket's padding changes no match, inlier or
    new-point row."""
    scene = _map_scene(cuda)
    before = tpipe.REGISTER_GRAPHS.captures
    firsts = []
    for P in (256, 512, 1024):
        for seed in (7, 8):
            args = list(_register_args(scene, P))
            args[1] = seed
            got = tpipe.register_from_buffers(*args, **KW)
            want = tpipe._register_from_buffers_eager(*args, **KW)
            _assert_equal(f"P = {P}, seed {seed}", got, want)
            assert int(got.n_inl) >= 10
            host = graphs.to_host(got)
            for g, w in zip(host, want):
                assert g.device.type == "cpu" and torch.equal(g, w.cpu())
        firsts.append(got)
    assert tpipe.REGISTER_GRAPHS.captures == before + 3 and len(tpipe.REGISTER_GRAPHS) == 3
    n = len(scene[5])
    for got in firsts[1:]:
        assert int(got.n_match) == int(firsts[0].n_match)
        for f in ("keep", "inl"):
            assert torch.equal(getattr(got, f)[:n], getattr(firsts[0], f)[:n])
            assert not bool(getattr(got, f)[n:].any())


def _pnp_scene(seed, n=120, outliers=30):
    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1]], np.float32)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3)).astype(np.float32)
    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                 np.float32)
    t = np.array([0.1, -0.05, 0.2], np.float32)
    Xc = X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:]) * 300.0 + [160.0, 120.0]
    uv[:outliers] += rng.uniform(-40, 40, (outliers, 2))
    P = tpipe._pow2_pad(n)
    return K, *(tpipe._pad_rows(a, P, np.float32) for a in (X, uv, np.ones(n)))


def test_host_loop_ransac_pnp_replay_equals_eager(cuda):
    """ransac_pnp on padded rows (the host loop's form): one graph for the
    bucket, replays with three seeds and with given draws bit-equal to the
    eager call, the inliers only among the real rows."""
    K, X, uv, w = _pnp_scene(0)
    Kt = torch.from_numpy(K).to(cuda)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    before = tpnp.PNP_GRAPHS.captures
    for seed in (1, 2, 3):
        got = tpnp.ransac_pnp(seed, Kt, R0, t0, X, uv, w, thresh_px=3.0)
        want = tpnp._ransac_pnp_eager(seed, Kt, R0, t0, X, uv, w, thresh_px=3.0)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        assert int(got[3]) >= 80 and not bool(got[2][120:].any())
    draws = tpnp.pnp_draws(5, torch.from_numpy(w).to(cuda))
    got = tpnp.ransac_pnp(0, Kt, R0, t0, X, uv, w, thresh_px=3.0, draws=draws)
    want = tpnp._ransac_pnp_eager(0, Kt, R0, t0, X, uv, w, thresh_px=3.0, draws=draws)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    for g, x in zip(want, tpnp.ransac_pnp(5, Kt, R0, t0, X, uv, w, thresh_px=3.0)):
        assert torch.equal(g, x)
    assert tpnp.PNP_GRAPHS.captures == before + 2


def test_replays_make_no_host_sync(cuda):
    """Replays of the detector (a frame on the card), the registration and
    RANSAC-PnP (their inputs on the card, the draws' numbers copied in from
    the host) synchronise no host: the sync debug mode set to raise lets
    them through."""
    scene = _map_scene(cuda)
    plan = SiftPlan(SHAPE, config=SMALL, device=cuda)
    x = torch.from_numpy(_frames(1)[0]).to(cuda)
    args = _register_args(scene, 256, cuda)
    K, X, uv, w = (torch.from_numpy(a).to(cuda) for a in _pnp_scene(0))
    R0, t0 = torch.eye(3, device=cuda), torch.zeros(3, device=cuda)

    def calls():
        return (plan.keypoints_raw(x), tpipe.register_from_buffers(*args, **KW),
                tpnp.ransac_pnp(1, K, R0, t0, X, uv, w, thresh_px=3.0))

    calls()                                      # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            out = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(out[1].n_inl) >= 10 and int(out[2][3]) >= 80


VO = VOConfig(window=4, pts_per_frame=64, obs_per_frame=128, pnp_n=128)


def test_vo_detector_and_registration_replays_interleave(cuda):
    """The VO, detector, registration and RANSAC-PnP caches share one
    capture stream and its kernel scratch: their replays interleaved, on
    the current stream and on a side stream, each equal its eager call."""
    scene = _map_scene(cuda)
    frames = [torch.from_numpy(f).to(cuda) for f in vo_frames(SHAPE, 5)]
    Kvo = torch.tensor([[300.0, 0, 128.0], [0, 300.0, 128.0], [0, 0, 1]], device=cuda)
    state = vo_init(frames[0], Kvo, SMALL, VO)
    plan = SiftPlan(SHAPE, config=SMALL, device=cuda)
    K, X, uv, w = _pnp_scene(1)
    Kt = torch.from_numpy(K).to(cuda)
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    side = torch.cuda.Stream(cuda)
    for i, f in enumerate(frames[1:]):
        stream = side if i % 2 else torch.cuda.current_stream(cuda)
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            new_state, out = vo_step(state, f, Kvo, SMALL, VO)
            buf = plan.keypoints_raw(f)
            reg = tpipe.register_from_buffers(*_register_args(scene, 256), **KW)
            pnp = tpnp.ransac_pnp(i, Kt, R0, t0, X, uv, w, thresh_px=3.0)
        torch.cuda.current_stream(cuda).wait_stream(stream)
        want_state, want_out = tvo._vo_step_eager(state, f, Kvo, SMALL, VO)
        _assert_equal(f"step {i}: VO state", new_state, want_state)
        _assert_equal(f"step {i}: VO output", out, want_out)
        _assert_equal(f"step {i}: detector", buf, tsift._detector(SMALL)(f))
        _assert_equal(f"step {i}: registration", reg,
                      tpipe._register_from_buffers_eager(*_register_args(scene, 256), **KW))
        for g, x in zip(pnp, tpnp._ransac_pnp_eager(i, Kt, R0, t0, X, uv, w, thresh_px=3.0)):
            assert torch.equal(g, x), f"step {i}: RANSAC-PnP"
        state = new_state
    assert tsift.DETECT_GRAPHS.captures >= 1 and tvo.STEP_GRAPHS.captures >= 1
    assert len(tpipe.REGISTER_GRAPHS) == 1 and len(tpnp.PNP_GRAPHS) == 1


def _eager_sfm(monkeypatch):
    """Every per-frame program of IncrementalSfM patched to its eager
    function (as chip_smoke.py's eager turns)."""
    monkeypatch.setattr(SiftPlan, "keypoints_raw", _eager_keypoints_raw)
    monkeypatch.setattr(tpipe, "register_from_buffers", tpipe._register_from_buffers_eager)
    monkeypatch.setattr(tpipe, "ransac_pnp", tpnp._ransac_pnp_eager)


@pytest.mark.parametrize("fused", [True, False])
def test_incremental_sfm_replayed_equals_eager(cuda, fused, monkeypatch):
    """A 7-frame IncrementalSfM run on the card replaying its graphs (at
    most one detector key, one registration or RANSAC-PnP key a bucket)
    equals the same run with the eager functions, bit for bit, in Rs, ts
    and points; a second replayed run captures nothing."""
    K, seq, _, _ = render_sequence(n_frames=7, n_points=70, seed=0, arc_deg=25.0)
    kw = dict(cfg=SMALL, ba_every=6, fused=fused, device=cuda)
    counts = [c.captures for c in CACHES]
    got = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    caps = [c.captures - n for c, n in zip(CACHES, counts)]
    assert caps[0] == 1 and caps[3] == 0 and caps[1 if fused else 2] >= 1
    assert caps[2 if fused else 1] == 0
    again = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert [c.captures for c in CACHES] == [n + c for n, c in zip(counts, caps)]
    with monkeypatch.context() as m:
        _eager_sfm(m)
        want = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert len(got.frames_registered) >= 6
    for res in (got, again):
        for f in ("Rs", "ts", "points"):
            a, b = getattr(res, f), getattr(want, f)
            assert a.shape == b.shape and np.array_equal(a, b), f


def _fill_free_small_blocks(dev, stream, limit=1 << 18):
    held = []
    with torch.cuda.stream(stream):
        reserved = torch.cuda.memory_reserved(dev)
        while torch.cuda.memory_reserved(dev) == reserved and len(held) < limit:
            held.append(torch.full((512,), 0xA5, dtype=torch.uint8, device=dev))
        held += [torch.full((64 << 20,), 0x5A, dtype=torch.uint8, device=dev) for _ in range(2)]
    return held


def test_sfm_replays_survive_dropped_kernel_caches(cuda):
    """Captured detector and registration graphs keep alive the cached
    device tensors their kernels read: with every such cache emptied after
    the captures and the allocator's free small blocks on both streams
    filled with garbage, their replays still give the eager bits."""
    from sift_pyocl_tpu_torch.ops import pyramid
    from sift_pyocl_tpu_torch.ops.kernels import compact, ladder, matchk

    scene = _map_scene(cuda)
    frames = [torch.from_numpy(f).to(cuda) for f in _frames(3)]
    plan = SiftPlan(SHAPE, config=SMALL, device=cuda)
    want_bufs = [tsift._detector(SMALL)(f) for f in frames]
    args = _register_args(scene, 512)
    want_reg = tpipe._register_from_buffers_eager(*args, **KW)
    plan.keypoints_raw(frames[0])
    tpipe.register_from_buffers(*args, **KW)
    held = [t for c in (tsift.DETECT_GRAPHS, tpipe.REGISTER_GRAPHS)
            for g in c._graphs.values() for t in g.holds]
    assert len(held) >= 4, f"the captures hold {len(held)} cached tensors"
    del held
    ladder._taps_table.cache_clear()
    ladder._small_plan.cache_clear()
    pyramid._taps.cache_clear()
    matchk._counters.clear()
    compact._scratch.clear()
    gc.collect()
    torch.cuda.synchronize()
    garbage = [t for stream in (torch.cuda.current_stream(cuda), graphs._STREAMS[cuda])
               for t in _fill_free_small_blocks(cuda, stream)]
    torch.cuda.synchronize()
    for f, want in zip(frames, want_bufs):
        _assert_equal("detector", plan.keypoints_raw(f), want)
    _assert_equal("registration", tpipe.register_from_buffers(*args, **KW), want_reg)
    del garbage
