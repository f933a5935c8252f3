"""The JAX package's last top-level jits as CUDA graphs on a card (skipped
without one): ``MatchPlan``'s matcher, the warp, the SfM bundle
adjustment's LM iteration, the host loop's pair matcher, the video
frontend's per-frame detector and the two pipeline stages, each replay
against its eager function on the same inputs, bit for bit.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_api_graph.py -q
"""

import gc

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import MatchPlan, SiftConfig, SiftPlan
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.ops import match as tmatch
from sift_pyocl_tpu_torch.ops import transform as ttransform
from sift_pyocl_tpu_torch.parallel import TwoStagePipeline, VideoSiftFrontend, make_frames_mesh
from sift_pyocl_tpu_torch.parallel import pipeline_octaves as tpo
from sift_pyocl_tpu_torch.sfm import IncrementalSfM
from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import pnp as tpnp
from sift_pyocl_tpu_torch.sfm.synthetic import make_problem, perturb
from sift_pyocl_tpu_torch.utils import graphs
from sift_pyocl_tpu_torch.utils.render3d import render_sequence
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene

from test_torch_gpu_sfm_graph import KW as REG_KW, _map_scene, _register_args

pytestmark = pytest.mark.gpu
SHAPE = (256, 256)
SMALL = SiftConfig(kp_per_octave_cap=256)
CACHES = (tsift.DETECT_GRAPHS, tpipe.REGISTER_GRAPHS, tpnp.PNP_GRAPHS, tpipe.PAIR_GRAPHS,
          tba.LM_GRAPHS, tmatch.MATCH_GRAPHS, ttransform.WARP_GRAPHS, tpo.STAGE0_GRAPHS,
          tpo.STAGE1_GRAPHS)


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


KP_SHAPE = (480, 640)


def _keypoint_sets(dev, n=2):
    """Host keypoint records (about 290 each, SiftConfig()) of `n` 480x640
    frames 3 px apart."""
    h, w = KP_SHAPE
    base = synthetic_scene((h + 16, w + 16), n_blobs=600, seed=2)
    plan = SiftPlan(KP_SHAPE, device=dev)
    return [plan.keypoints(np.ascontiguousarray(base[8:8 + h, 8 + 3 * i:8 + 3 * i + w]))
            for i in range(n)]


@pytest.mark.parametrize("metric", ["L1", "L2"])
def test_match_index_replay_equals_eager_at_three_bucket_pairs(cuda, metric):
    """MatchPlan's padded call at three bucket pairs (the sets cut to 100,
    200 and all of their records: 128, 256 and 512 rows), with an ROI and
    an xy radius too: each replay equals the eager call on the same padded
    records bit for bit, and its indices equal a CPU plan's."""
    kp1, kp2 = _keypoint_sets(cuda)
    assert len(kp1) > 256 and len(kp2) > 256
    roi = np.zeros(KP_SHAPE, np.uint8)
    roi[60:400, 50:560] = 1
    for kw in ({}, {"match_xradius": 6.0, "match_yradius": 6.0}):
        plan = MatchPlan(metric=metric, device=cuda, **kw)
        cpu = MatchPlan(metric=metric, device="cpu", **kw)
        before = tmatch.MATCH_GRAPHS.captures
        for n in (100, 200, None):
            a, b = kp1[:n], kp2[:n]
            for use_roi in (False, True):
                for p in (plan, cpu):
                    p.set_roi(roi) if use_roi else p.unset_roi()
                d1, m1, xy1 = plan._padded(a, plan._roi_mask(a))
                d2, m2, xy2 = plan._padded(b, np.ones(len(b), bool))
                radius = (6.0, 6.0) if kw else None
                args = (d1, m1, d2, m2, cuda, metric, plan.ratio_th, xy1, xy2, radius)
                got = tmatch.match_packed(*args)
                assert torch.equal(got, tmatch._match_packed_eager(*args)), (n, use_roi)
                idx = plan.match_index(a, b)
                np.testing.assert_array_equal(idx, cpu.match_index(a, b))
                assert len(idx) >= 10, (n, use_roi, len(idx))
        assert tmatch.MATCH_GRAPHS.captures == before + 3


@pytest.mark.parametrize("shape", [(256, 256), (1080, 1920)])
def test_warp_replay_equals_eager(cuda, shape):
    """affine_warp at 256^2 and 1080p, host and device images, two
    matrices a shape: one graph a shape, each replay the eager bits."""
    img = synthetic_scene(shape, n_blobs=40, seed=1)
    before = ttransform.WARP_GRAPHS.captures
    for th, off in ((0.03, (2.5, -3.25)), (-0.1, (-7.0, 11.5))):
        m = 1.02 * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        want = ttransform._affine_warp_eager(img, m, off, device=cuda)
        for x in (img, torch.from_numpy(img).to(cuda)):
            got = ttransform.affine_warp(x, m, np.asarray(off), device=cuda)
            assert got.shape == shape and torch.equal(got, want)
    assert ttransform.WARP_GRAPHS.captures == before + 1


def _ba_start(n_cams, n_points, seed):
    K, gt, obs, _ = make_problem(n_cams=n_cams, n_points=n_points, noise_px=0.4, seed=seed)
    start = perturb(gt, rot_deg=2.0, trans=0.12, point_sigma=0.08, seed=seed + 1,
                    keep_fixed=(0,))
    return K, start, obs


@pytest.mark.parametrize("n_cams,n_points", [(6, 120), (8, 200), (16, 300)])
def test_run_ba_replay_equals_eager_over_25_iterations(cuda, n_cams, n_points):
    """run_ba (one LM graph a (C, M, P) key) over 25 iterations equals the
    eager loop bit for bit in every cost and in the parameters; one
    capture a key, none on a second call."""
    K, start, obs = _ba_start(n_cams, n_points, seed=n_cams)
    before = tba.LM_GRAPHS.captures
    got, costs = tba.run_ba(start, obs, K, iters=25, device=cuda)
    want, want_costs = tba._run_ba_eager(start, obs, K, iters=25, device=cuda)
    assert costs == want_costs and costs[-1] < 0.1 * costs[0]
    _assert_equal("run_ba", got, want)
    again, last = tba.run_ba(start, obs, K, iters=25, fetch_costs=False, device=cuda)
    _assert_equal("run_ba again", again, want)
    assert last == costs[-1:] and tba.LM_GRAPHS.captures == before + 1


def _sfm_ba_args(n_cams=8, n_points=150):
    """IncrementalSfM._run_ba's arguments from a synthetic problem: Rs, ts,
    X and the observation lists (M and P off their buckets)."""
    K, start, obs = _ba_start(n_cams, n_points, seed=3)
    return K, (list(np.asarray(start.Rs)), list(np.asarray(start.ts)), np.asarray(start.X),
               list(np.asarray(obs.cam)), list(np.asarray(obs.pt)), np.asarray(obs.uv))


def test_padded_sfm_ba_replay_equals_eager(cuda, monkeypatch):
    """IncrementalSfM._run_ba (the observations and points padded to their
    buckets, 12 and 25 iterations) replayed equals its eager run bit for
    bit, and its results come home as host arrays of the map's sizes."""
    K, args = _sfm_ba_args()
    sfm = IncrementalSfM(K, SHAPE, cfg=SMALL, device=cuda)
    for iters in (12, 25):
        got = sfm._run_ba(*args, iters=iters)
        with monkeypatch.context() as m:
            m.setattr(tpipe, "run_ba", tba._run_ba_eager)
            want = sfm._run_ba(*args, iters=iters)
        for g, w in zip(got, want):
            assert np.array_equal(np.stack(g), np.stack(w))
        assert got[2].shape == args[2].shape and len(got[0]) == len(args[0])
    assert len(tba.LM_GRAPHS) == 1


def test_host_loop_match_replay_equals_eager(cuda, monkeypatch):
    """The host loop's _match (both sets padded to their _pow2_pad
    buckets) at three bucket pairs: replayed equals eager, one graph a
    pair."""
    kp1, kp2 = _keypoint_sets(cuda)
    sfm = IncrementalSfM(np.eye(3, dtype=np.float32), SHAPE, cfg=SMALL, device=cuda)
    before = tpipe.PAIR_GRAPHS.captures
    for n1, n2 in ((100, 200), (300, 200), (len(kp1), len(kp2))):
        d1, d2 = kp1["desc"][:n1], kp2["desc"][:n2]
        got = sfm._match(d1, d2)
        with monkeypatch.context() as m:
            m.setattr(tpipe, "match_packed", tmatch._match_packed_eager)
            want = sfm._match(d1, d2)
        np.testing.assert_array_equal(got, want)
        assert len(got) >= 10
    assert tpipe.PAIR_GRAPHS.captures == before + 3


def test_video_frontend_and_pipeline_replay_equal_eager(cuda):
    """VideoSiftFrontend at B = 4 (each frame the detector graph's replay)
    and TwoStagePipeline over 6 frames (two stage graphs): every frame
    equals the eager detect_and_describe bit for bit; the frontend's
    graph is SiftPlan's (one capture for both)."""
    frames = np.stack(_frames(6))
    before = tsift.DETECT_GRAPHS.captures
    stages = tpo.STAGE0_GRAPHS.captures, tpo.STAGE1_GRAPHS.captures
    fe = VideoSiftFrontend(SHAPE, batch=4, cfg=SMALL, mesh=make_frames_mesh(devices=[cuda]))
    for _ in range(2):
        out = fe(frames[:4])
        for f in range(4):
            want = tsift.detect_and_describe(torch.from_numpy(frames[f]).to(cuda), SMALL)
            _assert_equal(f"video frame {f}", type(want)(*[t[f] for t in out]), want)
    SiftPlan(SHAPE, config=SMALL, device=cuda).keypoints(frames[0])
    assert tsift.DETECT_GRAPHS.captures == before + 1
    pipe = TwoStagePipeline(SHAPE, SMALL, devices=[cuda])
    for _ in range(2):
        bufs = list(pipe.process(frames))
        assert len(bufs) == 6
        for f, b in enumerate(bufs):
            _assert_equal(f"pipeline frame {f}", b, tsift.detect_and_describe(
                torch.from_numpy(frames[f]).to(cuda), SMALL))
    assert (tpo.STAGE0_GRAPHS.captures, tpo.STAGE1_GRAPHS.captures) == (stages[0] + 1,
                                                                       stages[1] + 1)


def test_replays_make_no_host_sync_but_the_copy_home(cuda):
    """With their inputs on the card, replays of the matcher, the warp, the
    LM iteration, the pair matcher and both pipeline stages synchronise no
    host (the sync debug mode set to raise lets them through); the copy
    home is the one sync."""
    kp1, kp2 = _keypoint_sets(cuda)
    plan = MatchPlan(device=cuda)
    d1, m1, _ = (torch.from_numpy(a).to(cuda) for a in plan._padded(kp1, plan._roi_mask(kp1)))
    d2, m2, _ = (torch.from_numpy(a).to(cuda)
                 for a in plan._padded(kp2, np.ones(len(kp2), bool)))
    img = torch.from_numpy(_frames(1)[0]).to(cuda)
    m = torch.tensor([[1.01, 0.02], [-0.02, 0.99]], device=cuda)
    off = torch.tensor([1.5, -2.0], device=cuda)
    K, start, obs = _ba_start(6, 120, seed=0)
    _, params, bobs, Kt, free = tba._ba_inputs(start, obs, K, (0,), cuda)
    lam = torch.full((), 1e-3, device=cuda)

    def calls():
        p, lam_, cost, _ = tba.lm_iteration_replayed(params, bobs, Kt, lam, free)
        flat = tpo.stage0(img, SMALL, cuda)
        return (tmatch.match_packed(d1, m1, d2, m2, cuda),
                tmatch.match_packed(d1, m1, d2, m2, cuda, cache=tpipe.PAIR_GRAPHS),
                ttransform.affine_warp(img, m, off), cost, tpo.stage1(flat, SHAPE, SMALL))

    calls()                                      # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            out = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out[0][:, 2].sum()) >= 10 and float(out[3]) > 0
    assert graphs.to_host([out[2]])[0].shape == SHAPE


def test_ba_registration_and_detector_replays_interleave(cuda):
    """The LM, registration, detector, matcher and warp caches share one
    capture stream and its kernel scratch: their replays interleaved, on
    the current stream and on a side stream, each equal its eager call."""
    scene = _map_scene(cuda)
    frames = [torch.from_numpy(f).to(cuda) for f in _frames(4)]
    plan = SiftPlan(SHAPE, config=SMALL, device=cuda)
    l2 = MatchPlan(metric="L2", device=cuda)
    kp_ref = plan.keypoints(frames[0])
    d1, m1, _ = l2._padded(kp_ref, np.ones(len(kp_ref), bool))
    K, start, obs = _ba_start(8, 200, seed=5)
    _, params, bobs, Kt, free = tba._ba_inputs(start, obs, K, (0,), cuda)
    lam = torch.full((), 1e-3, device=cuda)
    side = torch.cuda.Stream(cuda)
    for i, f in enumerate(frames[1:] * 2):
        stream = side if i % 2 else torch.cuda.current_stream(cuda)
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            buf = plan.keypoints_raw(f)
            step = tba.lm_iteration_replayed(params, bobs, Kt, lam, free)
            reg = tpipe.register_from_buffers(*_register_args(scene, 256), **REG_KW)
            warp = ttransform.affine_warp(f, np.eye(2) * 0.98, np.array([1.0, 2.0]))
            d2, m2 = buf.desc, buf.valid
            mt = tmatch.match_packed(d1, m1, d2, m2, cuda, metric="L2")
        torch.cuda.current_stream(cuda).wait_stream(stream)
        _assert_equal(f"{i}: detector", buf, tsift._detector(SMALL)(f))
        want = tba.lm_iteration(params, bobs, Kt, lam, free, n_points=params.X.shape[0])
        _assert_equal(f"{i}: LM params", step[0], want[0])
        for g, w in zip(step[1:], want[1:]):
            assert torch.equal(g, w), f"{i}: LM lam, cost, accept"
        _assert_equal(f"{i}: registration", reg, tpipe._register_from_buffers_eager(
            *_register_args(scene, 256), **REG_KW))
        assert torch.equal(warp, ttransform._affine_warp_eager(f, np.eye(2) * 0.98,
                                                                np.array([1.0, 2.0])))
        assert torch.equal(mt, tmatch._match_packed_eager(d1, m1, d2, m2, cuda, metric="L2"))
        params, lam = step[0], step[1]
    assert len(tpipe.REGISTER_GRAPHS) == 1 and len(tba.LM_GRAPHS) == 1


def _fill_free_small_blocks(dev, stream, limit=1 << 18):
    held = []
    with torch.cuda.stream(stream):
        reserved = torch.cuda.memory_reserved(dev)
        while torch.cuda.memory_reserved(dev) == reserved and len(held) < limit:
            held.append(torch.full((512,), 0xA5, dtype=torch.uint8, device=dev))
        held += [torch.full((64 << 20,), 0x5A, dtype=torch.uint8, device=dev) for _ in range(2)]
    return held


def test_api_replays_survive_dropped_kernel_caches(cuda):
    """The L2 matcher graph (K7's counters), both pipeline stages (K1/K2
    tables, K3 scratch) and the LM graph keep alive the cached device
    tensors their kernels read: with those caches emptied after the
    captures and the allocator's free small blocks filled with garbage,
    their replays still give the eager bits."""
    from sift_pyocl_tpu_torch.ops import pyramid
    from sift_pyocl_tpu_torch.ops.kernels import compact, ladder, matchk

    kp1, kp2 = _keypoint_sets(cuda)
    plan = MatchPlan(metric="L2", device=cuda)
    d1, m1, _ = plan._padded(kp1, np.ones(len(kp1), bool))
    d2, m2, _ = plan._padded(kp2, np.ones(len(kp2), bool))
    img = torch.from_numpy(_frames(1)[0]).to(cuda)
    K, start, obs = _ba_start(6, 120, seed=0)
    want_match = tmatch._match_packed_eager(d1, m1, d2, m2, cuda, metric="L2")
    want_flat = tpo._stage0_eager(img, SMALL, cuda)
    want_buf = tpo._stage1_eager(want_flat, SHAPE, SMALL)
    want_ba = tba._run_ba_eager(start, obs, K, iters=3, device=cuda)
    tmatch.match_packed(d1, m1, d2, m2, cuda, metric="L2")
    tpo.stage1(tpo.stage0(img, SMALL, cuda), SHAPE, SMALL)
    tba.run_ba(start, obs, K, iters=3, device=cuda)
    held = [t for c in (tmatch.MATCH_GRAPHS, tpo.STAGE0_GRAPHS, tpo.STAGE1_GRAPHS)
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
    for _ in range(2):
        assert torch.equal(tmatch.match_packed(d1, m1, d2, m2, cuda, metric="L2"), want_match)
        flat = tpo.stage0(img, SMALL, cuda)
        for g, w in zip(flat, want_flat):
            assert torch.equal(g, w)
        _assert_equal("stage 1", tpo.stage1(flat, SHAPE, SMALL), want_buf)
        got, costs = tba.run_ba(start, obs, K, iters=3, device=cuda)
        _assert_equal("run_ba", got, want_ba[0])
        assert costs == want_ba[1]
    del garbage


def _eager_sfm(monkeypatch):
    """Every program IncrementalSfM replays on a card patched to its eager
    function (as chip_smoke.py's eager turns)."""
    def eager_raw(self, image):
        img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
        return self._fn(img.to(self.device))

    monkeypatch.setattr(SiftPlan, "keypoints_raw", eager_raw)
    monkeypatch.setattr(tpipe, "register_from_buffers", tpipe._register_from_buffers_eager)
    monkeypatch.setattr(tpipe, "ransac_pnp", tpnp._ransac_pnp_eager)
    monkeypatch.setattr(tpipe, "run_ba", tba._run_ba_eager)
    monkeypatch.setattr(tpipe, "match_packed", tmatch._match_packed_eager)


@pytest.mark.parametrize("fused", [True, False])
def test_incremental_sfm_with_graphed_ba_equals_eager(cuda, fused, monkeypatch):
    """A 7-frame IncrementalSfM run replaying every graph (the detector,
    registration or RANSAC-PnP and pair matcher, and the padded BA's LM
    iteration) equals the run with every eager function at the same
    padding, bit for bit; a second replayed run captures nothing."""
    K, seq, _, _ = render_sequence(n_frames=7, n_points=70, seed=0, arc_deg=25.0)
    kw = dict(cfg=SMALL, ba_every=6, fused=fused, device=cuda)
    got = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    counts = [c.captures for c in CACHES]
    assert tba.LM_GRAPHS.captures >= 2 and (fused or tpipe.PAIR_GRAPHS.captures >= 1)
    again = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert [c.captures for c in CACHES] == counts
    with monkeypatch.context() as m:
        _eager_sfm(m)
        want = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert len(got.frames_registered) >= 6
    for res in (got, again):
        for f in ("Rs", "ts", "points"):
            a, b = getattr(res, f), getattr(want, f)
            assert a.shape == b.shape and np.array_equal(a, b), f
