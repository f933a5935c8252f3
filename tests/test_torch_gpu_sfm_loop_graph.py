"""Config 4's last SfM programs as CUDA graphs on a card (skipped without
one): the pose graph's Gauss-Newton step (``sfm.posegraph.POSEGRAPH_GRAPHS``,
replayed once an iteration), the loop-closure probe on the old map padded
to its bucket (``sfm.pipeline.LOOP_PROBE_GRAPHS``) and the bootstrap's
probe of a chunk of candidates (``BOOT_PROBE_GRAPHS``), each replay against
its eager function on the same inputs, bit for bit.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_sfm_loop_graph.py -q
"""

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.sfm import IncrementalSfM
from sift_pyocl_tpu_torch.sfm import ba as tba
from sift_pyocl_tpu_torch.sfm import pipeline as tpipe
from sift_pyocl_tpu_torch.sfm import pnp as tpnp
from sift_pyocl_tpu_torch.sfm import posegraph as tpg
from sift_pyocl_tpu_torch.sfm.synthetic import make_problem, perturb
from sift_pyocl_tpu_torch.utils.render3d import render_sequence

from test_torch_gpu_api_graph import _ba_start, _eager_sfm
from test_torch_gpu_sfm_graph import KW as REG_KW, _map_scene, _register_args

pytestmark = pytest.mark.gpu
SMALL = SiftConfig(kp_per_octave_cap=256)
NEW = (tpg.POSEGRAPH_GRAPHS, tpipe.LOOP_PROBE_GRAPHS, tpipe.BOOT_PROBE_GRAPHS)
CACHES = NEW + (tsift.DETECT_GRAPHS, tpipe.REGISTER_GRAPHS, tpnp.PNP_GRAPHS,
                tpipe.PAIR_GRAPHS, tba.LM_GRAPHS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    for c in CACHES:
        c.clear()
    yield torch.device("cuda", 0)
    for c in CACHES:
        c.clear()


def _same(got, want) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(), want.nan_to_num()))


def _pose_problem(n_cams: int, loops, dev):
    """A noisy start of n_cams poses and a pose graph on the card:
    odometry edges c -> c + 1 from the truth with 2 cm of translation
    noise, and a 0 -> c loop edge (weight 3) for each c in `loops`."""
    _, gt, _, _ = make_problem(n_cams=n_cams, n_points=50, seed=3)
    start = perturb(gt, rot_deg=3.0, trans=0.2, point_sigma=0.0, seed=4, keep_fixed=(0,))
    Rs, ts = (torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (gt.Rs, gt.ts))
    ei = list(range(n_cams - 1)) + [0] * len(loops)
    ej = list(range(1, n_cams)) + list(loops)
    i, j = (torch.tensor(a, dtype=torch.int32, device=dev) for a in (ei, ej))
    ZR, Zt = tpg.relative_pose(Rs[i.long()], ts[i.long()], Rs[j.long()], ts[j.long()])
    gen = torch.Generator().manual_seed(5)
    Zt = Zt + (0.02 * torch.randn(Zt.shape, generator=gen)).to(dev)
    w = torch.tensor([1.0] * (n_cams - 1) + [3.0] * len(loops), device=dev)
    free = (torch.arange(n_cams, device=dev) > 0).to(torch.float32)
    start = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (start.Rs, start.ts)]
    return (*start, tpg.PoseGraph(i, j, ZR, Zt, w), free)


@pytest.mark.parametrize("n_cams,loops", [(10, [9]), (50, list(range(2, 50)))])
def test_pose_graph_replay_equals_eager(cuda, n_cams, loops):
    """optimize_pose_graph on the card (20 iterations, huber 10 as the
    loop closure calls it) replays one graph of one Gauss-Newton step,
    captured once, and equals the eager loop bit for bit in Rs, ts and
    cost; a second call captures nothing.  At config 4's size (C = 50, E =
    97, a 300 x 300 solve) the capture holding ``solve_ex`` shows its LU
    takes a route that syncs no host (cuSOLVER's getrf, not MAGMA's)."""
    args = _pose_problem(n_cams, loops, cuda)
    before = tpg.POSEGRAPH_GRAPHS.captures
    want = tpg._optimize_pose_graph_eager(*args, iters=20, huber=10.0)
    for call in range(2):
        got = tpg.optimize_pose_graph(*args, iters=20, huber=10.0)
        for g, w in zip(got, want):
            assert _same(g, w), f"call {call}"
    assert tpg.POSEGRAPH_GRAPHS.captures == before + 1 and len(tpg.POSEGRAPH_GRAPHS) == 1
    start_cost = tpg._optimize_pose_graph_eager(*args, iters=1, huber=10.0)[2]
    assert float(want[2]) < float(start_cost)


def _probe_args(scene, m: int, dev, cand=(1, 2)):
    """loop_probe's arguments: frames `cand` at their true poses against an
    old map of m rows (the scene's map rows repeated), padded to its
    _pow2_pad(m, floor=64) bucket, everything on the card."""
    K, gtR, gtT, bufs, desc, X = scene
    Q = tpipe._pow2_pad(m, floor=64)
    b = [bufs[f] for f in cand]

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return (torch.stack([x.desc for x in b]), torch.stack([x.valid for x in b]),
            torch.stack([torch.stack([x.x, x.y], -1) for x in b]),
            f32(np.stack([gtR[f] for f in cand])), f32(np.stack([gtT[f] for f in cand])),
            torch.from_numpy(tpipe._pad_rows(np.resize(desc, (m, 128)), Q, np.uint8)).to(dev),
            torch.from_numpy(np.arange(Q) < m).to(dev),
            f32(tpipe._pad_rows(np.resize(X, (m, 3)), Q, np.float32)), f32(K))


PROBE_KW = dict(ratio_sq=0.7, metric="L1", thresh_px=3.0)


def test_loop_probe_replay_equals_eager_at_two_buckets(cuda):
    """loop_probe at Q = 64 and 128 old-map rows: one graph a bucket, each
    replay (two seed sets) bit-equal to the eager probe on the same inputs,
    a candidate accepted; IncrementalSfM._loop_probe (the map padded there)
    replayed equals its eager run."""
    scene = _map_scene(cuda)
    n = len(scene[5])
    before = tpipe.LOOP_PROBE_GRAPHS.captures
    for m in (min(n, 60), 100):
        args = _probe_args(scene, m, cuda)
        for seeds in ([7, 8], [9, 10]):
            got = tpipe.loop_probe(*args, seeds, **PROBE_KW)
            want = tpipe._loop_probe_eager(*args, seeds, **PROBE_KW)
            assert _same(got, want), (m, seeds)
            assert got.shape == (2, 14) and int(got[:, 1].max()) >= 15, got[:, :2]
    assert tpipe.LOOP_PROBE_GRAPHS.captures == before + 2 and len(tpipe.LOOP_PROBE_GRAPHS) == 2
    K, gtR, gtT, bufs, desc, X = scene
    sfm = IncrementalSfM(K, (240, 320), cfg=SMALL, device=cuda)
    sfm._bufs = dict(enumerate(bufs))
    Rs, ts = [np.asarray(a, np.float32) for a in gtR], [np.asarray(a, np.float32) for a in gtT]
    rows = []
    for probe in (tpipe.loop_probe, tpipe._loop_probe_eager, tpipe.loop_probe):
        sfm.gen.manual_seed(0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tpipe, "loop_probe", probe)
            rows.append(sfm._loop_probe([1, 2], [1, 2], desc, X, Rs, ts))
    assert np.array_equal(rows[0], rows[1]) and np.array_equal(rows[2], rows[1])
    assert tpipe.LOOP_PROBE_GRAPHS.captures == before + 2   # its bucket's key is one of the two


def test_boot_probe_replay_equals_eager_full_and_short_chunk(cuda):
    """boot_probe over a full chunk of 8 candidates and a short one of 3:
    one graph a chunk size, each replay bit-equal to the eager probe;
    IncrementalSfM._boot_probe (its buffers stacked) replayed equals its
    eager run."""
    K, gtR, gtT, bufs, desc, X = _map_scene(cuda)
    b0 = bufs[0]
    before = tpipe.BOOT_PROBE_GRAPHS.captures
    for chunk in ([1, 2] * 4, [2, 1, 2]):
        c = [bufs[f] for f in chunk]
        args = (b0.desc, b0.valid, torch.stack([b0.x, b0.y], -1),
                torch.stack([x.desc for x in c]), torch.stack([x.valid for x in c]),
                torch.stack([torch.stack([x.x, x.y], -1) for x in c]))
        want = tpipe._boot_probe_eager(*args, ratio_sq=0.7)
        for _ in range(2):
            assert _same(tpipe.boot_probe(*args, ratio_sq=0.7), want), chunk
        assert want.shape == (len(chunk), 2) and bool((want[:, 0] > 10).all())
    assert tpipe.BOOT_PROBE_GRAPHS.captures == before + 2 and len(tpipe.BOOT_PROBE_GRAPHS) == 2
    sfm = IncrementalSfM(K, (240, 320), cfg=SMALL, device=cuda)
    sfm._bufs = dict(enumerate(bufs))
    got = sfm._boot_probe([1, 2, 1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "boot_probe", tpipe._boot_probe_eager)
        want = sfm._boot_probe([1, 2, 1])
    assert np.array_equal(got, want) and tpipe.BOOT_PROBE_GRAPHS.captures == before + 2


def test_new_replays_make_no_host_sync(cuda):
    """With their inputs on the card (the PnP draws' host numbers aside,
    copied without a wait), a 20-iteration pose graph (20 replays), a loop
    probe and a boot probe synchronise no host: the sync debug mode set to
    raise lets them through."""
    scene = _map_scene(cuda)
    pg = _pose_problem(50, list(range(2, 50)), cuda)
    probe = _probe_args(scene, 60, cuda)
    b0, b1, b2 = scene[3]
    boot = (b0.desc, b0.valid, torch.stack([b0.x, b0.y], -1), torch.stack([b1.desc, b2.desc]),
            torch.stack([b1.valid, b2.valid]),
            torch.stack([torch.stack([b.x, b.y], -1) for b in (b1, b2)]))

    def calls():
        return (tpg.optimize_pose_graph(*pg, iters=20, huber=10.0),
                tpipe.loop_probe(*probe, [3, 4], **PROBE_KW), tpipe.boot_probe(*boot))

    before = [c.captures for c in NEW]
    calls()                                         # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            out = calls()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out[0][0]).all() and out[1].shape == (2, 14)
    assert [c.captures for c in NEW] == [b + 1 for b in before]


def test_new_replays_interleave_with_registration_and_lm(cuda):
    """The pose-graph, loop-probe and boot-probe graphs share the capture
    stream and its kernel scratch (the L1 matcher's chunks) with
    REGISTER_GRAPHS and LM_GRAPHS: their replays interleaved, on the
    current stream and on a side stream, each equal its eager call."""
    scene = _map_scene(cuda)
    pg = _pose_problem(10, [9], cuda)
    probe = _probe_args(scene, 60, cuda)
    b0, b1, b2 = scene[3]
    boot = (b0.desc, b0.valid, torch.stack([b0.x, b0.y], -1), torch.stack([b1.desc, b2.desc]),
            torch.stack([b1.valid, b2.valid]),
            torch.stack([torch.stack([b.x, b.y], -1) for b in (b1, b2)]))
    K, start, obs = _ba_start(8, 200, seed=5)
    _, params, bobs, Kt, free = tba._ba_inputs(start, obs, K, (0,), cuda)
    lam = torch.full((), 1e-3, device=cuda)
    want_pg = tpg._optimize_pose_graph_eager(*pg, iters=3, huber=10.0)
    want_probe = tpipe._loop_probe_eager(*probe, [3, 4], **PROBE_KW)
    want_boot = tpipe._boot_probe_eager(*boot)
    want_reg = tpipe._register_from_buffers_eager(*_register_args(scene, 256), **REG_KW)
    want_lm = tba.lm_iteration(params, bobs, Kt, lam, free, n_points=params.X.shape[0])
    side = torch.cuda.Stream(cuda)
    for i in range(4):
        stream = side if i % 2 else torch.cuda.current_stream(cuda)
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            reg = tpipe.register_from_buffers(*_register_args(scene, 256), **REG_KW)
            got_probe = tpipe.loop_probe(*probe, [3, 4], **PROBE_KW)
            step = tba.lm_iteration_replayed(params, bobs, Kt, lam, free)
            got_pg = tpg.optimize_pose_graph(*pg, iters=3, huber=10.0)
            got_boot = tpipe.boot_probe(*boot)
        torch.cuda.current_stream(cuda).wait_stream(stream)
        assert _same(got_probe, want_probe) and _same(got_boot, want_boot), i
        assert all(_same(g, w) for g, w in zip(got_pg, want_pg)), i
        assert all(_same(g, w) for g, w in zip(reg, want_reg)), i
        assert all(_same(g, w) for g, w in zip(step[0], want_lm[0])), i
    assert all(len(c) == 1 for c in NEW + (tpipe.REGISTER_GRAPHS, tba.LM_GRAPHS))


def _eager_all(mp):
    """Every program IncrementalSfM replays on a card patched to its eager
    function, the probes and the pose graph included."""
    _eager_sfm(mp)
    mp.setattr(tpipe, "loop_probe", tpipe._loop_probe_eager)
    mp.setattr(tpipe, "boot_probe", tpipe._boot_probe_eager)
    mp.setattr(tpipe, "optimize_pose_graph", tpg._optimize_pose_graph_eager)


@pytest.mark.parametrize("fused", [True, False])
def test_second_sfm_run_captures_nothing(cuda, fused, monkeypatch):
    """A 7-frame IncrementalSfM run replaying every graph (the fused path's
    probes, or the host loop's frame-by-frame loop closure, and the pose
    graph) equals the run with every eager function bit for bit; a second
    replayed run captures nothing in any cache and gives the same bits."""
    K, seq, _, _ = render_sequence(n_frames=7, n_points=70, seed=0, arc_deg=25.0)
    kw = dict(cfg=SMALL, ba_every=6, fused=fused, device=cuda)
    sfm = IncrementalSfM(K, seq[0].shape, **kw)
    before = [c.captures for c in NEW]
    got = sfm.run(seq)
    new = [c.captures - b for c, b in zip(NEW, before)]
    assert sfm.n_loop_edges >= 1 and new[0] == 1
    assert (new[1] == 1 and new[2] >= 1) if fused else new[1:] == [0, 0], new
    counts = [c.captures for c in CACHES]
    again = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert [c.captures for c in CACHES] == counts
    with monkeypatch.context() as m:
        _eager_all(m)
        want = IncrementalSfM(K, seq[0].shape, **kw).run(seq)
    assert [c.captures for c in CACHES] == counts
    for res in (got, again):
        for f in ("Rs", "ts", "points"):
            a, b = getattr(res, f), getattr(want, f)
            assert a.shape == b.shape and np.array_equal(a, b), f
