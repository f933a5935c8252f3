"""``vo_step``'s CUDA graph on a card (skipped without one): replayed steps
against the eager step, bit for bit, at 256x256 with a small VOConfig.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_vo_graph.py -q
"""

import gc

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig, VOConfig, vo_init, vo_step
from sift_pyocl_tpu_torch.models import vo as tvo
from sift_pyocl_tpu_torch.utils import graphs
from sift_pyocl_tpu_torch.utils.profiling import vo_frames

pytestmark = pytest.mark.gpu
SHAPE = (256, 256)
CFG = SiftConfig(kp_per_octave_cap=256)
VO = VOConfig(window=4, pts_per_frame=64, obs_per_frame=128, pnp_n=128)
STEPS = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    tvo.STEP_GRAPHS.clear()
    yield torch.device("cuda", 0)
    tvo.STEP_GRAPHS.clear()


def _K(shape, dev=None):
    h, w = shape
    K = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], np.float32)
    return K if dev is None else torch.from_numpy(K).to(dev)


def _assert_equal(tag, got, want):
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{tag}: {name}"
        assert torch.equal(g, w), f"{tag}: {name} differs in {int((g != w).sum())} places"


def _run(step, state, frames, K):
    outs = []
    for f in frames:
        state, out = step(state, f, K, CFG, VO)
        outs.append((state, out))
    return outs


def test_replayed_steps_equal_eager_steps_and_stay_unchanged(cuda):
    """6 steps through the graph (the first captures) against 6 eager steps
    from the same state: every VOState field and VOOut bit-equal at every
    step, every frame tracked; each result kept by the caller is still
    equal after the later replays (none is overwritten)."""
    frames = [torch.from_numpy(f).to(cuda) for f in vo_frames(SHAPE, STEPS + 1)]
    K = _K(SHAPE, cuda)
    state0 = vo_init(frames[0], K, CFG, VO)
    eager = _run(tvo._vo_step_eager, state0, frames[1:], K)
    replay = []
    state = state0
    before = tvo.STEP_GRAPHS.captures
    for f in frames[1:]:
        given = {t.untyped_storage().data_ptr() for t in state}
        state, out = vo_step(state, f, K, CFG, VO)
        # no returned tensor shares memory with the state it was given
        assert not given & {t.untyped_storage().data_ptr() for t in (*state, *out)}
        replay.append((state, out))
        copies = (type(state)(*(t.clone() for t in state)), type(out)(*(t.clone() for t in out)))
        if len(replay) > 1:
            _assert_equal("the previous step's state after a replay", replay[-2][0], kept[0])
            _assert_equal("the previous step's output after a replay", replay[-2][1], kept[1])
        kept = copies
    assert len(tvo.STEP_GRAPHS) == 1 and tvo.STEP_GRAPHS.captures == before + 1
    for i, ((gs, go), (ws, wo)) in enumerate(zip(replay, eager)):
        _assert_equal(f"step {i + 1} state", gs, ws)
        _assert_equal(f"step {i + 1} output", go, wo)
        assert bool(go.tracked), f"step {i + 1} not tracked"


def test_host_frames_and_K_replay_the_same_graph(cuda):
    """Host frames and a host K (as the fence and the CLI pass them) key
    and replay the graph that device frames do, with the same bits."""
    host = vo_frames(SHAPE, 4)
    dev_frames = [torch.from_numpy(f).to(cuda) for f in host]
    state0 = vo_init(dev_frames[0], _K(SHAPE, cuda), CFG, VO)
    got = _run(vo_step, state0, host[1:], _K(SHAPE))
    want = _run(vo_step, state0, dev_frames[1:], _K(SHAPE, cuda))
    assert len(tvo.STEP_GRAPHS) == 1
    for (gs, go), (ws, wo) in zip(got, want):
        _assert_equal("state", gs, ws)
        _assert_equal("output", go, wo)


def test_second_frame_shape_gets_its_own_graph(cuda):
    """Another frame shape (and so other state shapes) captures a second
    graph; both shapes' replays equal their eager steps; a step of the
    first shape after the second replays the first graph."""
    runs = {}
    before = tvo.STEP_GRAPHS.captures
    for shape in (SHAPE, (192, 256)):
        frames = [torch.from_numpy(f).to(cuda) for f in vo_frames(shape, 3)]
        K = _K(shape, cuda)
        state0 = vo_init(frames[0], K, CFG, VO)
        runs[shape] = (state0, frames, K)
        for (gs, go), (ws, wo) in zip(_run(vo_step, state0, frames[1:], K),
                                      _run(tvo._vo_step_eager, state0, frames[1:], K)):
            _assert_equal(f"{shape} state", gs, ws)
            _assert_equal(f"{shape} output", go, wo)
    assert len(tvo.STEP_GRAPHS) == 2 and tvo.STEP_GRAPHS.captures == before + 2
    state0, frames, K = runs[SHAPE]
    _assert_equal("first shape again", vo_step(state0, frames[1], K, CFG, VO)[1],
                  tvo._vo_step_eager(state0, frames[1], K, CFG, VO)[1])
    assert tvo.STEP_GRAPHS.captures == before + 2


def _fill_free_small_blocks(dev, stream, limit=1 << 18):
    """Take every free block of the caching allocator's small pool on
    `stream` (512-byte requests, best fit, until it reserves a new segment)
    and fill it with garbage; returns the tensors, which hold it."""
    held = []
    with torch.cuda.stream(stream):
        reserved = torch.cuda.memory_reserved(dev)
        while torch.cuda.memory_reserved(dev) == reserved and len(held) < limit:
            held.append(torch.full((512,), 0xA5, dtype=torch.uint8, device=dev))
        held += [torch.full((64 << 20,), 0x5A, dtype=torch.uint8, device=dev) for _ in range(2)]
    return held


def test_replays_survive_dropped_kernel_caches(cuda):
    """A captured step keeps alive the cached device tensors its kernels
    read (K3's scratch, K7's counters, K1 and K2's tap and schedule tables,
    the blur taps): with every such cache emptied after the capture, and
    every free block of the allocator's small pool on both streams taken
    and filled with garbage, the replays still give the eager steps'
    bits."""
    from sift_pyocl_tpu_torch.ops import pyramid
    from sift_pyocl_tpu_torch.ops.kernels import compact, ladder, matchk

    frames = [torch.from_numpy(f).to(cuda) for f in vo_frames(SHAPE, STEPS + 1)]
    K = _K(SHAPE, cuda)
    state0 = vo_init(frames[0], K, CFG, VO)
    eager = _run(tvo._vo_step_eager, state0, frames[1:], K)
    state, _ = vo_step(state0, frames[1], K, CFG, VO)           # captures
    held = [t for g in tvo.STEP_GRAPHS._graphs.values() for t in g.holds]
    assert len(held) >= 4, f"the capture holds {len(held)} cached tensors"
    del held
    ladder._taps_table.cache_clear()
    ladder._small_plan.cache_clear()
    pyramid._taps.cache_clear()
    matchk._counters.clear()
    compact._scratch.clear()
    gc.collect()
    torch.cuda.synchronize()
    # the allocator reuses a freed block only on the stream it was made on
    garbage = [t for stream in (torch.cuda.current_stream(cuda), graphs._STREAMS[cuda])
               for t in _fill_free_small_blocks(cuda, stream)]
    torch.cuda.synchronize()
    replay = _run(vo_step, state, frames[2:], K)
    assert len(tvo.STEP_GRAPHS) == 1
    for i, ((gs, go), (ws, wo)) in enumerate(zip(replay, eager[1:])):
        _assert_equal(f"step {i + 2} state", gs, ws)
        _assert_equal(f"step {i + 2} output", go, wo)
    del garbage


def test_replayed_step_makes_no_host_sync(cuda):
    """A replayed step on device inputs synchronises no host: the sync
    debug mode set to raise lets it through."""
    frames = [torch.from_numpy(f).to(cuda) for f in vo_frames(SHAPE, 4)]
    K = _K(SHAPE, cuda)
    state, _ = vo_step(vo_init(frames[0], K, CFG, VO), frames[1], K, CFG, VO)   # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[2:]:
            state, out = vo_step(state, f, K, CFG, VO)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(out.tracked)


def test_graph_cache_chains_evicts_and_keeps_results(cuda):
    """``GraphCache`` on a small function: each result fed back as the next
    input gives the eager chain's bits; results held by the caller survive
    later replays; a host input is copied in beside the device ones; a
    third key evicts the least recently used of two, whose next call
    captures again."""
    from sift_pyocl_tpu_torch.utils.graphs import GraphCache

    def fn(static, x, y):
        return x * static + y, (x.sum() > 0)

    cache = GraphCache(fn)
    cache.max_graphs = 2
    x = torch.arange(6, dtype=torch.float32, device=cuda)
    y = torch.ones(6, device=cuda)
    held, want = [], x
    for _ in range(4):
        x, flag = cache(cuda, 0.5, (x, y))
        held.append(x)
        want = fn(0.5, want, y)[0]
        assert torch.equal(x, want) and bool(flag)
    # the first result, held through three later replays, is still its own
    assert torch.equal(held[0], 0.5 * torch.arange(6, dtype=torch.float32, device=cuda) + 1)
    assert torch.equal(cache(cuda, 0.5, (x, y.cpu()))[0], fn(0.5, x, y)[0])
    assert cache.captures == 1
    cache(cuda, 2.0, (x, y))
    cache(cuda, 3.0, (x, y))                      # evicts the 0.5 graph
    assert len(cache) == 2 and cache.captures == 3
    assert torch.equal(cache(cuda, 0.5, (x, y))[0], fn(0.5, x, y)[0])
    assert cache.captures == 4 and len(cache) == 2
    cache.clear()
    assert len(cache) == 0
