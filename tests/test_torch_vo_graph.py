"""``vo_step``'s graph cache on the CPU: its keys, its packed buffers, and
that a CPU state runs the eager step and builds no graph.  The replay
itself runs only on a card (``tests/test_torch_gpu_vo_graph.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig, VOConfig, vo_init, vo_step
from sift_pyocl_tpu_torch.models import vo as tvo
from sift_pyocl_tpu_torch.utils import graphs
from sift_pyocl_tpu_torch.utils.profiling import vo_frames
from _torch_threads import _one_torch_thread  # noqa: F401

SHAPE = (128, 128)
K = np.array([[150.0, 0, 64.0], [0, 150.0, 64.0], [0, 0, 1.0]], np.float32)
CFG = SiftConfig(kp_per_octave_cap=128)
VO = VOConfig(window=3, pts_per_frame=32, obs_per_frame=64, pnp_n=32, pnp_iters=3,
              cg_iters=3, min_track_matches=8)


@pytest.fixture(scope="module")
def run():
    frames = vo_frames(SHAPE, 3)
    state = vo_init(frames[0], K, CFG, VO, device="cpu")
    return frames, state


def _key(shape=SHAPE, dtype=torch.float32, cfg=CFG, vo=VO, device="cuda:0"):
    return graphs.graph_key(device, (torch.zeros(shape, dtype=dtype), torch.zeros(3, 3)),
                            (cfg, vo))


@pytest.mark.parametrize("change", [
    {"shape": (96, 128)}, {"dtype": torch.uint8},
    {"cfg": dataclasses.replace(CFG, mask_backend="fused")},
    {"cfg": dataclasses.replace(CFG, kp_per_octave_cap=256)},
    {"vo": VO._replace(pnp_iters=4)}, {"vo": VO._replace(window=4)},
    {"device": "cuda:1"}, {"device": "cpu"},
])
def test_graph_key_differs_for_each_static_change(change):
    assert _key(**change) != _key()
    assert _key(**change) == _key(**change) and hash(_key(**change)) == hash(_key(**change))


def test_graph_key_is_equal_for_equal_arguments():
    """Equal configs made apart, and other tensors of one shape and dtype
    on the same device, give one key."""
    a = graphs.graph_key(torch.device("cuda", 0),
                         (torch.ones(SHAPE), torch.full((3, 3), 2.0)),
                         (SiftConfig(kp_per_octave_cap=128), VO._replace()))
    assert a == _key() and hash(a) == hash(_key())
    with pytest.raises(TypeError):
        graphs.graph_key("cuda:0", (), ([1, 2],))     # a static argument must hash


def test_layout_packs_and_unpacks_every_dtype_aligned():
    """The packed buffer that a graph writes its outputs into (one cat)
    gives back each tensor bit for bit, every one at a 16-byte offset, and
    two layouts that share their first specs share those offsets."""
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32)),
          torch.tensor(7, dtype=torch.int32), torch.from_numpy(rng.random(5) < 0.5),
          torch.from_numpy(rng.integers(0, 256, (7, 2), dtype=np.uint8)),
          torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))[::2]]
    lay = graphs._Layout([(tuple(t.shape), t.dtype) for t in ts])
    flat = torch.cat(lay.parts(ts, torch.zeros(graphs.ALIGN, dtype=torch.uint8)))
    assert flat.numel() == lay.nbytes and lay.offsets == [0, 48, 64, 80, 96]
    for got, want in zip(lay.views(flat), ts):
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert got.storage_offset() * got.element_size() % graphs.ALIGN == 0
    longer = graphs._Layout([(tuple(t.shape), t.dtype) for t in ts[:3]] + [((9,), torch.int32)])
    assert longer.offsets[:3] == lay.offsets[:3]


def test_layout_fill_writes_what_one_cat_writes():
    """The input copy of every call (``_Layout.fill``) over a buffer of
    garbage leaves the bytes of one cat of the inputs, and each view of the
    buffer then equals its input."""
    rng = np.random.default_rng(1)
    ts = [torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)),
          torch.from_numpy(rng.random((2, 3)) < 0.5), torch.tensor(3.5, dtype=torch.float64),
          torch.from_numpy(rng.integers(0, 9, (3, 3), dtype=np.int64)).T]
    lay = graphs._Layout([(tuple(t.shape), t.dtype) for t in ts])
    pad = torch.zeros(graphs.ALIGN, dtype=torch.uint8)
    flat = torch.full((lay.nbytes,), 0xA5, dtype=torch.uint8)
    lay.fill(flat, ts, pad)
    assert torch.equal(flat, torch.cat(lay.parts(ts, pad)))
    for got, want in zip(lay.views(flat), ts):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_graph_cache_needs_a_cuda_device():
    cache = graphs.GraphCache(lambda static, x: (x,))
    with pytest.raises(ValueError, match="CUDA"):
        cache("cpu", None, (torch.zeros(2),))
    assert len(cache) == 0 and cache.captures == 0


def test_cpu_step_is_the_eager_step_and_builds_no_graph(run):
    """On the CPU ``vo_step`` is ``_vo_step_eager``, bit for bit, and the
    graph cache stays empty; so is it with plain=True and on_stage."""
    frames, state = run
    before = tvo.STEP_GRAPHS.captures
    got = vo_step(state, frames[1], K, CFG, VO)
    want = tvo._vo_step_eager(state, frames[1], K, CFG, VO)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    stages = []
    staged = vo_step(state, frames[1], K, CFG, VO, on_stage=stages.append)
    assert stages == ["frontend", "match", "pnp", "roll_spawn", "ba"]
    for g, w in zip(staged[0], want[0]):
        assert torch.equal(g, w)
    vo_step(state, frames[1], K, CFG, VO, plain=True)
    assert len(tvo.STEP_GRAPHS) == 0 and tvo.STEP_GRAPHS.captures == before
    assert bool(got[1].tracked)


def test_returned_tensors_share_no_storage_with_the_state(run):
    """No tensor ``vo_step`` returns shares memory with the state it was
    given (the contract a replay keeps by cloning its output buffer), and
    the given state is left as it was."""
    frames, state = run
    kept = [t.clone() for t in state]
    new_state, out = vo_step(state, frames[1], K, CFG, VO)
    given = {t.untyped_storage().data_ptr() for t in state}
    for name, t in zip(new_state._fields + out._fields, (*new_state, *out)):
        assert t.untyped_storage().data_ptr() not in given, name
    for a, b in zip(state, kept):
        assert torch.equal(a, b)
