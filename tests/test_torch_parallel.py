"""The port's frame-parallel video frontend and two-stage pipeline
(sift_pyocl_tpu_torch/parallel/) on CPU stand-in devices, against the JAX
package's on its virtual CPU devices (tests/test_video.py's and
tests/test_pipeline_octaves.py's configs), and against the port's own
single-frame buffers bit for bit."""

import jax
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.parallel.pipeline_octaves import TwoStagePipeline as JaxPipeline
from sift_pyocl_tpu.parallel.video import VideoSiftFrontend as JaxVideo
from sift_pyocl_tpu.parallel.video import make_frames_mesh as jax_mesh
from sift_pyocl_tpu.utils.testimage import synthetic_scene

from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe, from_jax_config
from sift_pyocl_tpu_torch.parallel import (TwoStagePipeline, VideoSiftFrontend, batched_sift,
                                           make_frames_mesh, sharded_sift_fn)

from conftest import match_keypoint_sets
from _torch_threads import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
FIELDS = ("x", "y", "scale", "angle", "desc")


def _records(buf):
    m = np.asarray(buf.valid)
    out = np.zeros(int(m.sum()), dtype=[("x", "f4"), ("y", "f4"), ("scale", "f4"),
                                         ("angle", "f4"), ("desc", "u1", 128)])
    for fld in FIELDS:
        out[fld] = np.asarray(getattr(buf, fld))[m]
    return out


def _frame(buf, f):
    return type(buf)(*[t[f] for t in buf])


def _assert_bit_equal(a, b, tag):
    for fld in a._fields:
        assert torch.equal(getattr(a, fld), getattr(b, fld)), (tag, fld)


def test_video_frontend_matches_jax_on_four_devices():
    """tests/test_video.py's case on 4 devices: 96x96 frames,
    SiftConfig(kp_per_octave_cap=128).  The JAX package runs its XLA path
    on the CPU ("auto"), the port its kernel path (plain versions), whose
    slot layouts differ, so each frame is held as a set: counts equal, as
    many keypoints, every JAX keypoint matched within match_keypoint_sets'
    limits and mean u8 descriptor L1 < 0.01, as tests/test_torch_sift.py.
    Each port frame equals the port's single-frame buffer bit for bit."""
    n = 4
    frames = np.stack([synthetic_scene((96, 96), n_blobs=12, seed=s) for s in range(n)])
    jcfg = JaxConfig(kp_per_octave_cap=128)
    want = JaxVideo((96, 96), batch=n, cfg=jcfg, mesh=jax_mesh(n))(frames)
    want = jax.tree_util.tree_map(np.asarray, want)
    cfg = from_jax_config(jcfg)
    fe = VideoSiftFrontend((96, 96), batch=n, cfg=cfg, mesh=make_frames_mesh(devices=[CPU] * n))
    got = fe(frames)
    assert got.valid.shape[0] == n and got.x.device == CPU
    total = 0
    for i in range(n):
        single = detect_and_describe(torch.from_numpy(frames[i]), cfg)
        _assert_bit_equal(_frame(got, i), single, i)
        np.testing.assert_array_equal(got.counts[i].numpy(), want.counts[i])
        w, g = _records(_frame(want, i)), _records(_frame(got, i))
        hits, desc_l1 = match_keypoint_sets(w, g)
        assert hits == len(w) == len(g), (i, hits, len(w), len(g))
        assert desc_l1 < 0.01, (i, desc_l1)
        total += len(w)
    assert total > 20


def test_sharded_fn_and_batched_sift_on_cpu_devices():
    cfg = SiftConfig(kp_per_octave_cap=128)
    frames = torch.from_numpy(np.stack([synthetic_scene((96, 96), n_blobs=10, seed=s)
                                        for s in range(4)]))
    one = batched_sift(frames, cfg)
    assert one.valid.shape[0] == 4 and int(one.valid.sum()) > 0
    mesh = make_frames_mesh(devices=[CPU] * 2)
    _assert_bit_equal(sharded_sift_fn(mesh, cfg)(frames), one, "2 shards")
    with pytest.raises(ValueError, match="not divisible"):
        sharded_sift_fn(mesh, cfg)(frames[:3])
    with pytest.raises(ValueError, match="no axis"):
        sharded_sift_fn(mesh, cfg, axis="rows")


def test_frames_mesh_and_frontend_checks(monkeypatch):
    mesh = make_frames_mesh(devices=[CPU] * 4)
    assert mesh.size == 4 and mesh.axis_names == ("frames",)
    assert mesh.devices == (CPU,) * 4
    assert make_frames_mesh(2, axis="f", devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="divisible"):
        VideoSiftFrontend((96, 96), batch=3, mesh=mesh)
    fe = VideoSiftFrontend((96, 96), batch=4, mesh=mesh)
    with pytest.raises(ValueError, match="expected"):
        fe(np.zeros((4, 96, 64), np.float32))
    # no card: the defaults (every CUDA device) raise instead of taking the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_frames_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwoStagePipeline((96, 96), SiftConfig())


def test_two_stage_pipeline_matches_jax():
    """tests/test_pipeline_octaves.py's case: three 128x128 frames,
    SiftConfig(kp_per_octave_cap=256, conv_backend="xla", kp_backend="xla"),
    two devices.  valid and counts equal to the JAX pipeline's, every JAX
    keypoint matched within match_keypoint_sets' limits and mean descriptor
    L1 < 0.01; each port frame bit-equal to its single-frame buffer, in
    order, on the second device."""
    jcfg = JaxConfig(kp_per_octave_cap=256, conv_backend="xla", kp_backend="xla")
    frames = [synthetic_scene((128, 128), n_blobs=12, seed=s) for s in range(3)]
    want = list(JaxPipeline((128, 128), jcfg, devices=jax.devices()[:2]).process(frames))
    cfg = from_jax_config(jcfg)
    pipe = TwoStagePipeline((128, 128), cfg, devices=[CPU, CPU])
    got = list(pipe.process(frames))
    assert len(got) == 3
    for f, (g, w) in enumerate(zip(got, want)):
        assert g.x.device == pipe.d1
        _assert_bit_equal(g, detect_and_describe(torch.from_numpy(frames[f]), cfg), f)
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        np.testing.assert_array_equal(g.counts.numpy(), np.asarray(w.counts))
        wr = _records(w)
        hits, desc_l1 = match_keypoint_sets(wr, _records(g))
        assert hits == len(wr) > 5 and desc_l1 < 0.01, (f, hits, len(wr), desc_l1)
    # one device stands for both stages
    single = TwoStagePipeline((128, 128), cfg, devices=[CPU])
    assert single.d0 == single.d1 == CPU
    _assert_bit_equal(next(iter(single.process(frames[:1]))), got[0], "one device")
    assert list(single.process([])) == []
