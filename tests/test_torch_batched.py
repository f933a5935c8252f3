"""The batched frontend (BASELINE config 3): the port's
detect_and_describe_batched against the JAX package's on the scenes and
configs of tests/test_batched.py (its Pallas kernels in interpret mode; the
XLA path), against the port's own single-frame buffers bit for bit, the
octave numbers of a batch's entry list (oct_ids), and the split of a long
entry list into kernel launches.  On the CPU every kernel wrapper runs its
plain PyTorch version."""

import dataclasses
import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.models import sift as jsift
from sift_pyocl_tpu.utils.testimage import synthetic_scene

from sift_pyocl_tpu_torch import (SiftConfig, detect_and_describe, detect_and_describe_batched,
                                  from_jax_config)
from sift_pyocl_tpu_torch.models import sift as tsift
from sift_pyocl_tpu_torch.ops import _build
from sift_pyocl_tpu_torch.ops.detect import detect_all_slots
from sift_pyocl_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from sift_pyocl_tpu_torch.ops.kernels.maskk import extrema_masks_ref
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
from sift_pyocl_tpu_torch.utils.convert import keypoint_buffer_from_jax

from conftest import match_keypoint_sets
from _torch_threads import _one_torch_thread  # noqa: F401

FIELDS = ("x", "y", "scale", "angle", "desc")


def _frames(shape, n_blobs, seeds):
    return np.stack([np.asarray(synthetic_scene(shape, n_blobs=n_blobs, seed=s)) for s in seeds])


def _streaks(shape, n, seed):
    """A frame of n elongated Gaussian streaks (axis ratio 2-8), whose DoG
    extrema include some that only octave 0's stricter edge threshold
    (edge_thresh1) rejects."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    img = np.zeros(shape)
    for _ in range(n):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        th = rng.uniform(0, np.pi)
        s1 = rng.uniform(1.5, 4)
        s2 = s1 * rng.uniform(2, 8)
        a = rng.uniform(-120, 120)
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        img += a * np.exp(-0.5 * ((u / s2) ** 2 + (v / s1) ** 2))
    return (img + 128).clip(0, 255).astype(np.float32)


def _records(buf, f):
    m = np.asarray(buf.valid[f])
    out = np.zeros(int(m.sum()), dtype=[("x", "f4"), ("y", "f4"), ("scale", "f4"),
                                         ("angle", "f4"), ("desc", "u1", 128)])
    for fld in FIELDS:
        out[fld] = np.asarray(getattr(buf, fld)[f])[m]
    return out


@pytest.fixture(scope="module")
def pallas_case():
    """tests/test_batched.py's Pallas case: two 160x160 frames, the JAX
    batched buffer (interpret mode, jitted once) and its config."""
    cfg = dataclasses.replace(JaxConfig(), kp_backend="pallas", pallas_interpret=True)
    imgs = _frames((160, 160), 30, (3, 7))
    want = jax.jit(partial(jsift.detect_and_describe_batched, cfg=cfg))(jnp.asarray(imgs))
    return imgs, cfg, jax.tree_util.tree_map(np.asarray, want)


def _hold_to_jax(got, want, n_frames):
    """valid and counts equal frame by frame, every JAX keypoint matched
    within match_keypoint_sets' limits (x/y 0.1 px, scale 0.05, angle 0.05
    rad) and mean u8 descriptor L1 < 0.01, as tests/test_torch_sift.py."""
    assert got.valid.shape == want.valid.shape and got.desc.shape == want.desc.shape
    assert tuple(got.counts.shape) == want.counts.shape
    for f in range(n_frames):
        np.testing.assert_array_equal(got.valid[f].numpy(), want.valid[f])
        np.testing.assert_array_equal(got.counts[f].numpy(), want.counts[f])
        w, g = _records(want, f), _records(got, f)
        assert len(w) > 10
        hits, desc_l1 = match_keypoint_sets(w, g)
        assert hits == len(w), (f, hits, len(w))
        assert desc_l1 < 0.01, (f, desc_l1)


def test_batched_matches_jax_pallas_interpret(pallas_case):
    imgs, jcfg, want = pallas_case
    cfg = from_jax_config(jcfg)
    reset_launch_counts()
    got = detect_and_describe_batched(torch.from_numpy(imgs), cfg)
    assert sum(launch_counts().values()) == 0       # CPU tensors: plain versions only
    _hold_to_jax(got, want, 2)


def test_batched_xla_path_matches_jax():
    """tests/test_batched.py's XLA case: two 128x128 frames, frame by frame
    on both sides (no cross-octave launch to share)."""
    jcfg = dataclasses.replace(JaxConfig(), kp_backend="xla")
    imgs = _frames((128, 128), 20, (1, 2))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        partial(jsift.detect_and_describe_batched, cfg=jcfg))(jnp.asarray(imgs)))
    got = detect_and_describe_batched(torch.from_numpy(imgs), from_jax_config(jcfg))
    _hold_to_jax(got, want, 2)


def test_keypoint_buffer_from_jax_takes_the_batched_buffer(pallas_case):
    _, _, want = pallas_case
    buf = keypoint_buffer_from_jax(want)
    assert buf.x.shape == want.x.shape and buf.x.ndim == 2
    assert buf.desc.shape == want.desc.shape and buf.desc.dtype == torch.uint8
    assert buf.counts.shape == want.counts.shape and buf.valid.dtype == torch.bool
    np.testing.assert_array_equal(buf.y.numpy(), want.y)


@pytest.mark.parametrize("kw", [{}, {"mask_backend": "pallas"}, {"mask_backend": "fused"},
                                {"desc_buckets": 2}, {"kp_multi_launch": False},
                                {"kp_backend": "xla"}],
                         ids=["default", "mask_k8", "fused", "buckets", "per_octave", "xla"])
def test_batched_equals_single_frames_bit_for_bit(kw):
    """Each frame of the batched buffer is, in every field and bit, the
    single-frame buffer: every kernel (here its plain version) works in
    entry-local coordinates."""
    cfg = SiftConfig(kp_per_octave_cap=256, **kw)
    imgs = torch.from_numpy(_frames((128, 128), 20, (1, 2, 5)))
    got = detect_and_describe_batched(imgs, cfg)
    assert int(got.valid.sum()) > 30
    for f in range(3):
        one = detect_and_describe(imgs[f], cfg)
        for fld in one._fields:
            assert torch.equal(getattr(got, fld)[f], getattr(one, fld)), (kw, f, fld)


def test_batched_entries_take_their_octave_numbers():
    """Frame 1's octave 0 is entry n_oct of the batch: taken from its list
    position it would get octave n_oct's edge threshold (edge_thresh, not
    edge_thresh1) and octave size (2^n_oct, not 1), and so other masks and
    coordinates than the frame alone gives."""
    cfg = SiftConfig(kp_per_octave_cap=256)
    imgs = torch.from_numpy(np.stack([_frames((160, 160), 30, (3,))[0],
                                      _streaks((160, 160), 60, 1)]))
    octs = [build_scale_space(imgs[f], cfg) for f in range(2)]
    n_oct = len(octs[0])
    entries = [d for _, d in octs[0] + octs[1]]
    ids = list(range(n_oct)) * 2
    by_id = extrema_masks_ref(entries, cfg, ids)
    by_pos = extrema_masks_ref(entries, cfg)
    single = extrema_masks_ref([d for _, d in octs[1]], cfg)
    assert torch.equal(by_id[n_oct], single[0])
    assert not torch.equal(by_pos[n_oct], single[0])     # the test can see the fault
    caps = [c for c, _ in tsift.octave_capacities((160, 160), cfg)] * 2
    # the true extrema counts (mask population) of frame 1's octave 0
    _, total_id = detect_all_slots(entries, cfg, caps, oct_ids=ids)
    _, total_pos = detect_all_slots(entries, cfg, caps)
    assert total_id[n_oct] == single[0].sum() < total_pos[n_oct]
    want = detect_and_describe(imgs[1], cfg)
    n = want.x.shape[0]
    buf = tsift._describe_octaves_multi(octs[0] + octs[1], caps, cfg, False, oct_ids=ids)
    assert torch.equal(buf.x[n:], want.x) and torch.equal(buf.counts[n_oct:], want.counts)
    buf = tsift._describe_octaves_multi(octs[0] + octs[1], caps, cfg, False)
    assert not torch.equal(buf.x[n:], want.x)
    with pytest.raises(ValueError, match="one octave number per DoG stack"):
        detect_all_slots(entries, cfg, caps, oct_ids=ids[:-1])


def test_entry_chunks_split_a_long_entry_list():
    """The launches of K3/K4/K5/K8 over n entries: one up to MAX_ENTRIES
    (csrc/common.cuh's SIFT_MAX_OCT), which holds a batch of 8 1080x1920
    frames (56 entries) and of 9 (63); then parts of at most MAX_ENTRIES,
    in order, covering every entry once."""
    header = (Path(_build.CSRC_DIR) / "common.cuh").read_text()
    assert int(re.search(r"#define SIFT_MAX_OCT (\d+)", header).group(1)) == _build.MAX_ENTRIES
    n_oct = SiftConfig().n_octaves((1080, 1920))
    assert n_oct == 7
    assert _build.entry_chunks(8 * n_oct) == [(0, 56)]
    assert _build.entry_chunks(9 * n_oct) == [(0, 63)]
    assert _build.entry_chunks(12 * n_oct) == [(0, 64), (64, 84)]
    assert _build.entry_chunks(1) == [(0, 1)]
    for n in (1, 7, 63, 64, 65, 128, 129, 300):
        for limit in (1, 5, 64):
            parts = _build.entry_chunks(n, limit)
            assert all(0 < b - a <= limit for a, b in parts)
            assert [i for a, b in parts for i in range(a, b)] == list(range(n))
    for n, limit in ((0, 64), (3, 0)):
        with pytest.raises(ValueError):
            _build.entry_chunks(n, limit)


def test_batched_checks_its_input():
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        detect_and_describe_batched(torch.zeros(64, 64), SiftConfig())
    with pytest.raises(ValueError, match="kp_backend"):
        detect_and_describe_batched(torch.zeros(1, 64, 64), SiftConfig(kp_backend="nope"))
