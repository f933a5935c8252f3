"""The batched frontend on a CUDA card (skipped without one): one launch
each of K3, K4, K5, K6 and K8 for a batch of up to MAX_ENTRIES octave
entries, the split launches past it, K8's per-entry octave numbers, and
every frame of the batched buffer bit-equal to its single-frame buffer.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_batched.py -q
"""

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig, detect_and_describe, detect_and_describe_batched
from sift_pyocl_tpu_torch.ops import _build
from sift_pyocl_tpu_torch.ops.kernels import launch_counts, maskk, reset_launch_counts
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
from sift_pyocl_tpu_torch.utils.testimage import synthetic_scene, textured_scene

pytestmark = pytest.mark.gpu
SHAPE = (1080, 1920)
BATCH_KERNELS = ("compact_masks_multi", "refine_multi", "grad_atlas", "orient_desc_fused")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _frames(shape, n, cuda):
    base = synthetic_scene(shape, n_blobs=200, seed=0)
    return torch.from_numpy(np.stack([base + i for i in range(n)])).to(cuda)


def _assert_frames_equal_singles(buf, imgs, cfg, frames=None):
    for f in frames if frames is not None else range(imgs.shape[0]):
        one = detect_and_describe(imgs[f], cfg)
        for fld in one._fields:
            assert torch.equal(getattr(buf, fld)[f], getattr(one, fld)), (f, fld)


def _batched(imgs, cfg):
    reset_launch_counts()
    buf = detect_and_describe_batched(imgs, cfg)
    torch.cuda.synchronize()
    return buf, launch_counts()


@pytest.mark.parametrize("kw", [{}, {"mask_backend": "pallas"}, {"mask_backend": "fused"},
                                {"desc_buckets": 2}], ids=["default", "mask_k8", "fused",
                                                          "buckets"])
def test_batch_of_8_is_one_launch_each_and_bit_equal(cuda, kw):
    """B = 8 at 1080x1920 (56 entries): K3, K4, K5 once and K6 once (twice
    with desc_buckets), K8 once with "pallas", K1/K2 (or K1m/K2m) once a
    frame; every frame's buffer equal, bit for bit, to its single-frame one."""
    cfg = SiftConfig(**kw)
    imgs = _frames(SHAPE, 8, cuda)
    buf, counts = _batched(imgs, cfg)
    assert buf.x.shape[0] == 8 and buf.counts.shape == (8, 7, 2)
    k6 = 2 if kw.get("desc_buckets") else 1
    assert [counts[k] for k in BATCH_KERNELS] == [1, 1, 1, k6], counts
    assert counts["extrema_masks"] == (1 if kw.get("mask_backend") == "pallas" else 0)
    ladders = (("octave0_ladder_mask", "small_octaves_ladder_mask")
               if kw.get("mask_backend") == "fused" else ("octave0_ladder", "small_octaves_ladder"))
    assert [counts[k] for k in ladders] == [8, 8], counts
    _assert_frames_equal_singles(buf, imgs, cfg)


def test_batch_of_12_splits_its_launches(cuda):
    """B = 12 at 1080x1920 (84 entries): K3, K4 and K5 in two launches
    (64 + 20 entries), K6 in one, every frame bit-equal; and 150 entries of
    smaller frames in three launches each, K8 too."""
    cfg = SiftConfig()
    imgs = _frames(SHAPE, 12, cuda)
    buf, counts = _batched(imgs, cfg)
    assert _build.entry_chunks(84) == [(0, 64), (64, 84)]
    assert [counts[k] for k in BATCH_KERNELS] == [2, 2, 2, 1], counts
    _assert_frames_equal_singles(buf, imgs, cfg)
    cfg = SiftConfig(mask_backend="pallas")
    small = _frames((256, 256), 30, cuda)
    n_oct = cfg.n_octaves((256, 256))
    n_launch = len(_build.entry_chunks(30 * n_oct))
    assert n_launch >= 3
    buf, counts = _batched(small, cfg)
    assert [counts[k] for k in BATCH_KERNELS + ("extrema_masks",)] == [n_launch] * 3 + [1, n_launch]
    _assert_frames_equal_singles(buf, small, cfg, frames=(0, 13, 29))


def test_k8_takes_each_entrys_octave_number(cuda):
    """K8 over two frames' entries: entry n_oct (frame 1's octave 0) takes
    octave 0's edge threshold from oct_ids, as the stencil does, and not
    octave n_oct's, which its list position would give; the batched
    "pallas" buffer's frame 1 equals the frame alone."""
    cfg = SiftConfig(mask_backend="pallas")
    imgs = torch.from_numpy(np.stack([synthetic_scene((256, 256), n_blobs=40, seed=0),
                                      textured_scene((256, 256), seed=1)])).to(cuda)
    entries = [d for f in range(2) for _, d in build_scale_space(imgs[f], cfg)]
    n_oct = len(entries) // 2
    ids = list(range(n_oct)) * 2
    got = maskk.extrema_masks(entries, cfg, ids)
    want = maskk.extrema_masks_ref(entries, cfg, ids)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    by_pos = maskk.extrema_masks(entries, cfg)
    assert int(by_pos[n_oct].sum()) > int(got[n_oct].sum())
    buf, counts = _batched(imgs, cfg)
    assert counts["extrema_masks"] == 1
    _assert_frames_equal_singles(buf, imgs, cfg)
