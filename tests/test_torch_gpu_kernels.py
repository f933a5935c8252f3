"""Kernel-vs-plain parity on a CUDA card (skipped without one).

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py -q
"""

import dataclasses

import pytest
import torch

from sift_pyocl_tpu_torch import SLICE_CONFIG, detect_and_describe
from sift_pyocl_tpu_torch.models.sift import octave_capacities, to_keypoint_records
from sift_pyocl_tpu_torch.ops.detect import decode_compacted, extrema_mask
from sift_pyocl_tpu_torch.ops.kernels import (compact, gradpad, launch_counts, refine,
                                              reset_launch_counts, window)
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
from sift_pyocl_tpu_torch.utils.testimage import match_keypoint_sets, synthetic_scene

pytestmark = pytest.mark.gpu
CFG = dataclasses.replace(SLICE_CONFIG, kp_per_octave_cap=256)
SHAPE = (240, 320)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def stage_inputs(cuda):
    img = torch.from_numpy(synthetic_scene(SHAPE, n_blobs=30, seed=2)).to(cuda)
    octaves = build_scale_space(img, CFG)
    dogs = [d for _, d in octaves]
    masks = [extrema_mask(d, CFG, o) for o, d in enumerate(dogs)]
    caps = [c for c, _ in octave_capacities(SHAPE, CFG)]
    return img, octaves, dogs, masks, caps


def test_compact_and_refine_kernels_match_plain(stage_inputs):
    """Compaction exact; refinement exact (same operation order, the
    library is built with --fmad=false)."""
    _, _, dogs, masks, caps = stage_inputs
    got = compact.compact_masks_multi(masks, caps)
    want = compact.compact_masks_multi_ref(masks, caps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    s, r, c, valid = decode_compacted(dogs, masks, caps, got[0], got[1], CFG.border_dist)
    args = (dogs, s, r, c, valid, caps, CFG.border_dist, CFG.peak_thresh, CFG.max_interp_moves)
    for g, w in zip(refine.refine_multi(*args), refine.refine_multi_ref(*args)):
        assert torch.equal(g, w)


def test_grad_and_window_kernels_match_plain(stage_inputs):
    """Gradient atlas exact; orientations within 1e-4 and u8 descriptors
    within 1 count (bins are summed in different orders)."""
    from sift_pyocl_tpu_torch.ops.orient_desc import _desc_window_size, quantize_descriptors

    _, octaves, dogs, masks, caps = stage_inputs
    blurs = [b for b, _ in octaves]
    got = gradpad.grad_atlas(blurs, CFG.scales)
    want = gradpad.grad_atlas_ref(blurs, CFG.scales)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    mag, ori, row_starts = got
    idx, wr, _ = compact.compact_masks_multi(masks, caps)
    s, r, c, valid = decode_compacted(dogs, masks, caps, idx, wr, CFG.border_dist)
    fs, fr, fc, _, acc = refine.refine_multi(dogs, s, r, c, valid, caps, CFG.border_dist,
                                             CFG.peak_thresh, CFG.max_interp_moves)
    args = (mag, ori, s, fr, fc, CFG.init_sigma * 2.0 ** (fs / CFG.scales), (acc > 0) & valid,
            _desc_window_size(CFG), CFG.max_ori,
            *window.slot_octave_geometry(caps, row_starts, blurs))
    ak, okk, rk = window.orient_desc_fused(*args)
    ap, okp, rp = window.orient_desc_fused_ref(*args)
    assert torch.equal(okk, okp) and int(okk.sum()) > 10
    assert float((ak[okk] - ap[okp]).abs().max()) <= 1e-4
    dq = (quantize_descriptors(rk[okk]).int() - quantize_descriptors(rp[okp]).int()).abs()
    assert int(dq.max()) <= 1 and float(dq.float().mean()) < 0.01


def test_slice_kernel_path_matches_plain_path(stage_inputs):
    img = stage_inputs[0]
    reset_launch_counts()
    buf = detect_and_describe(img, CFG)
    assert all(n == 1 for n in launch_counts().values()), launch_counts()

    got = to_keypoint_records(buf)
    want = to_keypoint_records(detect_and_describe(img, CFG, plain=True))
    assert len(got) == len(want) > 10
    hits, l1 = match_keypoint_sets(want, got)
    assert hits == len(want) and l1 < 0.01
