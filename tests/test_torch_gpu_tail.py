"""The port's tail on a CUDA card (skipped without one): the native
FrameSource feeding SiftPlan.keypoints, and the evaluate CLI's sfm mode on
tests/test_evaluate_cli.py's 7-frame sequence.

Run on the GPU machine, which has no JAX (so without the suite's
conftest.py, which imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_tail.py -q
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig, SiftPlan
from sift_pyocl_tpu_torch.evaluate import main, save_sequence
from sift_pyocl_tpu_torch.utils.framesource import FrameSource
from sift_pyocl_tpu_torch.utils.profiling import kernel_launches
from sift_pyocl_tpu_torch.utils.render3d import render_sequence

pytestmark = pytest.mark.gpu
# CUDA launches a detection of K1 (six level launches) and K2-K6
FRONTEND_LAUNCHES = {"blur_level_kernel": 6, "small_octaves_kernel": 1, "compact_kernel": 1,
                     "refine_kernel": 1, "grad_kernel": 1, "orient_desc_kernel": 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def seq7(tmp_path_factory):
    K, frames, gtR, gtT = render_sequence(n_frames=7, n_points=70, image_size=(320, 240),
                                          seed=0, arc_deg=25.0)
    seq_dir, gt = save_sequence(tmp_path_factory.mktemp("seq7") / "seq", frames, gtR, gtT)
    return K, frames, seq_dir, gt


def test_native_frame_source_feeds_siftplan_on_the_card(cuda, seq7):
    """PGM frames read by the native loader go through SiftPlan.keypoints
    on the card (K1-K6 once a frame, read from the device's trace: the
    plan replays its detector graph); the keypoints equal those of the
    NumPy decode's frames on the card, bit for bit."""
    K, frames, seq_dir, _ = seq7
    paths = sorted(seq_dir.glob("*.pgm"))
    fs = FrameSource(paths, frames[0].shape)
    assert fs.backend == "native"
    plan = SiftPlan(frames[0].shape, config=SiftConfig(kp_per_octave_cap=256), device=cuda)
    ref = [f for _, f in FrameSource(paths, frames[0].shape, native=False)]
    loaded = [f for _, f in fs]
    kps = [plan.keypoints(f) for f in loaded]
    counts = kernel_launches(lambda: [plan.keypoints(f) for f in loaded], FRONTEND_LAUNCHES)
    assert counts == {k: n * len(paths) for k, n in FRONTEND_LAUNCHES.items()}, counts
    for kp, f in zip(kps, ref):
        assert len(kp) > 30
        np.testing.assert_array_equal(kp, plan.keypoints(f))


def test_evaluate_cli_sfm_on_the_card(cuda, seq7):
    """tests/test_evaluate_cli.py::test_evaluate_cli_sfm_ate on the card:
    rc 0, its keys, >= 6 of 7 registered, ATE < 0.15."""
    K, _, seq_dir, gt = seq7
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--frames", str(seq_dir), "--gt", str(gt), "--mode", "sfm",
                   "--fx", str(float(K[0, 0])), "--device", str(cuda)])
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0, rep
    assert set(rep) == {"ate_rmse", "n_frames", "n_registered", "mode", "shape"}
    assert rep["n_registered"] >= 6
    assert rep["ate_rmse"] < 0.15, rep
