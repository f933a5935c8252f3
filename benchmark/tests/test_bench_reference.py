"""The plain reference against the port's plain path at a small size on
the CPU, where both run the same arithmetic."""

import numpy as np
import pytest
import torch

from benchmark.harness import compare, scenes
from benchmark.reference import sift as rsift, vo as rvo

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frames():
    return scenes.scenes(3, (96, 160), 40, 2 ** 35 + 1, CPU)


def _port_cfg():
    from sift_pyocl_tpu_torch import SiftConfig
    return SiftConfig(kp_per_octave_cap=128)


@pytest.mark.parametrize("i", [0, 1])
def test_reference_frontend_matches_the_port_plain_path(frames, i):
    from sift_pyocl_tpu_torch import detect_and_describe

    cfg = _port_cfg()
    port = detect_and_describe(frames[i], cfg, plain=True)
    ref = rsift.detect_and_describe(frames[i], rsift.Params(kp_per_octave_cap=128))
    assert ref.x.shape == port.x.shape and ref.desc.shape == port.desc.shape
    assert int(ref.valid.sum()) >= 5
    gaps = compare.keypoint_gaps(port._asdict(), ref._asdict())
    assert gaps["missing"] == 0.0 and gaps["extra"] == 0.0
    assert gaps["desc_l1"] <= 0.05
    assert torch.equal(ref.counts, port.counts)


def test_reference_step_matches_the_port_eager_step(frames):
    from sift_pyocl_tpu_torch import VOConfig, vo_init
    from sift_pyocl_tpu_torch.models.vo import _vo_step_eager

    cfg = _port_cfg()
    vo = VOConfig(window=4, pts_per_frame=64, obs_per_frame=128, pnp_n=128)
    K = torch.tensor([[120.0, 0, 80.0], [0, 120.0, 48.0], [0, 0, 1]])
    base = scenes.scenes(1, (96, 180), 40, 9, CPU)[0]
    f = [base[:, 2 * k:2 * k + 160].contiguous() for k in range(4)]
    state = vo_init(f[0], K, cfg, vo, device="cpu")
    state, _ = _vo_step_eager(state, f[1], K, cfg, vo)
    new, out = _vo_step_eager(state, f[2], K, cfg, vo)
    rnew, rout, _ = rvo.vo_step(state._asdict(), f[2], K, rsift.Params(kp_per_octave_cap=128),
                                rvo.VOParams(**vo._asdict()))
    pose = compare.pose_gaps(new.Rs, new.ts, rnew["Rs"], rnew["ts"])
    assert pose["rot_deg"] <= 1e-4 and pose["centre"] <= 1e-5
    assert int(out.n_matches) == int(rout["n_matches"])
    assert bool(out.tracked) == bool(rout["tracked"])
    for k in ("Xvalid", "obs_pt", "key_frame", "frame"):
        assert torch.equal(getattr(new, k), rnew[k]), k
    # the points of valid slots (an invalid slot's fields are the port's own)
    v = new.Xvalid > 0
    assert int(v.sum()) >= 10
    np.testing.assert_allclose(new.X[v].numpy(), rnew["X"][v].numpy(), rtol=1e-4, atol=1e-4)


def test_reference_back_end_on_given_keypoints(frames):
    """Handed its own frontend's buffer, the step is the same step; its
    window is its BA's input or its proposed step, as the iteration chose."""
    K = torch.tensor([[120.0, 0, 80.0], [0, 120.0, 48.0], [0, 0, 1]])
    p, vp = rsift.Params(kp_per_octave_cap=128), rvo.VOParams(window=4, pts_per_frame=64,
                                                              obs_per_frame=128, pnp_n=128)
    base = scenes.scenes(1, (96, 180), 40, 9, CPU)[0]
    f = [base[:, 2 * k:2 * k + 160].contiguous() for k in range(4)]
    from sift_pyocl_tpu_torch import SiftConfig, VOConfig, vo_init

    state = vo_init(f[0], K, SiftConfig(kp_per_octave_cap=128),
                    VOConfig(**vp._asdict()), device="cpu")._asdict()
    for k in (1, 2):
        state, out, buf = rvo.vo_step(state, f[k], K, p, vp)
    new, out2, _ = rvo.vo_step(state, f[3], K, p, vp)
    same, out3, _ = rvo.vo_step(state, f[3], K, p, vp,
                                keypoints=rsift.detect_and_describe(f[3], p))
    for k in rvo.STATE_FIELDS:
        assert torch.equal(new[k], same[k]), k
    P = new["X"].shape[0] * new["X"].shape[1]
    window = (new["Rs"], new["ts"], new["X"].reshape(P, 3))
    chosen = out2["ba_proposal"] if float(new["lam"]) < float(state["lam"]) else out2["ba_input"]
    assert all(torch.equal(a, b) for a, b in zip(window, chosen))
