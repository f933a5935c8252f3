"""The invariance battery through the port on the CPU (``slow``, as the
reference suite's ``tests/test_invariance.py``): the carried protocol
(``sift_pyocl_tpu_torch/utils/invariance.py``: two scenes, nine cases, the
suite's frozen floors, the ``double_im_size`` zoom fence and the
angle-rotation fence) with ``SiftPlan``, ``MatchPlan`` and the warp of this
package on ``device="cpu"``.  ``chip_smoke.py`` runs the same battery on
the card."""

import numpy as np
import pytest

from sift_pyocl_tpu_torch import MatchPlan, SiftConfig, SiftPlan
from sift_pyocl_tpu_torch.utils import invariance as inv

DEV = "cpu"


@pytest.fixture(scope="module")
def plan():
    return SiftPlan(inv.SHAPE, "float32", device=DEV)


@pytest.fixture(scope="module", params=["blobs", "texture"])
def scene_and_kp(request, plan):
    img = inv.scenes()[request.param]
    kp0 = plan.keypoints(img)
    assert len(kp0) >= 50, f"{request.param}: calibration scene must be feature-rich"
    return request.param, img, kp0


@pytest.mark.slow
@pytest.mark.parametrize("case", inv.CASES, ids=[c[0] for c in inv.CASES])
def test_invariance(scene_and_kp, plan, case):
    scene, img, kp0 = scene_and_kp
    res = inv.run_case(plan, MatchPlan(device=DEV), img, kp0, case, DEV)
    print(f"[invariance] {scene}/{case[0]}: repeatability {res['rep']:.3f} "
          f"({res['hits']}/{res['eligible']}), matches {res['matches']}, "
          f"precision {res['prec']:.3f}")
    assert not inv.floor_failures(scene, case[0], res)


@pytest.mark.slow
def test_zoom_out_double_im_size_recovers(plan):
    plan_d = SiftPlan(inv.SHAPE, "float32", config=SiftConfig(double_im_size=True), device=DEV)
    rep, n_match = inv.zoom_fence(plan, plan_d, MatchPlan(device=DEV), DEV)
    print(f"[invariance] double_im_size zoom_out: repeatability {rep:.3f}, matches {n_match}")
    assert rep >= inv.ZOOM_FENCE[0], rep
    assert n_match >= inv.ZOOM_FENCE[1], n_match


@pytest.mark.slow
def test_rotation_rotates_keypoint_angles(scene_and_kp, plan):
    scene, img, kp0 = scene_and_kp
    frac, n_match = inv.angle_fence(plan, MatchPlan(device=DEV), img, kp0, DEV)
    print(f"[invariance] {scene} angle consistency: {frac:.3f} of {n_match}")
    assert n_match >= 10
    assert frac >= inv.ANGLE_FENCE, f"only {frac:.2f} of matches rotate their angle"
