"""K4 refine_multi (csrc/refine.cu): K3's idx and written read once, 21
output bytes a slot written once, 19 DoG samples and ~120 operations a
valid candidate (chip_smoke.py::check_keypoint_kernels).  The run reports
no candidate count, so the keypoints it kept stand in for it (fewer, so
the bound is never overstated)."""

from benchmark.harness.peaks import F32_OPS


def calls(f):
    n_valid = len(f["kp_octave"])
    n_slots = sum(f["caps"])
    return [(n_slots * (4 + 21) + 4 * len(f["caps"]) + n_valid * 19 * 4, n_valid * 120, F32_OPS)]
