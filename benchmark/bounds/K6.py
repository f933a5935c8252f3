"""K6 orient_desc_fused (csrc/window.cu): per slot its 29 bytes of
keypoint fields read, the raw descriptors (max_ori x 128 f32) and the ok
flags and angles written; each valid keypoint's orientation circle
(radius floor(4.5 sigma)) read once, 8 bytes and ~10 operations a sample
(chip_smoke.py::check_keypoint_kernels counts the union of the circle
and the descriptor squares, and 20 operations a square sample: both are
left out here, so the bound is never overstated).  Where the run reports
no keypoint scale, the least octave-local sigma stands in."""

import math

from benchmark.harness.peaks import F32_OPS


def calls(f):
    cfg = f["cfg"]
    n_slots = sum(f["caps"])
    mo = cfg.max_ori
    sig = f["kp_sigma"]
    if sig is None:
        sig = [cfg.init_sigma * 2.0 ** (0.5 / cfg.scales)] * len(f["kp_octave"])
    circle = sum(math.pi * math.floor(4.5 * s) ** 2 for s in sig)
    return [(n_slots * 29 + circle * 8 + n_slots * mo * 128 * 4 + 5 * n_slots * mo,
             circle * 10, F32_OPS)]
