"""K5 grad_atlas (csrc/gradpad.cu): planes 1..scales of every octave read
once, the magnitude and orientation atlases (scales x the octaves' rows x
octave 0's width, f32) written once; ~30 operations a pixel
(chip_smoke.py::check_keypoint_kernels)."""

from benchmark.bounds import _shapes
from benchmark.harness.peaks import F32_OPS


def calls(f):
    cfg = f["cfg"]
    dims = _shapes.octave_dims(f["shape"], cfg)
    plane_px = sum(h * w for h, w in dims)
    atlas = cfg.scales * sum(h for h, _ in dims) * dims[0][1]
    return [(4 * cfg.scales * plane_px + 2 * atlas * 4, cfg.scales * plane_px * 30, F32_OPS)]
