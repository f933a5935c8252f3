"""K3 compact_masks_multi (csrc/compact.cu): every octave's extrema mask
read once (one byte a pixel of the border-stripped scales x H x W), the
slot indices written once (chip_smoke.py::check_keypoint_kernels)."""

from benchmark.bounds import _shapes
from benchmark.harness.peaks import F32_OPS


def calls(f):
    cfg = f["cfg"]
    bd = cfg.border_dist
    mask = sum(cfg.scales * max(h - 2 * bd, 0) * max(w - 2 * bd, 0)
               for h, w in _shapes.octave_dims(f["shape"], cfg))
    return [(mask + 4 * sum(f["caps"]), 0, F32_OPS)]
