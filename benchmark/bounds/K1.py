"""K1 octave0_ladder (csrc/ladder.cu): octave 0's blur ladder and DoGs.
Least work (chip_smoke.py::check_ladders): the input read once, the
scales + 3 blur levels and scales + 2 DoGs written once; two passes of
every tap a level, f32."""

from benchmark.bounds import _shapes
from benchmark.harness.peaks import F32_OPS


def calls(f):
    cfg = f["cfg"]
    h, w = _shapes.octave_dims(f["shape"], cfg)[0]
    incs = _shapes.increments(cfg)
    k_sum = sum(_shapes.taps(s) for s in [_shapes.pre_sigma(cfg)] + incs)
    n_lv = len(incs)
    return [(4 * h * w * (1 + (n_lv + 1) + n_lv), 2 * 2 * k_sum * h * w, F32_OPS)]
