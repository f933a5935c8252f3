"""K2 small_octaves_ladder (csrc/ladder.cu): octaves 1 and up in one
launch.  Least work (chip_smoke.py::check_ladders): octave 1's base read
once, every small octave's levels and DoGs written once."""

from benchmark.bounds import _shapes
from benchmark.harness.peaks import F32_OPS


def calls(f):
    cfg = f["cfg"]
    dims = _shapes.octave_dims(f["shape"], cfg)
    if len(dims) < 2:
        return []
    incs = _shapes.increments(cfg)
    n_lv = len(incs)
    k_inc = sum(_shapes.taps(s) for s in incs)
    px = sum(h * w for h, w in dims[1:])
    base = dims[1][0] * dims[1][1]
    return [(4 * (base + px * (2 * n_lv + 1)), 2 * 2 * k_inc * px, F32_OPS)]
