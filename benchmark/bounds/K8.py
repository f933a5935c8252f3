"""K8 extrema_masks (csrc/maskk.cu): every octave's DoG stack read once,
its border-stripped mask (one byte a pixel) written once."""

from benchmark.bounds import _shapes
from benchmark.harness.peaks import F32_OPS


def calls(f):
    cfg = f["cfg"]
    bd = cfg.border_dist
    dims = _shapes.octave_dims(f["shape"], cfg)
    dogs = sum(4 * (cfg.scales + 2) * h * w for h, w in dims)
    mask = sum(cfg.scales * max(h - 2 * bd, 0) * max(w - 2 * bd, 0) for h, w in dims)
    return [(dogs + mask, 0, F32_OPS)]
