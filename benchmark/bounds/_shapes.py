"""Shapes the bound files count from: every octave's (H, W) and the
Gaussian tap counts of a frame's blur ladder (frozen copies of the port's
arithmetic: ``SiftConfig.n_octaves``, ``sigma_increments``,
``oracle.gaussian_kernel``'s support)."""

import math


def octave_dims(shape, cfg):
    h, w = shape
    if cfg.double_im_size:
        h, w = 2 * h, 2 * w
    dims = []
    for _ in range(cfg.n_octaves(tuple(shape))):
        dims.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return dims


def taps(sigma: float) -> int:
    size = int(math.ceil(8.0 * sigma + 1.0))
    return size + 1 if size % 2 == 0 else size


def pre_sigma(cfg) -> float:
    cur = cfg.orig_sigma * (2.0 if cfg.double_im_size else 1.0)
    return math.sqrt(cfg.init_sigma ** 2 - cur ** 2)


def increments(cfg):
    lad = [cfg.init_sigma * 2.0 ** (s / cfg.scales) for s in range(cfg.scales + 3)]
    return [math.sqrt(lad[s] ** 2 - lad[s - 1] ** 2) for s in range(1, len(lad))]
