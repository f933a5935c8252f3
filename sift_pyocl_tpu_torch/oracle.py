"""Numerics constants of the SIFT frontend.

The subset of ``sift_pyocl_tpu/oracle.py`` this package needs, carried as a
copy because that module's package imports jax.  ``tests/test_torch_config.py``
holds every value here equal to the original.
"""

from __future__ import annotations

import math

import numpy as np

# Structured keypoint record (reference: sift-src/__init__.py keypoint dtype).
KP_DTYPE = np.dtype(
    [("x", "f4"), ("y", "f4"), ("scale", "f4"), ("angle", "f4"), ("desc", "u1", (128,))]
)

N_ORI_BINS = 36        # orientation histogram bins
DESC_GRID = 4          # 4x4 spatial descriptor bins
DESC_ORI = 8           # 8 descriptor orientation bins
MAG_FACTOR = 3.0       # descriptor sample spacing = 3*sigma


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps; support = 8*sigma+1 rounded up to odd."""
    size = int(math.ceil(8.0 * sigma + 1.0))
    if size % 2 == 0:
        size += 1
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)
