"""Configuration of the PyTorch + CUDA SIFT frontend.

A copy of the JAX package's ``SiftConfig`` (``sift_pyocl_tpu/config.py``):
same fields, same defaults, so a config crosses between the two packages
through ``from_jax_config``.  The port cannot import the JAX package (its
``__init__`` imports jax, and the GPU machine has none), so the dataclass is
carried here and ``tests/test_torch_config.py`` holds it equal to the
original.

Backend names keep the JAX package's spelling:

* ``"pallas"`` means the hand-written CUDA kernel of that stage
  (``sift_pyocl_tpu_torch/csrc/``);
* ``"xla"`` means the plain PyTorch version of that stage;
* ``"auto"`` resolves per stage (see ``models.sift`` and ``ops.pyramid``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """Static SIFT pipeline parameters (reference: sift-src/param.py::par).

    ``conv_backend`` / ``kp_backend`` / ``grad_backend`` / ``mask_backend``:
    ``"pallas"`` selects the hand-written CUDA kernel, ``"xla"`` the plain
    PyTorch version.  ``pallas_interpret`` is carried for parity with the
    JAX config and has no effect here.
    """

    double_im_size: bool = False
    init_sigma: float = 1.6
    border_dist: int = 5
    scales: int = 3
    peak_thresh: float = 255.0 * 0.04 / 3.0
    edge_thresh: float = 0.06
    edge_thresh1: float = 0.08
    match_ratio: float = 0.73
    orig_sigma: float = 0.5

    pix_per_kp: int = 10
    downsample_mode: str = "shrink"

    kp_per_octave_cap: int = 2048
    ori_window: int = 40
    desc_window: int = 80
    max_interp_moves: int = 5
    max_ori: int = 2
    min_octave_size: int = 2 * 5 + 3
    conv_backend: str = "auto"
    kp_backend: str = "auto"
    pallas_interpret: bool = False
    kp_multi_launch: bool = True
    grad_backend: str = "pallas"
    desc_buckets: int = 1
    mask_backend: str = "xla"

    @property
    def n_scale_imgs(self) -> int:
        """Blur images per octave: s = 0 .. scales+2."""
        return self.scales + 3

    @property
    def n_dogs(self) -> int:
        """DoG images per octave."""
        return self.scales + 2

    def sigma_ladder(self) -> Tuple[float, ...]:
        """Absolute blur of each scale image in octave coordinates."""
        return tuple(
            self.init_sigma * (2.0 ** (s / self.scales))
            for s in range(self.n_scale_imgs)
        )

    def sigma_increments(self) -> Tuple[float, ...]:
        """Incremental blur applied between scale s-1 and s (len = scales+2)."""
        lad = self.sigma_ladder()
        return tuple(
            math.sqrt(lad[s] ** 2 - lad[s - 1] ** 2)
            for s in range(1, self.n_scale_imgs)
        )

    def n_octaves(self, shape: Tuple[int, int]) -> int:
        """Octave count: keep an octave while its min dim > min_octave_size."""
        h, w = shape
        if self.double_im_size:
            h, w = 2 * h, 2 * w
        n = 0
        while min(h, w) > self.min_octave_size:
            n += 1
            h, w = h // 2, w // 2
        return max(n, 1)

    def kp_capacity(self, shape: Tuple[int, int]) -> int:
        """Total keypoint capacity for an image (reference: npix // PIX_PER_KP)."""
        h, w = shape
        if self.double_im_size:
            h, w = 2 * h, 2 * w
        return max(h * w // self.pix_per_kp, self.kp_per_octave_cap)


# The configuration this package runs end to end on the card: plain PyTorch
# pyramid and extrema mask, the keypoint stage on the four CUDA kernels
# (compaction, refinement, gradient atlas, orientation + descriptor).
SLICE_CONFIG = SiftConfig(conv_backend="xla", kp_backend="pallas",
                          kp_multi_launch=True, grad_backend="pallas",
                          mask_backend="xla")


def from_jax_config(cfg) -> SiftConfig:
    """The port's SiftConfig from a ``sift_pyocl_tpu.SiftConfig`` (or any
    dataclass with the same fields).  SIFT has no weights; the config is the
    whole state that crosses between the packages."""
    return SiftConfig(**dataclasses.asdict(cfg))


# Legacy-style view for API parity with `from sift import par` (a copy of
# the JAX package's ``par`` and ``config_from_par``).
DEFAULT_CONFIG = SiftConfig()

par = {
    "DoubleImSize": DEFAULT_CONFIG.double_im_size,
    "InitSigma": DEFAULT_CONFIG.init_sigma,
    "BorderDist": DEFAULT_CONFIG.border_dist,
    "Scales": DEFAULT_CONFIG.scales,
    "PeakThresh": DEFAULT_CONFIG.peak_thresh,
    "EdgeThresh": DEFAULT_CONFIG.edge_thresh,
    "EdgeThresh1": DEFAULT_CONFIG.edge_thresh1,
    "MatchRatio": DEFAULT_CONFIG.match_ratio,
    "OrigSigma": DEFAULT_CONFIG.orig_sigma,
}

_PAR_FIELDS = {
    "DoubleImSize": "double_im_size",
    "InitSigma": "init_sigma",
    "BorderDist": "border_dist",
    "Scales": "scales",
    "PeakThresh": "peak_thresh",
    "EdgeThresh": "edge_thresh",
    "EdgeThresh1": "edge_thresh1",
    "MatchRatio": "match_ratio",
    "OrigSigma": "orig_sigma",
}


def config_from_par(p=None, **overrides) -> SiftConfig:
    """Build a SiftConfig from a reference-style `par` dict (API bridge)."""
    p = dict(par if p is None else p)
    kwargs = {_PAR_FIELDS[k]: v for k, v in p.items() if k in _PAR_FIELDS}
    kwargs["double_im_size"] = bool(kwargs.get("double_im_size", False))
    kwargs.update(overrides)
    return SiftConfig(**kwargs)
