"""Gaussian scale-space pyramid.

Port of ``sift_pyocl_tpu/ops/pyramid.py``: separable Gaussian blurs with
clamp-to-edge borders, the blur ladder of each octave, DoGs, and ceil-sized
octave downsampling.  ``conv_backend="pallas"`` or ``"auto"`` runs octave 0
through the ladder kernel K1 and every octave >= 1 through one call of K2
(``ops/kernels/ladder.py``; on a CPU tensor their plain versions);
``"xla"`` is the plain PyTorch path on any device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SiftConfig
from ..oracle import gaussian_kernel

FUSED_MASK_TODO = ("mask_backend='fused' needs the in-ladder extrema mask of K1/K2 "
                   "(ROADMAP.md, Queue 2: the mask_cfg variants), which is not "
                   "ported yet; use mask_backend='xla' or 'pallas'")

Ladder = Tuple[torch.Tensor, torch.Tensor]


def resolve_conv_backend(cfg: SiftConfig) -> str:
    """The pyramid path for `cfg`: "pallas" (the ladder kernels K1/K2, their
    plain versions on a CPU tensor) for "pallas" and "auto", "xla" (plain
    PyTorch on any device) for "xla"."""
    if cfg.conv_backend not in ("xla", "auto", "pallas"):
        raise ValueError(f"unknown conv_backend {cfg.conv_backend!r}")
    backend = "xla" if cfg.conv_backend == "xla" else "pallas"
    if backend == "pallas" and cfg.mask_backend == "fused":
        raise NotImplementedError(FUSED_MASK_TODO)
    return backend


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """f32 grayscale normalized to [0, 255] (oracle.normalize_image)."""
    if img.ndim == 3:
        lum = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                           device=img.device)
        img = img[..., :3].to(torch.float32) @ lum
    img = img.to(torch.float32)
    lo = img.min()
    hi = img.max()
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    return (img - lo) * scale


@lru_cache(maxsize=64)
def _taps(sigma: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(gaussian_kernel(sigma), device=device)


def conv1d_clamp(img: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D correlation of an (H, W) plane along `axis`, clamp-to-edge borders."""
    half = (taps.numel() - 1) // 2
    x = img[None, None]
    if axis == 1:
        x = F.pad(x, (half, half, 0, 0), mode="replicate")
        k = taps.view(1, 1, 1, -1)
    else:
        x = F.pad(x, (0, 0, half, half), mode="replicate")
        k = taps.view(1, 1, -1, 1)
    return F.conv2d(x, k)[0, 0]


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with clamped borders (oracle.blur)."""
    taps = _taps(float(sigma), img.device)
    return conv1d_clamp(conv1d_clamp(img, taps, axis=1), taps, axis=0)


def upscale2(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upscale (oracle.upscale2): even rows/cols copy the input,
    odd ones average it with its clamped next neighbour."""

    def up(x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim]
        nxt = torch.clamp(torch.arange(n, device=x.device) + 1, max=n - 1)
        mid = 0.5 * x + 0.5 * x.index_select(dim, nxt)
        return torch.stack([x, mid], dim=dim + 1).flatten(dim, dim + 1)

    return up(up(img, 0), 1)


def build_octave(base: torch.Tensor,
                 increments: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One octave's blur stack (len(increments)+1, H, W), level l+1 being
    level l blurred by ``increments[l]``, and its DoG stack."""
    blurs = [base]
    for inc in increments:
        blurs.append(blur(blurs[-1], inc))
    stack = torch.stack(blurs)
    return stack, stack[1:] - stack[:-1]


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Every other pixel, ceil-sized ((h+1)//2 rows) for odd dimensions."""
    return img[::2, ::2].contiguous()


def downsample2_bin(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean (oracle.bin2), ceil-sized: on an odd edge the last row/col
    is its own pair, which 0.5*x + 0.5*x reproduces exactly."""

    def pair(x: torch.Tensor, dim: int) -> torch.Tensor:
        if x.shape[dim] % 2:
            x = torch.cat([x, x.narrow(dim, x.shape[dim] - 1, 1)], dim=dim)
        x = x.movedim(dim, 0)
        return (0.5 * x[0::2] + 0.5 * x[1::2]).movedim(0, dim)

    return pair(pair(img, 0), 1).contiguous()


def downsample_octave(img: torch.Tensor, mode: str) -> torch.Tensor:
    """Octave downsample (``downsample_mode``: "shrink" | "bin")."""
    return downsample2_bin(img) if mode == "bin" else downsample2(img)


def octave0_ladder_ref(img: torch.Tensor, pre_sigma: Optional[float],
                       increments: Sequence[float]) -> Ladder:
    """Plain version of K1 (``ops.kernels.ladder.octave0_ladder``): octave
    0 from the normalized image, pre-blurred by `pre_sigma` unless None."""
    return build_octave(img if pre_sigma is None else blur(img, pre_sigma), increments)


def small_octaves_ladder_ref(base1: torch.Tensor, increments: Sequence[float], n_oct: int,
                             scales: int, ds_mode: str = "shrink") -> List[Ladder]:
    """Plain version of K2 (``ops.kernels.ladder.small_octaves_ladder``):
    `n_oct` octaves from the first small octave's base, each next base being
    level `scales` downsampled."""
    out, base = [], base1
    for _ in range(n_oct):
        out.append(build_octave(base, increments))
        base = downsample_octave(out[-1][0][scales], ds_mode)
    return out


def build_scale_space(img: torch.Tensor, cfg: SiftConfig,
                      plain: bool = False) -> List[Ladder]:
    """All octaves as a list of (blurs (S+3, H, W), dogs (S+2, H, W)):
    octave 0 through K1, the others through one call of K2, or their plain
    versions for ``conv_backend="xla"`` or ``plain=True``."""
    n_oct = cfg.n_octaves(tuple(img.shape[:2]))
    if resolve_conv_backend(cfg) == "xla" or plain:
        k1, k2 = octave0_ladder_ref, small_octaves_ladder_ref
    else:
        # imported here, as the JAX package imports its Pallas ladders: the
        # kernel module takes its plain versions from this one
        from .kernels.ladder import octave0_ladder as k1, small_octaves_ladder as k2
    data = normalize_image(img)
    cur_sigma = cfg.orig_sigma
    if cfg.double_im_size:
        data = upscale2(data)
        cur_sigma *= 2.0
    pre = (float(np.sqrt(cfg.init_sigma**2 - cur_sigma**2))
           if cfg.init_sigma > cur_sigma else None)
    incs = cfg.sigma_increments()
    octaves = [k1(data, pre, incs)]
    if n_oct > 1:
        octaves += k2(downsample_octave(octaves[0][0][cfg.scales], cfg.downsample_mode),
                      incs, n_oct - 1, cfg.scales, cfg.downsample_mode)
    return octaves
