"""Gaussian scale-space pyramid in plain PyTorch.

Port of ``sift_pyocl_tpu/ops/pyramid.py`` on its ``conv_backend="xla"``
path: separable Gaussian blurs with clamp-to-edge borders, the blur ladder
of each octave, DoGs, and ceil-sized octave downsampling.  The fused ladder
kernels (``ladder0.octave0_ladder``, ``ladder.small_octaves_ladder``) are
not ported yet, so ``conv_backend="pallas"`` raises; ``"auto"`` resolves to
this plain path until they are.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SiftConfig
from ..oracle import gaussian_kernel

_LADDER_TODO = ("conv_backend='pallas' needs the ladder kernels K1/K2 "
                "(ROADMAP.md, Queue 2: octave0_ladder, small_octaves_ladder), "
                "which are not ported yet; use conv_backend='xla'")


def resolve_conv_backend(cfg: SiftConfig) -> str:
    """The pyramid path for `cfg`: "xla" (plain PyTorch) until K1/K2 exist."""
    if cfg.conv_backend == "pallas":
        raise NotImplementedError(_LADDER_TODO)
    if cfg.conv_backend not in ("xla", "auto"):
        raise ValueError(f"unknown conv_backend {cfg.conv_backend!r}")
    return "xla"


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


def prepare_input(img: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Normalize, optionally double, pre-blur to init_sigma (oracle.prepare_input)."""
    data = normalize_image(img)
    cur_sigma = cfg.orig_sigma
    if cfg.double_im_size:
        data = upscale2(data)
        cur_sigma *= 2.0
    if cfg.init_sigma > cur_sigma:
        data = blur(data, float(np.sqrt(cfg.init_sigma**2 - cur_sigma**2)))
    return data


def build_octave(base: torch.Tensor, cfg: SiftConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One octave: blur stack (S+3, H, W) and DoG stack (S+2, H, W)."""
    blurs = [base]
    for inc in cfg.sigma_increments():
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


def downsample_octave(img: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Octave downsample dispatch (cfg.downsample_mode: shrink | bin)."""
    return downsample2_bin(img) if cfg.downsample_mode == "bin" else downsample2(img)


def build_scale_space(img: torch.Tensor, cfg: SiftConfig) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """All octaves as a list of (blurs (S+3, H, W), dogs (S+2, H, W))."""
    resolve_conv_backend(cfg)
    n_oct = cfg.n_octaves(tuple(img.shape[:2]))
    blurs, dogs = build_octave(prepare_input(img, cfg), cfg)
    octaves = [(blurs, dogs)]
    for _ in range(1, n_oct):
        blurs, dogs = build_octave(downsample_octave(blurs[cfg.scales], cfg), cfg)
        octaves.append((blurs, dogs))
    return octaves
