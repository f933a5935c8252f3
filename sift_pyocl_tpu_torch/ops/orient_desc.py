"""Gradients, window sizes and descriptor quantization in plain PyTorch.

Port of the plain parts of ``sift_pyocl_tpu/ops/orient_desc.py`` that the
multi-launch keypoint path uses; the per-keypoint histograms themselves are
the K6 kernel (``ops/kernels/window.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import SiftConfig
from ..oracle import DESC_GRID, MAG_FACTOR


def gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient mag/ori with clamped edges
    (oracle.gradient) of an (..., H, W) stack of planes."""
    p = torch.cat([img[..., :1, :], img, img[..., -1:, :]], dim=-2)
    p = torch.cat([p[..., :1], p, p[..., -1:]], dim=-1)
    dx = p[..., 1:-1, 2:] - p[..., 1:-1, :-2]
    dy = p[..., 2:, 1:-1] - p[..., :-2, 1:-1]
    mag = 0.5 * torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx)
    return mag, ori


def gradient_planes(blurs: torch.Tensor, cfg: SiftConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient mag/ori of the scale planes s = 1..scales of one octave's
    blur stack; returns (scales, H, W) stacks (plane index = s_int - 1)."""
    return gradient(blurs[1 : cfg.scales + 1])


def _ori_window_size(cfg: SiftConfig) -> int:
    """Static orientation window: covers radius floor(4.5*sigma_max)."""
    sigma_max = cfg.init_sigma * 2.0 ** ((cfg.scales + 1.5) / cfg.scales)
    need = 2 * int(4.5 * sigma_max) + 3
    return max(cfg.ori_window, (need + 7) // 8 * 8)


def _desc_window_size(cfg: SiftConfig) -> int:
    """Static descriptor window: covers radius ~ 10.61*sigma_max."""
    sigma_max = cfg.init_sigma * 2.0 ** ((cfg.scales + 1.5) / cfg.scales)
    return _desc_window_for_sigma(cfg, sigma_max)


def _desc_window_for_sigma(cfg: SiftConfig, sigma: float) -> int:
    """Window size covering the descriptor radius of keypoints whose
    octave-local sigma is <= `sigma`."""
    rad = math.sqrt(2.0) * MAG_FACTOR * sigma * (DESC_GRID + 1) / 2.0
    need = 2 * int(rad + 0.5) + 3
    return max(cfg.desc_window, (need + 7) // 8 * 8)


def quantize_descriptors(raw: torch.Tensor) -> torch.Tensor:
    """(N, 128) raw histograms -> uint8: normalize, clip 0.2, renormalize,
    then min(512 v, 255) truncated to u8."""
    n = torch.sqrt(torch.sum(raw * raw, dim=-1, keepdim=True))
    v = torch.where(n > 0, raw / torch.where(n > 0, n, torch.ones_like(n)), raw)
    v = torch.clamp(v, max=0.2)
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    v = torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)), v)
    return torch.clamp(512.0 * v, max=255.0).to(torch.uint8)
