"""Gradients, window sizes, descriptor quantization and the per-octave
orientation + descriptor call.

Port of the parts of ``sift_pyocl_tpu/ops/orient_desc.py`` that the kernel
keypoint paths use; the per-keypoint histograms themselves are the K6
kernel (``ops/kernels/window.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import SiftConfig
from ..oracle import DESC_GRID, MAG_FACTOR


class OrientedKeypoints(NamedTuple):
    """Keypoints with assigned orientations, one slot per (keypoint,
    orientation), octave-local coordinates."""

    s_int: torch.Tensor   # (n,) int32 integer scale index (gradient plane)
    fs: torch.Tensor      # (n,) f32
    fr: torch.Tensor      # (n,) f32
    fc: torch.Tensor      # (n,) f32
    angle: torch.Tensor   # (n,) f32 in (-pi, pi]
    valid: torch.Tensor   # (n,) bool
    count: torch.Tensor   # () int32 number of oriented keypoints


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


def orient_and_describe_fused(mag: torch.Tensor, ori: torch.Tensor, kps, cfg: SiftConfig,
                              max_ori: int = 2, plain: bool = False
                              ) -> Tuple[OrientedKeypoints, torch.Tensor]:
    """One octave's orientations and descriptors in one K6 launch (its plain
    version with ``plain=True``), the counterpart of the JAX package's
    ``orient_and_describe_fused_pallas``.  `mag` / `ori` are the octave's
    (scales, H, W) gradient planes, a one-octave atlas; `kps` are its
    RefinedKeypoints.  Slots are keypoint-major (slot i*max_ori + o).
    Returns (OrientedKeypoints over cap*max_ori slots, u8 descriptors)."""
    # imported here: the kernel modules import this one
    from .kernels.window import orient_desc_fused, orient_desc_fused_ref, slot_octave_geometry

    cap = kps.fr.shape[0]
    sigma = cfg.init_sigma * 2.0 ** (kps.fs / cfg.scales)
    fused = orient_desc_fused_ref if plain else orient_desc_fused
    ang, ok, raw = fused(mag, ori, kps.s_int, kps.fr, kps.fc, sigma, kps.valid,
                         _desc_window_size(cfg), max_ori,
                         *slot_octave_geometry([cap], [0], [mag]))

    def rep(x):
        return torch.repeat_interleave(x, max_ori, dim=0)

    okps = OrientedKeypoints(s_int=rep(kps.s_int), fs=rep(kps.fs), fr=rep(kps.fr),
                             fc=rep(kps.fc), angle=ang.reshape(-1), valid=ok.reshape(-1),
                             count=ok.sum().to(torch.int32))
    return okps, quantize_descriptors(raw.reshape(cap * max_ori, 128))
