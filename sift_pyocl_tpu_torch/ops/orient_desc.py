"""Gradients, window sizes, orientation assignment, descriptors and their
quantization.

Port of ``sift_pyocl_tpu/ops/orient_desc.py``.  The per-keypoint
histograms are the kernels of ``ops/kernels/window.py``: K6 for
``orient_and_describe_fused``, K11a for ``assign_orientations_pallas`` and
K11b for ``compute_descriptors_pallas``; the plain ``assign_orientations``
and ``compute_descriptors`` (the ``kp_backend="xla"`` path) run the same
histogram arithmetic as those kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import nonzero_first
from ..config import SiftConfig
from ..oracle import DESC_GRID, MAG_FACTOR

PAD_R, PAD_C = 80, 256  # pad_grad_planes' zero padding a side: rows, columns


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


def pad_grad_planes(mags: torch.Tensor, oris: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad (S, H, W) gradient planes by PAD_R rows and PAD_C columns a
    side: the planes ``assign_orientations_pallas`` and
    ``compute_descriptors_pallas`` take, as in the JAX package."""
    pad = (PAD_C, PAD_C, PAD_R, PAD_R)
    return F.pad(mags, pad), F.pad(oris, pad)


def smooth_orientation_hist(hist: torch.Tensor) -> torch.Tensor:
    """Six rounds of circular 3-tap box smoothing along the last axis."""
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    return hist


def _oriented_slots(kps, angle: torch.Tensor, ok: torch.Tensor, kp_idx: torch.Tensor,
                    count: torch.Tensor) -> OrientedKeypoints:
    """OrientedKeypoints of slots that take keypoint kp_idx[j]'s fields."""
    return OrientedKeypoints(s_int=kps.s_int[kp_idx], fs=kps.fs[kp_idx], fr=kps.fr[kp_idx],
                             fc=kps.fc[kp_idx], angle=angle, valid=ok, count=count)


def _peaks(hist: torch.Tensor, kps, max_ori: int):
    """(angles, ok) (cap, max_ori) of (cap, 36) raw histograms: smoothing,
    peaks >= 0.8 max, parabolic refinement, strongest first."""
    from .kernels.window import _orientation_tail   # the kernel modules import this one

    ang, ok = _orientation_tail(hist, max_ori)
    return ang, ok & kps.valid[:, None]


def orientation_peaks_from_hist(hist: torch.Tensor, kps, cfg: SiftConfig, dcap: int,
                                max_ori: int = 2) -> OrientedKeypoints:
    """Up to `max_ori` orientations per keypoint from (cap, 36) histograms,
    compacted to `dcap` slots in ``jnp.nonzero`` order over the (cap,
    max_ori) matrix (keypoint-major); ``count`` is the true number, which
    may exceed dcap."""
    ang, ok = _peaks(hist, kps, max_ori)
    sel, valid, count = nonzero_first(ok.reshape(-1), dcap)
    return _oriented_slots(kps, ang.reshape(-1)[sel], valid, sel // max_ori, count)


def orientation_peaks_dense(hist: torch.Tensor, kps, cfg: SiftConfig,
                            max_ori: int = 2) -> OrientedKeypoints:
    """As ``orientation_peaks_from_hist`` with no compaction: cap*max_ori
    dense slots, slot cap*o + i holding keypoint i's o-th orientation."""
    ang, ok = _peaks(hist, kps, max_ori)
    cap = hist.shape[0]
    kp_idx = torch.arange(cap, device=hist.device).repeat(max_ori)
    return _oriented_slots(kps, ang.T.reshape(-1), ok.T.reshape(-1), kp_idx,
                           ok.sum().to(torch.int32))


def _sigma(cfg: SiftConfig, fs: torch.Tensor) -> torch.Tensor:
    return cfg.init_sigma * 2.0 ** (fs / cfg.scales)


def assign_orientations_pallas(mag_p: torch.Tensor, ori_p: torch.Tensor, kps, cfg: SiftConfig,
                               dcap: int = 0, max_ori: int = 2) -> OrientedKeypoints:
    """Orientations of one octave's RefinedKeypoints through K11a, on the
    ``pad_grad_planes`` planes, over the ``_ori_window_size`` window.
    Returns dense slots (``orientation_peaks_dense``; `dcap` is ignored, as
    in the JAX package)."""
    from .kernels.window import orientation_hist

    hist = orientation_hist(mag_p, ori_p, kps.s_int, kps.fr, kps.fc, _sigma(cfg, kps.fs),
                            kps.valid, _ori_window_size(cfg))
    return orientation_peaks_dense(hist, kps, cfg, max_ori)


def compute_descriptors_pallas(mag_p: torch.Tensor, ori_p: torch.Tensor,
                               okps: OrientedKeypoints, cfg: SiftConfig) -> torch.Tensor:
    """u8 descriptors (n, 128) of oriented keypoints through K11b, on the
    ``pad_grad_planes`` planes, over the ``_desc_window_size`` window;
    zeros for invalid slots."""
    from .kernels.window import descriptor_hist

    raw = descriptor_hist(mag_p, ori_p, okps.s_int, okps.fr, okps.fc, _sigma(cfg, okps.fs),
                          okps.angle, okps.valid, _desc_window_size(cfg))
    return quantize_descriptors(raw)


def assign_orientations(mags: torch.Tensor, oris: torch.Tensor, kps, cfg: SiftConfig,
                        dcap: int, max_ori: int = 2) -> OrientedKeypoints:
    """Plain orientation assignment of the ``kp_backend="xla"`` path, on an
    octave's (scales, H, W) gradient planes: K11a's plain arithmetic on the
    unpadded planes, then ``orientation_peaks_from_hist`` (compaction to
    `dcap`)."""
    from .kernels.window import orientation_hist_planes

    hist = orientation_hist_planes(mags, oris, kps.s_int, kps.fr, kps.fc, _sigma(cfg, kps.fs),
                                   kps.valid, _ori_window_size(cfg))
    return orientation_peaks_from_hist(hist, kps, cfg, dcap, max_ori)


def compute_descriptors(mags: torch.Tensor, oris: torch.Tensor, okps: OrientedKeypoints,
                        cfg: SiftConfig) -> torch.Tensor:
    """Plain u8 descriptors of the ``kp_backend="xla"`` path: K11b's plain
    arithmetic on an octave's unpadded (scales, H, W) gradient planes,
    quantized."""
    from .kernels.window import descriptor_hist_planes

    raw = descriptor_hist_planes(mags, oris, okps.s_int, okps.fr, okps.fc, _sigma(cfg, okps.fs),
                                 okps.angle, okps.valid, _desc_window_size(cfg))
    return quantize_descriptors(raw)
