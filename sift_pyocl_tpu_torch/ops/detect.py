"""DoG extrema detection: mask, compaction and subpixel refinement.

Port of ``sift_pyocl_tpu/ops/detect.py`` on its kernel paths.
``detect_all_octaves`` (the multi-launch path) takes the extrema masks of
every octave from the plain stencil (``mask_backend="xla"``) or from one
launch of K8 (``"pallas"``), then ONE compaction (K3) and ONE refinement
(K4) over every octave.  ``detect_octave`` (the per-octave path of
``kp_multi_launch=False``) runs one octave through the plain stencil, K10a
and K10b.  The kernels live in ``ops/kernels/``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..config import SiftConfig
from .kernels.compact import (compact_mask, compact_mask_ref, compact_masks_multi,
                              compact_masks_multi_ref)
from .kernels.maskk import (extrema_mask, extrema_masks, extrema_masks_ref,  # noqa: F401
                            octave_edge_thresh)
from .kernels.refine import refine_multi, refine_multi_ref, refine_octave, refine_octave_ref
from .pyramid import FUSED_MASK_TODO


class RefinedKeypoints(NamedTuple):
    """Refined keypoints of one octave (octave-local coordinates)."""

    s_int: torch.Tensor   # (cap,) int32 integer scale index
    fs: torch.Tensor      # (cap,) f32 refined scale coordinate
    fr: torch.Tensor      # (cap,) f32 refined row
    fc: torch.Tensor      # (cap,) f32 refined col
    peak: torch.Tensor    # (cap,) f32 interpolated DoG value
    valid: torch.Tensor   # (cap,) bool


def octave_masks(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig,
                 plain: bool = False) -> List[torch.Tensor]:
    """Every octave's extrema mask by ``cfg.mask_backend``: the plain
    stencil for "xla", K8 for "pallas" (its plain version with
    ``plain=True``).  "fused" (the in-ladder masks of K1/K2) raises."""
    if cfg.mask_backend == "xla":
        return extrema_masks_ref(octave_dogs, cfg)
    if cfg.mask_backend == "pallas":
        return (extrema_masks_ref if plain else extrema_masks)(octave_dogs, cfg)
    if cfg.mask_backend == "fused":
        raise NotImplementedError(FUSED_MASK_TODO)
    raise ValueError(f"unknown mask_backend {cfg.mask_backend!r}")


def decode_compacted(octave_dogs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                     caps: Sequence[int], idx_all: torch.Tensor, written: torch.Tensor,
                     bd: int) -> Tuple[torch.Tensor, ...]:
    """Compacted flat mask indices -> refine candidates.

    Maps octave o's slice of ``idx_all`` (flat row-major indices into its
    (S-2, H-2bd, W-2bd) mask) to (scale, row, col), octave-local.  Returns
    (s, r, c, valid), each (sum(caps),); the refine kernel takes its clamp
    bounds from the octave's own (H, W), so no atlas rows or bound arrays."""
    s_l, r_l, c_l, v_l = [], [], [], []
    off = 0
    for o, (mask, cap) in enumerate(zip(masks, caps)):
        _, Hm, Wm = mask.shape
        idx = idx_all[off : off + cap].long()
        off += cap
        valid = torch.arange(cap, device=idx.device) < written[o]
        idx = torch.where(valid, idx, 0)
        rem = idx % (Hm * Wm)
        s_l.append((idx // (Hm * Wm) + 1).to(torch.int32))
        r_l.append((rem // Wm + bd).to(torch.int32))
        c_l.append((rem % Wm + bd).to(torch.int32))
        v_l.append(valid)
    return torch.cat(s_l), torch.cat(r_l), torch.cat(c_l), torch.cat(v_l)


def detect_all_octaves(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig,
                       caps: Sequence[int],
                       plain: bool = False) -> List[Tuple[RefinedKeypoints, torch.Tensor]]:
    """Detection for all octaves: extrema masks (``octave_masks``), then ONE
    compaction (K3) and ONE refinement (K4) over every octave.
    ``plain=True`` runs the kernels' plain PyTorch versions instead (parity
    runs on the card).  Returns a list of (RefinedKeypoints, true extrema
    count) per octave."""
    compact = compact_masks_multi_ref if plain else compact_masks_multi
    refine = refine_multi_ref if plain else refine_multi
    bd = cfg.border_dist
    masks = octave_masks(octave_dogs, cfg, plain=plain)
    idx_all, written, total = compact(masks, list(caps))
    s, r, c, valid = decode_compacted(octave_dogs, masks, caps, idx_all, written, bd)
    fs, fr, fc, peak, acc = refine(octave_dogs, s, r, c, valid, caps, bd,
                                   cfg.peak_thresh, cfg.max_interp_moves)
    out = []
    off = 0
    for o, cap in enumerate(caps):
        sl = slice(off, off + cap)
        off += cap
        kps = RefinedKeypoints(s_int=s[sl], fs=fs[sl], fr=fr[sl], fc=fc[sl],
                               peak=peak[sl], valid=(acc[sl] > 0) & valid[sl])
        out.append((kps, total[o]))
    return out


def detect_octave(dogs: torch.Tensor, cfg: SiftConfig, octave: int, cap: int,
                  plain: bool = False) -> Tuple[RefinedKeypoints, torch.Tensor]:
    """Detection in one octave, the counterpart of the JAX package's
    ``detect_octave_pallas``: the plain stencil (which the per-octave path
    runs whatever ``mask_backend`` says), compaction by K10a and refinement
    by K10b (their plain versions with ``plain=True``).  Returns
    (RefinedKeypoints, true extrema count)."""
    compact = compact_mask_ref if plain else compact_mask
    refine = refine_octave_ref if plain else refine_octave
    bd = cfg.border_dist
    mask = extrema_mask(dogs, cfg, octave)
    idx, written, total = compact(mask, cap)
    s, r, c, valid = decode_compacted([dogs], [mask], [cap], idx, written.reshape(1), bd)
    fs, fr, fc, peak, acc = refine(dogs, s, r, c, valid, bd, cfg.peak_thresh,
                                   cfg.max_interp_moves)
    kps = RefinedKeypoints(s_int=s, fs=fs, fr=fr, fc=fc, peak=peak, valid=(acc > 0) & valid)
    return kps, total
