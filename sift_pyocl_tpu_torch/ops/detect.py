"""DoG extrema detection: mask, compaction and subpixel refinement.

Port of ``sift_pyocl_tpu/ops/detect.py`` on the multi-launch keypoint path:
the extrema mask is the plain PyTorch stencil (the JAX package's default
``mask_backend="xla"``), compaction is K3 and refinement is K4
(``ops/kernels/``), one launch each for all octaves.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..config import SiftConfig
from .kernels.compact import compact_masks_multi, compact_masks_multi_ref
from .kernels.refine import refine_multi, refine_multi_ref

_MASK_TODO = ("mask_backend={!r} needs the extrema-mask kernel K8 (ROADMAP.md, "
              "Queue 2: extrema_masks_atlas_pallas), which is not ported yet; "
              "use mask_backend='xla'")


class RefinedKeypoints(NamedTuple):
    """Refined keypoints of one octave (octave-local coordinates)."""

    s_int: torch.Tensor   # (cap,) int32 integer scale index
    fs: torch.Tensor      # (cap,) f32 refined scale coordinate
    fr: torch.Tensor      # (cap,) f32 refined row
    fc: torch.Tensor      # (cap,) f32 refined col
    peak: torch.Tensor    # (cap,) f32 interpolated DoG value
    valid: torch.Tensor   # (cap,) bool


def octave_edge_thresh(cfg: SiftConfig, octave: int) -> float:
    """Edge threshold by the octsize <= 1 rule (oracle.local_maxmin):
    edge_thresh1 for octave 0, and for octave 1 too when double_im_size."""
    octsize = 2.0 ** (octave - 1) if cfg.double_im_size else 2.0 ** octave
    return cfg.edge_thresh1 if octsize <= 1.0 else cfg.edge_thresh


def extrema_mask(dogs: torch.Tensor, cfg: SiftConfig, octave: int) -> torch.Tensor:
    """Bool mask (scales, H-2bd, W-2bd) of extrema candidates: strict
    26-neighbour max or min, |v| > 0.8 peak_thresh, 2x2 spatial-Hessian edge
    test, border excluded (the "stencil" semantics of the JAX package)."""
    S, H, W = dogs.shape
    bd = cfg.border_dist
    eth = octave_edge_thresh(cfg, octave)
    v = dogs[1 : S - 1, bd : H - bd, bd : W - bd]
    strong = v.abs() > 0.8 * cfg.peak_thresh
    is_max = torch.ones_like(strong)
    is_min = torch.ones_like(strong)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if ds == 0 and dr == 0 and dc == 0:
                    continue
                nb = dogs[1 + ds : S - 1 + ds, bd + dr : H - bd + dr, bd + dc : W - bd + dc]
                is_max &= v > nb
                is_min &= v < nb
    cand = strong & (is_max | is_min)
    d = dogs[1 : S - 1]
    ctr = d[:, bd : H - bd, bd : W - bd]
    hxx = d[:, bd : H - bd, bd - 1 : W - bd - 1] + d[:, bd : H - bd, bd + 1 : W - bd + 1] - 2 * ctr
    hyy = d[:, bd - 1 : H - bd - 1, bd : W - bd] + d[:, bd + 1 : H - bd + 1, bd : W - bd] - 2 * ctr
    hxy = 0.25 * (
        d[:, bd + 1 : H - bd + 1, bd + 1 : W - bd + 1]
        - d[:, bd + 1 : H - bd + 1, bd - 1 : W - bd - 1]
        - d[:, bd - 1 : H - bd - 1, bd + 1 : W - bd + 1]
        + d[:, bd - 1 : H - bd - 1, bd - 1 : W - bd - 1]
    )
    det = hxx * hyy - hxy * hxy
    tr = hxx + hyy
    not_edge = (det > 0) & (det >= eth * tr * tr)
    return cand & not_edge


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
    """Detection for all octaves: extrema masks, then ONE compaction (K3)
    and ONE refinement (K4) over every octave.  ``plain=True`` runs the two
    kernels' plain PyTorch versions instead (parity runs on the card).
    Returns a list of (RefinedKeypoints, true extrema count) per octave."""
    if cfg.mask_backend != "xla":
        raise NotImplementedError(_MASK_TODO.format(cfg.mask_backend))
    compact = compact_masks_multi_ref if plain else compact_masks_multi
    refine = refine_multi_ref if plain else refine_multi
    bd = cfg.border_dist
    masks = [extrema_mask(d, cfg, o) for o, d in enumerate(octave_dogs)]
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
