"""DoG extrema detection: mask, compaction and subpixel refinement.

Port of ``sift_pyocl_tpu/ops/detect.py``.  ``detect_all_slots`` (the
multi-launch path; ``detect_all_octaves`` splits it by octave) takes the
extrema masks of every octave from the plain stencil
(``mask_backend="xla"``), from one launch of K8 (``"pallas"``) or from the
ladder kernels' mask forms K1m/K2m (``"fused"``, handed in by the caller),
then ONE compaction (K3) and ONE refinement (K4) over every octave, K4
reading K3's output as it lies on the device.
``detect_octave_pallas`` (the per-octave path of ``kp_multi_launch=False``)
runs one octave through the plain stencil, K10a and K10b.
``detect_octave`` is the plain path of ``kp_backend="xla"``: the stencil,
``compact_extrema`` and ``refine_candidates``, with the JAX package's XLA
arithmetic.  The kernels live in ``ops/kernels/``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import nonzero_first
from ..config import SiftConfig
from .kernels.compact import (compact_mask, compact_mask_ref, compact_masks_multi,
                              compact_masks_multi_ref)
from .kernels.maskk import (extrema_mask, extrema_masks, extrema_masks_ref,  # noqa: F401
                            octave_edge_thresh)
from .kernels.refine import (decode_compacted, refine_multi, refine_multi_ref,  # noqa: F401
                             refine_octave, refine_octave_ref)


class Candidates(NamedTuple):
    """Static-capacity candidate buffer of one octave."""

    s: torch.Tensor       # (cap,) int32 scale index in [1, scales]
    r: torch.Tensor       # (cap,) int32 row
    c: torch.Tensor       # (cap,) int32 col
    valid: torch.Tensor   # (cap,) bool
    count: torch.Tensor   # () int32 true number of extrema (may exceed cap)


class RefinedKeypoints(NamedTuple):
    """Refined keypoints of one octave, or of every octave's slots
    (``detect_all_slots``); octave-local coordinates."""

    s_int: torch.Tensor   # (cap,) int32 integer scale index
    fs: torch.Tensor      # (cap,) f32 refined scale coordinate
    fr: torch.Tensor      # (cap,) f32 refined row
    fc: torch.Tensor      # (cap,) f32 refined col
    peak: torch.Tensor    # (cap,) f32 interpolated DoG value
    valid: torch.Tensor   # (cap,) bool


def octave_masks(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig,
                 plain: bool = False, oct_ids: Optional[Sequence[int]] = None
                 ) -> List[torch.Tensor]:
    """Every entry's extrema mask by ``cfg.mask_backend``: the plain
    stencil for "xla", K8 for "pallas" (its plain version with
    ``plain=True``).  For "fused" the masks come from the ladders
    (``detect_all_octaves(masks=...)``); without them "fused" is the
    stencil, as in the JAX package where its ladder kernels did not run.
    `oct_ids`: each entry's octave number (its edge threshold), 0..n-1 where
    None; a batch's entry list repeats one frame's numbers per frame."""
    if cfg.mask_backend in ("xla", "fused"):
        return extrema_masks_ref(octave_dogs, cfg, oct_ids)
    if cfg.mask_backend == "pallas":
        return (extrema_masks_ref if plain else extrema_masks)(octave_dogs, cfg, oct_ids)
    raise ValueError(f"unknown mask_backend {cfg.mask_backend!r}")


def detect_all_slots(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig,
                     caps: Sequence[int], plain: bool = False,
                     masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
                     oct_ids: Optional[Sequence[int]] = None
                     ) -> Tuple[RefinedKeypoints, torch.Tensor]:
    """Detection for all entries: extrema masks (``octave_masks``, or the
    fused in-ladder `masks` of ``build_scale_space_and_masks``, whose None
    entries take the stencil), then ONE compaction (K3) and ONE refinement
    (K4), which takes the compaction's output as it is.  ``plain=True``
    runs the kernels' plain PyTorch versions instead (parity runs on the
    card).  An entry is one octave of one frame: `oct_ids` gives each its
    octave number (0..n-1 where None, one frame's octaves), which sets its
    edge threshold.  Returns (RefinedKeypoints over all sum(caps) slots,
    entry o's at [sum(caps[:o]), sum(caps[:o+1])); true extrema count
    (n_entries,))."""
    compact = compact_masks_multi_ref if plain else compact_masks_multi
    refine = refine_multi_ref if plain else refine_multi
    oct_ids = list(range(len(octave_dogs)) if oct_ids is None else oct_ids)
    if len(oct_ids) != len(octave_dogs):
        raise ValueError(f"need one octave number per DoG stack: {len(oct_ids)} for "
                         f"{len(octave_dogs)}")
    if masks is None:
        masks = octave_masks(octave_dogs, cfg, plain=plain, oct_ids=oct_ids)
    else:
        masks = [m if m is not None else extrema_mask(d, cfg, o)
                 for o, m, d in zip(oct_ids, masks, octave_dogs)]
    idx_all, written, total = compact(masks, list(caps))
    kps = RefinedKeypoints(*refine(octave_dogs, masks, caps, idx_all, written, cfg.border_dist,
                                   cfg.peak_thresh, cfg.max_interp_moves))
    return kps, total


def detect_all_octaves(octave_dogs: Sequence[torch.Tensor], cfg: SiftConfig,
                       caps: Sequence[int], plain: bool = False,
                       masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
                       oct_ids: Optional[Sequence[int]] = None
                       ) -> List[Tuple[RefinedKeypoints, torch.Tensor]]:
    """``detect_all_slots`` split by entry: a list of (RefinedKeypoints,
    true extrema count) per entry, views of the whole outputs."""
    kps, total = detect_all_slots(octave_dogs, cfg, caps, plain=plain, masks=masks,
                                  oct_ids=oct_ids)
    per_octave = zip(*(f.split(list(caps)) for f in kps))
    return [(RefinedKeypoints(*fields), total[o]) for o, fields in enumerate(per_octave)]


def detect_octave_pallas(dogs: torch.Tensor, cfg: SiftConfig, octave: int, cap: int,
                         plain: bool = False) -> Tuple[RefinedKeypoints, torch.Tensor]:
    """Detection in one octave, the counterpart of the JAX package's
    ``detect_octave_pallas``: the plain stencil (which the per-octave path
    runs whatever ``mask_backend`` says), compaction by K10a and refinement
    by K10b, which takes K10a's output as it is (their plain versions with
    ``plain=True``).  Returns (RefinedKeypoints, true extrema count)."""
    compact = compact_mask_ref if plain else compact_mask
    refine = refine_octave_ref if plain else refine_octave
    mask = extrema_mask(dogs, cfg, octave)
    idx, written, total = compact(mask, cap)
    kps = RefinedKeypoints(*refine(dogs, mask, idx, written, cfg.border_dist, cfg.peak_thresh,
                                   cfg.max_interp_moves))
    return kps, total


def compact_extrema(mask: torch.Tensor, cfg: SiftConfig, cap: int) -> Candidates:
    """The first `cap` set elements of a border-stripped (S-2, H-2bd,
    W-2bd) extrema mask in flat row-major order (``jnp.nonzero(size=cap)``,
    no per-tile limit), as octave (s, r, c); unused slots are (1, bd, bd)
    and invalid."""
    _, Hm, Wm = mask.shape
    bd = cfg.border_dist
    idx, valid, count = nonzero_first(mask.reshape(-1), cap)
    rem = idx % (Hm * Wm)
    return Candidates((idx // (Hm * Wm) + 1).to(torch.int32), (rem // Wm + bd).to(torch.int32),
                      (rem % Wm + bd).to(torch.int32), valid, count)


def _grad_hess_3x3x3(d):
    """3-D gradient (3, m) and Hessian entries of (3, 3, 3, m) DoG
    neighbourhoods (centre [1, 1, 1]), in the JAX package's XLA operation
    order.  Returns (g, (hss, hsr, hsc, hrr, hrc, hcc))."""
    g = torch.stack([0.5 * (d[2, 1, 1] - d[0, 1, 1]), 0.5 * (d[1, 2, 1] - d[1, 0, 1]),
                     0.5 * (d[1, 1, 2] - d[1, 1, 0])])
    ctr = d[1, 1, 1]
    hss = d[2, 1, 1] + d[0, 1, 1] - 2 * ctr
    hrr = d[1, 2, 1] + d[1, 0, 1] - 2 * ctr
    hcc = d[1, 1, 2] + d[1, 1, 0] - 2 * ctr
    hsr = 0.25 * (d[2, 2, 1] - d[2, 0, 1] - d[0, 2, 1] + d[0, 0, 1])
    hsc = 0.25 * (d[2, 1, 2] - d[2, 1, 0] - d[0, 1, 2] + d[0, 1, 0])
    hrc = 0.25 * (d[1, 2, 2] - d[1, 2, 0] - d[1, 0, 2] + d[1, 0, 0])
    return g, (hss, hsr, hsc, hrr, hrc, hcc)


def _solve3(h, b):
    """Solve H x = b for symmetric 3x3 H (entries `h` as from
    ``_grad_hess_3x3x3``, b (3, m)) by the adjugate; ok is False where
    |det| <= 1e-30 (the oracle's singular-matrix rejection)."""
    a, bb, cc, d, e, f = h
    det = a * (d * f - e * e) - bb * (bb * f - e * cc) + cc * (bb * e - d * cc)
    adj = ((d * f - e * e, cc * e - bb * f, bb * e - cc * d),
           (e * cc - bb * f, a * f - cc * cc, bb * cc - a * e),
           (bb * e - d * cc, cc * bb - a * e, a * d - bb * bb))
    ok = det.abs() > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    x = torch.stack([(row[0] * b[0] + row[1] * b[1]) + row[2] * b[2] for row in adj])
    return x / safe, ok


def refine_candidates(dogs: torch.Tensor, cands: Candidates, cfg: SiftConfig) -> RefinedKeypoints:
    """Batched iterative 3-D quadratic refinement (oracle.interp_keypoint):
    up to ``max_interp_moves`` moves of one pixel where |offset| > 0.6 and
    the move stays inside the border, then a final solve; accepted iff
    solvable, |peak| > peak_thresh and every offset within 1.5."""
    S, H, W = dogs.shape
    bd = cfg.border_dist
    s = cands.s.long()
    d3 = torch.arange(3, device=dogs.device)

    def gather_solve(r_, c_):
        # the 3x3x3 cube, its start clamped into the stack as dynamic_slice does
        s0 = (s - 1).clamp(0, S - 3)
        r0 = (r_ - 1).clamp(0, H - 3)
        c0 = (c_ - 1).clamp(0, W - 3)
        cube = dogs[(s0 + d3[:, None])[:, None, None, :], (r0 + d3[:, None])[None, :, None, :],
                    (c0 + d3[:, None])[None, None, :, :]]
        g, h = _grad_hess_3x3x3(cube)
        off, ok = _solve3(h, -g)
        return cube, g, off, ok

    r_, c_ = cands.r.long(), cands.c.long()
    for _ in range(cfg.max_interp_moves):
        _, _, off, _ = gather_solve(r_, c_)
        converged = (off[1].abs() <= 0.6) & (off[2].abs() <= 0.6)
        dr = torch.where(off[1] > 0.6, 1, torch.where(off[1] < -0.6, -1, 0))
        dc = torch.where(off[2] > 0.6, 1, torch.where(off[2] < -0.6, -1, 0))
        dr = torch.where((dr > 0) & (r_ + 1 >= H - bd), 0, dr)
        dr = torch.where((dr < 0) & (r_ - 1 < bd), 0, dr)
        dc = torch.where((dc > 0) & (c_ + 1 >= W - bd), 0, dc)
        dc = torch.where((dc < 0) & (c_ - 1 < bd), 0, dc)
        r_ = torch.where(converged, r_, r_ + dr)
        c_ = torch.where(converged, c_, c_ + dc)
    cube, g, off, ok = gather_solve(r_, c_)
    peak = cube[1, 1, 1] + 0.5 * ((g[0] * off[0] + g[1] * off[1]) + g[2] * off[2])
    accept = ok & (peak.abs() > cfg.peak_thresh) & (off.abs() <= 1.5).all(dim=0)
    return RefinedKeypoints(s_int=cands.s, fs=s.float() + off[0], fr=r_.float() + off[1],
                            fc=c_.float() + off[2], peak=peak, valid=accept & cands.valid)


def detect_octave(dogs: torch.Tensor, cfg: SiftConfig, octave: int, cap: int) -> RefinedKeypoints:
    """Plain detection in one octave (``kp_backend="xla"``): the extrema
    stencil, ``compact_extrema`` and ``refine_candidates``."""
    mask = extrema_mask(dogs, cfg, octave)
    return refine_candidates(dogs, compact_extrema(mask, cfg, cap), cfg)
