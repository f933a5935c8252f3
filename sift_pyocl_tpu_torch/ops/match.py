"""Brute-force ratio-test descriptor matching.

Port of ``sift_pyocl_tpu/ops/match.py``.  Two distance modes:

* ``"L2"``: squared Euclidean distance, best and second best per query row
  through the kernel K7 (``ops/kernels/matchk.py``; its plain version on a
  CPU tensor), for any number of columns;
* ``"L1"``: sum |a - b| on uint8 descriptors in int32 (plain PyTorch; an
  XLA path in the JAX package, not a Pallas kernel).

``match_descriptors_dense`` and ``match_descriptors_jax`` are plain
functions: they run inside the VO, registration and probe programs, as the
JAX package inlines its jitted matcher there.  ``match_packed`` is the
matcher that the JAX package calls at top level (``MatchPlan``, the SfM
host loop's ``_match_pairs_packed``): on a card one CUDA graph per (device,
the two sets' shapes, metric, ratio, xy radius) (``MATCH_GRAPHS``, or the
caller's cache) whose one output, [idx1, idx2, valid], comes home in one
copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import graphs
from .kernels.matchk import best2_l2, best2_l2_ref

INT_MAX = 2**31 - 1


class MatchResult(NamedTuple):
    idx1: torch.Tensor    # (cap,) int32 indices into set 1
    idx2: torch.Tensor    # (cap,) int32 indices into set 2
    dist: torch.Tensor    # (cap,) f32 best distance
    valid: torch.Tensor   # (cap,) bool
    count: torch.Tensor   # () int32 true number of matches


def _best2_l1(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, second-best, argbest) of L1 distances per row of desc1, exact
    in int32 (invalid columns INT_MAX), in row chunks of at most 2^24
    differences."""
    rows = max(1, (1 << 24) // (desc2.shape[0] * 128))
    b = desc2.to(torch.int32)
    col = torch.arange(desc2.shape[0], device=desc2.device)
    d1_l, d2_l, i1_l = [], [], []
    for r0 in range(0, desc1.shape[0], rows):
        a = desc1[r0 : r0 + rows].to(torch.int32)
        dist = (a[:, None, :] - b[None, :, :]).abs().sum(-1, dtype=torch.int32)
        dist = torch.where(valid2.bool()[None, :], dist, INT_MAX)
        i1 = dist.argmin(dim=1)
        d1_l.append(dist.min(dim=1).values)
        d2_l.append(torch.where(col[None, :] == i1[:, None], INT_MAX, dist).min(dim=1).values)
        i1_l.append(i1)
    return (torch.cat(d1_l).to(torch.float32), torch.cat(d2_l).to(torch.float32),
            torch.cat(i1_l).to(torch.int32))


def _best2(desc1, valid1, desc2, valid2, metric: str, plain: bool):
    if metric == "L1":
        return _best2_l1(desc1, desc2, valid2)
    if metric == "L2":
        return best2_l2_ref(desc1, desc2, valid2) if plain else best2_l2(desc1, desc2, valid2, valid1)
    raise ValueError(f"unknown metric {metric!r}")


def _ratio_keep(valid1, d1, d2, ratio_sq: float) -> torch.Tensor:
    finite = d2 < float(INT_MAX)          # at least two valid candidates
    return valid1.bool() & finite & (d2 > 0) & (d1 < ratio_sq * d2)


def match_descriptors_dense(desc1: torch.Tensor, valid1: torch.Tensor, desc2: torch.Tensor,
                            valid2: torch.Tensor, metric: str = "L2",
                            ratio_sq: float = 0.5329, plain: bool = False):
    """Per-slot (uncompacted) ratio-test matching.

    Returns (keep (N1,) bool, idx2 (N1,) int32, dist (N1,) f32, dist2 (N1,)
    f32) aligned with desc1's slots; dist2 lets a caller re-gate with a
    looser ratio.  ``plain=True`` runs K7's plain version on any device."""
    d1, d2, i1 = _best2(desc1, valid1, desc2, valid2, metric, plain)
    return _ratio_keep(valid1, d1, d2, ratio_sq), i1, d1, d2


def match_descriptors_jax(desc1: torch.Tensor, valid1: torch.Tensor, desc2: torch.Tensor,
                          valid2: torch.Tensor, metric: str = "L1", ratio_sq: float = 0.5329,
                          xy1: Optional[torch.Tensor] = None, xy2: Optional[torch.Tensor] = None,
                          xy_radius: Optional[Tuple[float, float]] = None,
                          plain: bool = False) -> MatchResult:
    """Ratio-test matching into a static-capacity pair buffer (capacity
    len(desc1)), matches in set-1 order.

    ``xy_radius=(xr, yr)`` with xy1/xy2 (N, 2) keeps a pair only if
    |x1-x2| < xr and |y1-y2| < yr, applied to the best match."""
    d1, d2, i1 = _best2(desc1, valid1, desc2, valid2, metric, plain)
    keep = _ratio_keep(valid1, d1, d2, ratio_sq)
    if xy_radius is not None:
        dxy = (xy1 - xy2[i1.long()]).abs()
        keep = keep & (dxy[:, 0] < xy_radius[0]) & (dxy[:, 1] < xy_radius[1])
    cap = desc1.shape[0]
    count = keep.sum().to(torch.int32)
    # the kept slots first, in index order (np.nonzero's, without a sync)
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    valid = torch.arange(cap, device=keep.device) < count
    sel = torch.where(valid, order, 0)
    return MatchResult(idx1=sel.to(torch.int32), idx2=i1[sel], dist=d1[sel],
                       valid=valid, count=count)


def _match_packed(static, desc1, valid1, desc2, valid2, xy1=None, xy2=None):
    """``match_descriptors_jax`` from flat inputs (a graph body), its
    result packed into one (cap, 3) int32 tensor [idx1, idx2, valid]."""
    metric, ratio_sq, xy_radius = static
    res = match_descriptors_jax(desc1, valid1, desc2, valid2, metric=metric, ratio_sq=ratio_sq,
                                xy1=xy1, xy2=xy2, xy_radius=xy_radius)
    return (torch.stack([res.idx1, res.idx2, res.valid.to(torch.int32)], 1),)


# MatchPlan's matcher on the card (the JAX package's top-level
# ``match_descriptors_jax`` jit)
MATCH_GRAPHS = graphs.GraphCache(_match_packed)


def _packed_args(desc1, valid1, desc2, valid2, metric, ratio_sq, xy1, xy2, xy_radius):
    static = (metric, float(ratio_sq),
              None if xy_radius is None else tuple(float(r) for r in xy_radius))
    inputs = (desc1, valid1, desc2, valid2) + (() if xy_radius is None else (xy1, xy2))
    return static, tuple(torch.as_tensor(t) for t in inputs)


def match_packed(desc1, valid1, desc2, valid2, device, metric: str = "L1",
                 ratio_sq: float = 0.5329, xy1=None, xy2=None, xy_radius=None,
                 cache: graphs.GraphCache = MATCH_GRAPHS) -> torch.Tensor:
    """``match_descriptors_jax`` on `device` as one (cap, 3) int32 tensor
    [idx1, idx2, valid] (cap = len(desc1)).  Tensors or arrays, on the host
    or the device.  On a CUDA device the replay of `cache`'s graph for these
    shapes (host inputs copied in by the replay; the result a view of one
    fresh buffer); elsewhere the eager call, ``_match_packed_eager``."""
    device = torch.device(device)
    if device.type != "cuda":
        return _match_packed_eager(desc1, valid1, desc2, valid2, device, metric, ratio_sq,
                                   xy1, xy2, xy_radius)
    static, inputs = _packed_args(desc1, valid1, desc2, valid2, metric, ratio_sq, xy1, xy2,
                                  xy_radius)
    return cache(device, static, inputs)[0]


def _match_packed_eager(desc1, valid1, desc2, valid2, device, metric: str = "L1",
                        ratio_sq: float = 0.5329, xy1=None, xy2=None, xy_radius=None,
                        cache=None) -> torch.Tensor:
    """``match_packed`` op by op (what its graph captures)."""
    static, inputs = _packed_args(desc1, valid1, desc2, valid2, metric, ratio_sq, xy1, xy2,
                                  xy_radius)
    return _match_packed(static, *(t.to(device) for t in inputs))[0]
