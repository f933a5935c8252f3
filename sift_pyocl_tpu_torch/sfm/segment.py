"""Segment sums that do not depend on the order of float atomics.

The JAX package reduces per-observation blocks with ``jax.ops.segment_sum``
(a scatter-add).  On the card a scatter-add of floats is ``index_add_``,
whose atomics add the rows of one segment in whatever order the threads
arrive, so two runs of the same problem can differ in the last bits.  Here
the ids are sorted once (stable), and each segment's rows are then summed
in that fixed order by ``torch.segment_reduce`` over the CSR offsets, which
gives the same bits on every run.  Ids outside [0, n) are dropped, as
``segment_sum`` drops them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Segments(NamedTuple):
    """Sorted layout of an id vector: segment k is rows ``order[offsets[k]:
    offsets[k + 1]]`` of the data, all of whose ids equal k."""

    ids: torch.Tensor      # (M,) int64 the ids, in data order (for gathers)
    order: torch.Tensor    # (M,) int64 stable argsort of ids
    offsets: torch.Tensor  # (n + 1,) int64


def segments(ids: torch.Tensor, n: int) -> Segments:
    """The layout of `ids` (M,) over n segments; no host synchronisation."""
    ids = ids.long()
    srt, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(srt, torch.arange(n + 1, device=ids.device))
    return Segments(ids, order, offsets)


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Per-segment sums of vals (M, ...) -> (n, ...): each segment's rows in
    sorted order, one fixed order for every run."""
    data = vals.index_select(0, seg.order).reshape(vals.shape[0], -1)
    out = torch.segment_reduce(data, "sum", offsets=seg.offsets, axis=0, unsafe=True)
    return out.reshape((seg.offsets.shape[0] - 1,) + tuple(vals.shape[1:]))
