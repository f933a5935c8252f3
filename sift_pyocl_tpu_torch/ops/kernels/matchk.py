"""K7: best-2 squared-L2 descriptor matching.

Port of ``sift_pyocl_tpu/ops/pallas/matchk.py::best2_l2_pallas``; the kernels
are ``csrc/matchk.cu``.  Per query row: the smallest squared-L2 distance
``d1``, the lowest column ``i1`` that holds it, and ``d2``, the smallest over
every other column; invalid columns are +inf.  Two operand forms, as in the
TPU kernel: u8 descriptors (K7), where every distance is an exact integer in
f32, so the kernel and the plain version agree bit for bit; and f32 (K7f,
also for mixed u8/f32, cast to f32 as the JAX wrapper does), where they
differ by the order of the dot products' sums.  There is no cap on the
number of columns.  ``two_pass`` chooses how the TPU kernel reduces a
distance tile; both of its values compute this one function, which the
port's kernels compute whichever is given.

K7 and K7f split the columns into blocks of ``SPLIT_COLS`` and merge the
splits' best-2 on the card by one rule
(one launch a call); ``best2_split_merge`` is the same merge in plain
PyTorch, held to ``best2_l2_ref`` (and, for f32 operands, to the JAX
package's kernel) on the CPU (``tests/test_torch_match_splits.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import _build, on_cuda

Best2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

SPLIT_COLS = 128  # desc2 columns a K7 or K7f block (K7's two 64-column tiles; K7f's FN)
ROW_TILE = 64     # query rows a K7 or K7f block (csrc/matchk.cu's MT, FM)

# K7's and K7f's per-row-tile ticket counters, per (device, stream): zeroed
# at their first use there and left zero by every call (csrc/matchk.cu).
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _check(desc1, desc2, valid2, valid1) -> None:
    if desc1.ndim != 2 or desc2.ndim != 2 or desc1.shape[1] != 128 or desc2.shape[1] != 128:
        raise ValueError(f"descriptors must be (N, 128), got {tuple(desc1.shape)} "
                         f"and {tuple(desc2.shape)}")
    if desc2.shape[0] < 1:
        raise ValueError("desc2 needs at least one row")
    if valid2.shape != (desc2.shape[0],):
        raise ValueError("valid2 must be (N2,)")
    if valid1 is not None and valid1.shape != (desc1.shape[0],):
        raise ValueError("valid1 must be (N1,)")
    for t in (desc2, valid2, valid1):
        if t is not None and t.device != desc1.device:
            raise ValueError("all inputs must lie on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _counters_of(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least `n` zeroed ticket counters for `stream` on `dev`."""
    key = (dev.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("best2_l2: call it once on this stream at this size before "
                               "capturing a CUDA graph (its counters are made at a call)")
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _counters[key] = buf
    _build.hold_for_graph(buf)
    return buf


def _optional_ptr(t: Optional[torch.Tensor]):
    return None if t is None else _build.ptr(t)


def _valid_bytes(valid2: torch.Tensor, valid1: Optional[torch.Tensor]):
    """The masks as the kernels' uint8 (views of bool masks: no launch)."""
    return _build.as_bytes(valid2), None if valid1 is None else _build.as_bytes(valid1)


def _outputs(a: torch.Tensor) -> Best2:
    n1 = a.shape[0]
    d1 = torch.empty(n1, dtype=torch.float32, device=a.device)
    return d1, torch.empty_like(d1), torch.empty(n1, dtype=torch.int32, device=a.device)


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor, valid2: torch.Tensor,
            valid1: Optional[torch.Tensor]) -> Best2:
    """One launch of K7 (``sift_best2_l2``, u8) or K7f (``sift_best2_l2_f32``,
    f32) on aligned operands, ``SPLIT_COLS`` columns a block, the splits
    merged on the card with the stream's ticket counters."""
    n1, n2 = a.shape[0], b.shape[0]
    d1, d2, i1 = _outputs(a)
    v2, v1 = _valid_bytes(valid2, valid1)
    n_splits = -(-n2 // SPLIT_COLS)
    part = counters = None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if n_splits > 1:
        part = torch.empty(3 * n_splits * n1, dtype=torch.int32, device=a.device)
        counters = _counters_of(a.device, stream, -(-n1 // ROW_TILE))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function(entry, [vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp])
    p = _optional_ptr
    with torch.cuda.device(a.device):
        err = fn(p(a), p(b), p(v1), p(v2), n1, n2, SPLIT_COLS, p(d1), p(d2), p(i1),
                 p(part), p(counters), ctypes.c_void_p(stream))
    _build.check(err, entry.removeprefix("sift_"))
    return d1, d2, i1


def best2_l2(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor,
             valid1: Optional[torch.Tensor] = None, two_pass: bool = False) -> Best2:
    """(d1 (N1,) f32, d2 (N1,) f32, i1 (N1,) int32) of squared-L2 distances.

    On the card: K7 for two uint8 descriptor sets, else K7f
    (``best2_l2_f32``); rows whose `valid1` is False return (0, 0, 0), and
    every caller masks them.  On the CPU the plain version computes every
    row.  ``two_pass`` (False or True) is the TPU kernel's reduction choice
    and gives the same result."""
    _check(desc1, desc2, valid2, valid1)
    if two_pass not in (False, True):
        raise ValueError(f"two_pass must be False or True, got {two_pass!r}")
    if not on_cuda(desc1):
        return best2_l2_ref(desc1, desc2, valid2)
    if desc1.dtype != torch.uint8 or desc2.dtype != torch.uint8:
        return best2_l2_f32(desc1, desc2, valid2, valid1)
    out = _launch("sift_best2_l2", _aligned(desc1), _aligned(desc2), valid2, valid1)
    best2_l2.launches += 1
    return out


best2_l2.launches = 0


def best2_l2_f32(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor,
                 valid1: Optional[torch.Tensor] = None) -> Best2:
    """K7f: ``best2_l2`` with both descriptor sets cast to f32 (the TPU
    kernel's f32 operand form, and its mixed u8/f32 one); its launches are
    counted here, apart from K7's u8 ones."""
    _check(desc1, desc2, valid2, valid1)
    if not on_cuda(desc1):
        return best2_l2_ref(desc1, desc2, valid2)
    out = _launch("sift_best2_l2_f32", _aligned(desc1.to(torch.float32)),
                  _aligned(desc2.to(torch.float32)), valid2, valid1)
    best2_l2_f32.launches += 1
    return out


best2_l2_f32.launches = 0


def best2_l2_ref(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor,
                 valid1: Optional[torch.Tensor] = None) -> Best2:
    """Plain PyTorch version (``ops/match.py::_best2_l2`` of the JAX
    package): one f32 matmul, then min, first argmin and the min with the
    argmin column masked.  Every row is computed; `valid1` is ignored."""
    _check(desc1, desc2, valid2, valid1)
    a = desc1.to(torch.float32)
    b = desc2.to(torch.float32)
    ab = a @ b.T
    na = (a * a).sum(1)
    nb = (b * b).sum(1)
    dist = na[:, None] + nb[None, :] - 2.0 * ab
    dist = torch.where(valid2.bool()[None, :], dist.clamp_min(0.0), torch.inf)
    d1 = dist.min(dim=1).values
    i1 = dist.argmin(dim=1)
    col = torch.arange(dist.shape[1], device=dist.device)
    d2 = torch.where(col[None, :] == i1[:, None], torch.inf, dist).min(dim=1).values
    return d1, d2, i1.to(torch.int32)


def _merge(a: Best2, b: Best2) -> Best2:
    """K7's merge of two partial best-2 states (d1, d2, i1), row by row, by
    the kernel's rule (``csrc/matchk.cu``):

        other best lower, or equal at a lower column -> other wins and
          second = min(own best, other second);
        else second = min(own second, other best).

    So the second excludes only the argmin column, and equal minima go to
    the lowest column whatever the order of merging."""
    best, second, idx = a
    ob, os_, oi = b
    wins = (ob < best) | ((ob == best) & (oi < idx))
    return (torch.where(wins, ob, best),
            torch.where(wins, torch.minimum(best, os_), torch.minimum(second, ob)),
            torch.where(wins, oi, idx))


def best2_split_merge(desc1: torch.Tensor, desc2: torch.Tensor, valid2: torch.Tensor,
                      n_splits: int) -> Best2:
    """K7's column splits in plain PyTorch: desc2's columns cut into
    `n_splits` splits of ceil(N2 / n_splits) columns (the last one
    shorter, empty splits dropped), each split's best-2 by
    ``best2_l2_ref`` (a split with no valid column is (inf, inf, its
    first column), the state the kernel starts a split from), merged in
    ascending split order by ``_merge``.  Equals ``best2_l2_ref`` bit for
    bit; every row is computed."""
    _check(desc1, desc2, valid2, None)
    n2 = desc2.shape[0]
    width = -(-n2 // n_splits)
    out = None
    for c0 in range(0, n2, width):
        d1, d2, i1 = best2_l2_ref(desc1, desc2[c0:c0 + width], valid2[c0:c0 + width])
        part = (d1, d2, i1 + c0)
        out = part if out is None else _merge(out, part)
    return out
