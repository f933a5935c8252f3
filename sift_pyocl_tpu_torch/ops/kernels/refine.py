"""K4 and K10b: iterative subpixel refinement of extrema candidates.

Port of ``sift_pyocl_tpu/ops/pallas/refine.py``: ``refine_atlas_pallas``
(K4, every octave in one launch, here ``refine_multi``) and
``refine_pallas`` (K10b, one octave, here ``refine_octave``); both are one
launch of the kernel of ``csrc/refine.cu``.  They take the compaction's
output as it lies on the device (K3's or K10a's ``idx`` and ``written``):
octave o owns slots [sum(caps[:o]), sum(caps[:o+1])), its first
``written[o]`` valid, each an index into the octave's border-stripped
(S-2, H-2bd, W-2bd) extrema mask.  The kernel decodes each slot itself
(``decode_compacted`` is that decode in plain PyTorch) and reads each
octave's own DoG stack, so the TPU's padded DoG atlas (and ``pad_dogs``)
and the per-candidate clamp-bound arrays become the octave's (H, W) and
``border_dist``.

Both return (s_int int32, fs, fr, fc, peak f32, keep bool), each one value
a slot, in the field order of ``ops.detect.RefinedKeypoints``; fr and fc
are octave-local, keep is accept && valid, and an invalid slot gives
s_int 1 and zeros.  On the card they are views of one allocation.  The
ctypes arguments are cached per layout (DoG shapes, caps, border), so a
warm call builds none.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from .. import _build, on_cuda

Refined = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]

# Threads a block of the kernel (a multiple of 32, at most 256): 32 spreads
# the valid slots over the most SMs, and measured fastest on the H100
# (tools/ab_refine_cuda.py).
THREADS = 32


def _check(octave_dogs, masks, caps, idx, written, border_dist) -> None:
    if not octave_dogs or len(octave_dogs) != len(caps) or len(masks) != len(caps):
        raise ValueError("need one DoG stack, one mask and one capacity per octave")
    if border_dist < 1:
        raise ValueError("border_dist must be >= 1")
    n = int(sum(caps))
    if idx.dtype != torch.int32 or idx.shape != (n,):
        raise ValueError(f"idx must be ({n},) int32, got {tuple(idx.shape)} {idx.dtype}")
    if written.dtype != torch.int32 or written.numel() != len(caps):
        raise ValueError(f"written must hold {len(caps)} int32, got {tuple(written.shape)} "
                         f"{written.dtype}")
    bd = border_dist
    for d, m in zip(octave_dogs, masks):
        if d.dtype != torch.float32 or d.ndim != 3 or d.shape[0] < 3:
            raise ValueError("DoG stacks must be (S+2, H, W) float32")
        want = (d.shape[0] - 2, d.shape[1] - 2 * bd, d.shape[2] - 2 * bd)
        if tuple(m.shape) != want or min(want) < 1:
            raise ValueError(f"the compacted mask must be (S-2, H-2bd, W-2bd) = {want} for "
                             f"DoGs {tuple(d.shape)}, got {tuple(m.shape)}")
        if d.device != idx.device or written.device != idx.device:
            raise ValueError("DoG stacks and the compaction's output must lie on one device")


class _Chunk(NamedTuple):
    """One launch's ctypes arguments: entries [a, b) from slot `slot0` on."""
    a: int
    b: int
    slot0: int
    ptrs: ctypes.Array          # refilled with the DoG pointers at each call
    hs: ctypes.Array
    ws: ctypes.Array
    caps: ctypes.Array


class _Layout(NamedTuple):
    """What a call needs apart from its data pointers, for one set of DoG
    and mask shapes, caps and border (checked once, when it is made): the
    bound C function, each launch's ctypes arrays (one launch for at most
    ``_build.MAX_ENTRIES`` octaves) and the output's field sizes."""
    fn: ctypes._CFuncPtr
    chunks: List[_Chunk]
    n: int
    split: List[int]            # words of s_int, fs, fr, fc, peak and keep


_layouts: Dict[tuple, _Layout] = {}


def _launch(dogs, masks, caps, idx, written, border_dist, peak_thresh, max_moves
            ) -> Tuple[Refined, int]:
    """The launches of ``csrc/refine.cu`` (the work of K4 and K10b): one,
    or one for each ``_build.entry_chunks`` part of a longer octave list,
    each into its own slots of one buffer.  A warm call (shapes, caps and
    border seen before) builds no ctypes array and checks only types,
    devices, lengths and contiguity.  Returns (outputs, launches)."""
    key = (tuple(d.shape for d in dogs), tuple(m.shape for m in masks), tuple(caps), border_dist)
    lay = _layouts.get(key)
    if lay is None:
        _check(dogs, masks, caps, idx, written, border_dist)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        n = int(sum(caps))
        fn = _build.function("sift_refine_multi", [ci, vp, vp, vp, vp, vp, vp, ci,
                                                   ctypes.c_float, ci, ci, vp,
                                                   ctypes.c_longlong, ctypes.c_longlong, vp])
        chunks = []
        for a, b in _build.entry_chunks(len(dogs)):
            chunks.append(_Chunk(a=a, b=b, slot0=int(sum(caps[:a])), ptrs=(vp * (b - a))(),
                                 hs=(ci * (b - a))(*[d.shape[1] for d in dogs[a:b]]),
                                 ws=(ci * (b - a))(*[d.shape[2] for d in dogs[a:b]]),
                                 caps=(ci * (b - a))(*[int(c) for c in caps[a:b]])))
        lay = _Layout(fn=fn, chunks=chunks, n=n, split=[n] * 5 + [(n + 3) // 4])
        _layouts[key] = lay
    dev = idx.get_device()
    if (idx.dtype != torch.int32 or written.dtype != torch.int32 or idx.numel() != lay.n
            or written.numel() != len(dogs) or written.get_device() != dev
            or not (idx.is_contiguous() and written.is_contiguous())
            or any(d.dtype != torch.float32 or d.get_device() != dev or not d.is_contiguous()
                   for d in dogs)):
        _check(dogs, masks, caps, idx, written, border_dist)
        raise ValueError("refine: DoG stacks, idx and written must be contiguous")
    buf = torch.empty(sum(lay.split), dtype=torch.float32, device=idx.device)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for ch in lay.chunks:
            for o, d in enumerate(dogs[ch.a:ch.b]):
                ch.ptrs[o] = d.data_ptr()
            err = lay.fn(ch.b - ch.a, ch.ptrs, ch.hs, ch.ws, ch.caps,
                         idx.data_ptr() + 4 * ch.slot0, written.data_ptr() + 4 * ch.a,
                         border_dist, peak_thresh, max_moves, THREADS, buf.data_ptr(), lay.n,
                         ch.slot0, stream)
            _build.check(err, "refine")
    s_int, fs, fr, fc, peak, keep = buf.split(lay.split)
    keep = keep.view(torch.bool)
    return (s_int.view(torch.int32), fs, fr, fc, peak,
            keep if lay.n % 4 == 0 else keep[:lay.n]), len(lay.chunks)


def refine_multi(octave_dogs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                 caps: Sequence[int], idx: torch.Tensor, written: torch.Tensor,
                 border_dist: int, peak_thresh: float, max_moves: int = 5) -> Refined:
    """K4: refine every octave's compacted candidates in one launch (one
    for at most ``_build.MAX_ENTRIES`` octaves: a batch's longer list is
    split, ``_build.entry_chunks``).

    `masks` are the (S-2, H-2bd, W-2bd) masks that K3 compacted into
    (idx (sum(caps),) int32, written (n_oct,) int32); only their shapes are
    read.  Returns (s_int, fs, fr, fc, peak, keep), each (sum(caps),)."""
    if not on_cuda(idx):
        return refine_multi_ref(octave_dogs, masks, caps, idx, written, border_dist,
                                peak_thresh, max_moves)
    out, launches = _launch(octave_dogs, masks, caps, idx, written, border_dist, peak_thresh,
                            max_moves)
    refine_multi.launches += launches
    return out


refine_multi.launches = 0


def refine_octave(dogs: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                  written: torch.Tensor, border_dist: int, peak_thresh: float,
                  max_moves: int = 5) -> Refined:
    """K10b, port of ``sift_pyocl_tpu/ops/pallas/refine.py::refine_pallas``:
    refine one octave's candidates as K10a left them (idx (cap,) int32,
    written () int32), on the unpadded (S+2, H, W) stack: a single-octave
    launch of K4's kernel.  Same outputs as ``refine_multi`` with one
    octave."""
    if not on_cuda(idx):
        return refine_octave_ref(dogs, mask, idx, written, border_dist, peak_thresh, max_moves)
    out, launches = _launch([dogs], [mask], [idx.shape[0]], idx, written, border_dist,
                            peak_thresh, max_moves)
    refine_octave.launches += launches
    return out


refine_octave.launches = 0


def decode_compacted(octave_dogs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                     caps: Sequence[int], idx_all: torch.Tensor, written: torch.Tensor,
                     bd: int) -> Tuple[torch.Tensor, ...]:
    """Compacted flat mask indices -> refine candidates, in plain PyTorch
    (the decode that the kernel does in each thread).

    Maps octave o's slice of ``idx_all`` (flat row-major indices into its
    (S-2, H-2bd, W-2bd) mask) to (scale, row, col), octave-local.  Returns
    (s, r, c, valid), each (sum(caps),); an invalid slot decodes index 0,
    (1, bd, bd)."""
    _check(octave_dogs, masks, caps, idx_all, written, bd)
    s_l, r_l, c_l, v_l = [], [], [], []
    off = 0
    for o, (mask, cap) in enumerate(zip(masks, caps)):
        _, Hm, Wm = mask.shape
        idx = idx_all[off : off + cap].long()
        off += cap
        valid = torch.arange(cap, device=idx.device) < written.reshape(-1)[o]
        idx = torch.where(valid, idx, 0)
        rem = idx % (Hm * Wm)
        s_l.append((idx // (Hm * Wm) + 1).to(torch.int32))
        r_l.append((rem // Wm + bd).to(torch.int32))
        c_l.append((rem % Wm + bd).to(torch.int32))
        v_l.append(valid)
    return torch.cat(s_l), torch.cat(r_l), torch.cat(c_l), torch.cat(v_l)


def _solve_at(d: torch.Tensor, s, r, c):
    """Offsets, peak and solvability at (s, r, c) of one (S+2, H, W) stack,
    in the kernel's (and the Pallas kernel's) operation order."""
    _, H, W = d.shape
    flat = d.reshape(-1)

    def v(ds, dr, dc):
        return flat[((s + ds) * H + (r + dr)) * W + (c + dc)]

    c0, c1, c2 = v(-1, 0, 0), v(0, 0, 0), v(1, 0, 0)
    gs = 0.5 * (c2 - c0)
    gr = 0.5 * (v(0, 1, 0) - v(0, -1, 0))
    gc = 0.5 * (v(0, 0, 1) - v(0, 0, -1))
    hss = (c2 + c0) - 2.0 * c1
    hrr = (v(0, 1, 0) + v(0, -1, 0)) - 2.0 * c1
    hcc = (v(0, 0, 1) + v(0, 0, -1)) - 2.0 * c1
    hsr = 0.25 * ((v(1, 1, 0) - v(1, -1, 0)) - (v(-1, 1, 0) - v(-1, -1, 0)))
    hsc = 0.25 * ((v(1, 0, 1) - v(1, 0, -1)) - (v(-1, 0, 1) - v(-1, 0, -1)))
    hrc = 0.25 * (((v(0, 1, 1) - v(0, 1, -1)) - v(0, -1, 1)) + v(0, -1, -1))
    a, b, cc, dd, e, f = hss, hsr, hsc, hrr, hrc, hcc
    det = (a * (dd * f - e * e) - b * (b * f - e * cc)) + cc * (b * e - dd * cc)
    ok = det.abs() > 1e-30
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    os_ = -(((dd * f - e * e) * gs + (cc * e - b * f) * gr) + (b * e - cc * dd) * gc) * inv
    or_ = -(((e * cc - b * f) * gs + (a * f - cc * cc) * gr) + (b * cc - a * e) * gc) * inv
    oc_ = -(((b * e - dd * cc) * gs + (cc * b - a * e) * gr) + (a * dd - b * b) * gc) * inv
    peak = c1 + 0.5 * ((gs * os_ + gr * or_) + gc * oc_)
    return os_, or_, oc_, peak, ok


def refine_candidates_ref(dogs: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
                          c: torch.Tensor, valid: torch.Tensor, border_dist: int,
                          peak_thresh: float, max_moves: int = 5
                          ) -> Tuple[torch.Tensor, ...]:
    """The refinement of decoded candidates (s, r, c, valid) of one (S+2, H,
    W) stack in plain PyTorch: (fs, fr, fc, peak) f32 and accept && valid
    (bool), zeros at invalid slots."""
    bd = border_dist
    S2, H, W = dogs.shape
    v = valid.bool()
    # invalid slots may hold anything: gather them at a safe pixel
    s_ = torch.where(v, s.long(), 1).clamp(1, S2 - 2)
    r_ = torch.where(v, r.long(), 1).clamp(1, H - 2)
    c_ = torch.where(v, c.long(), 1).clamp(1, W - 2)
    for _ in range(max_moves):
        _, o_r, o_c, _, _ = _solve_at(dogs, s_, r_, c_)
        converged = (o_r.abs() <= 0.6) & (o_c.abs() <= 0.6)
        dr = torch.where(o_r > 0.6, 1, torch.where(o_r < -0.6, -1, 0))
        dc = torch.where(o_c > 0.6, 1, torch.where(o_c < -0.6, -1, 0))
        dr = torch.where((dr > 0) & (r_ + 1 >= H - bd), 0, dr)
        dr = torch.where((dr < 0) & (r_ - 1 < bd), 0, dr)
        dc = torch.where((dc > 0) & (c_ + 1 >= W - bd), 0, dc)
        dc = torch.where((dc < 0) & (c_ - 1 < bd), 0, dc)
        r_ = torch.where(converged, r_, r_ + dr)
        c_ = torch.where(converged, c_, c_ + dc)
    os_, or_, oc_, peak, ok = _solve_at(dogs, s_, r_, c_)
    acc = (ok & (peak.abs() > peak_thresh) & (os_.abs() <= 1.5)
           & (or_.abs() <= 1.5) & (oc_.abs() <= 1.5) & v)
    zero = torch.zeros_like(peak)
    return (torch.where(v, s_.float() + os_, zero), torch.where(v, r_.float() + or_, zero),
            torch.where(v, c_.float() + oc_, zero), torch.where(v, peak, zero), acc)


def refine_multi_ref(octave_dogs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                     caps: Sequence[int], idx: torch.Tensor, written: torch.Tensor,
                     border_dist: int, peak_thresh: float, max_moves: int = 5) -> Refined:
    """Plain PyTorch version of ``refine_multi`` (same outputs, same bits):
    ``decode_compacted``, then ``refine_candidates_ref`` over each
    octave's slots."""
    s, r, c, valid = decode_compacted(octave_dogs, masks, caps, idx, written, border_dist)
    outs = []
    off = 0
    for d, cap in zip(octave_dogs, caps):
        sl = slice(off, off + int(cap))
        off += int(cap)
        outs.append(refine_candidates_ref(d, s[sl], r[sl], c[sl], valid[sl], border_dist,
                                          peak_thresh, max_moves))
    return (s, *(torch.cat(parts) for parts in zip(*outs)))


def refine_octave_ref(dogs: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                      written: torch.Tensor, border_dist: int, peak_thresh: float,
                      max_moves: int = 5) -> Refined:
    """Plain PyTorch version of ``refine_octave`` (same outputs, same bits)."""
    return refine_multi_ref([dogs], [mask], [idx.shape[0]], idx, written, border_dist,
                            peak_thresh, max_moves)
