"""K4 and K10b: iterative subpixel refinement of extrema candidates.

Port of ``sift_pyocl_tpu/ops/pallas/refine.py``: ``refine_atlas_pallas``
(K4, every octave in one launch, here ``refine_multi``) and
``refine_pallas`` (K10b, one octave, here ``refine_octave``); both launch
the kernel of ``csrc/refine.cu``.  Candidates of octave o occupy slots
[sum(caps[:o]), sum(caps[:o+1])) with octave-local (s, r, c); the kernel
reads each octave's own DoG stack, so the TPU's padded DoG atlas (and
``pad_dogs``) and the per-candidate clamp-bound arrays become the octave's
(H, W) and ``border_dist``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import _build, on_cuda

Refined = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(octave_dogs, s, r, c, valid, caps) -> None:
    n = int(sum(caps))
    if len(octave_dogs) != len(caps):
        raise ValueError("need one capacity per octave")
    for t in (s, r, c, valid):
        if t.shape != (n,):
            raise ValueError(f"candidate arrays must be ({n},), got {tuple(t.shape)}")
    for d in octave_dogs:
        if d.dtype != torch.float32 or d.ndim != 3 or d.shape[0] < 3:
            raise ValueError("DoG stacks must be (S+2, H, W) float32")
        if d.device != s.device:
            raise ValueError("DoG stacks and candidates must lie on one device")


def _launch(dogs, s, r, c, valid, caps, border_dist, peak_thresh, max_moves) -> Refined:
    """One launch of ``csrc/refine.cu`` (the work of K4 and K10b)."""
    dogs = [d.contiguous() for d in dogs]
    n_oct = len(dogs)
    s32, r32, c32 = (t.to(torch.int32).contiguous() for t in (s, r, c))
    v8 = valid.to(torch.uint8).contiguous()
    n = s32.numel()
    fs, fr, fc, peak = (torch.empty(n, dtype=torch.float32, device=s.device)
                        for _ in range(4))
    accept = torch.empty(n, dtype=torch.int32, device=s.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_refine_multi",
                         [ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ctypes.c_float, ci,
                          vp, vp, vp, vp, vp, vp])
    ptrs = (vp * n_oct)(*[d.data_ptr() for d in dogs])
    hs = (ci * n_oct)(*[d.shape[1] for d in dogs])
    ws = (ci * n_oct)(*[d.shape[2] for d in dogs])
    caps_c = (ci * n_oct)(*[int(x) for x in caps])
    with torch.cuda.device(s.device):
        err = fn(n_oct, ptrs, hs, ws, caps_c, _build.ptr(s32), _build.ptr(r32),
                 _build.ptr(c32), _build.ptr(v8), int(border_dist), float(peak_thresh),
                 int(max_moves), _build.ptr(fs), _build.ptr(fr), _build.ptr(fc),
                 _build.ptr(peak), _build.ptr(accept), _build.stream_of(s32))
    _build.check(err, "refine")
    return fs, fr, fc, peak, accept


def refine_multi(octave_dogs: Sequence[torch.Tensor], s: torch.Tensor, r: torch.Tensor,
                 c: torch.Tensor, valid: torch.Tensor, caps: Sequence[int],
                 border_dist: int, peak_thresh: float, max_moves: int = 5) -> Refined:
    """K4: refine every octave's candidates in one launch.

    Returns (fs, fr, fc, peak) float32 and accept int32, each (sum(caps),);
    fr and fc are octave-local; invalid slots give zeros."""
    _check(octave_dogs, s, r, c, valid, caps)
    if not on_cuda(s):
        return refine_multi_ref(octave_dogs, s, r, c, valid, caps, border_dist,
                                peak_thresh, max_moves)
    out = _launch(octave_dogs, s, r, c, valid, caps, border_dist, peak_thresh, max_moves)
    refine_multi.launches += 1
    return out


refine_multi.launches = 0


def refine_octave(dogs: torch.Tensor, s: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
                  valid: torch.Tensor, border_dist: int, peak_thresh: float,
                  max_moves: int = 5) -> Refined:
    """K10b, port of ``sift_pyocl_tpu/ops/pallas/refine.py::refine_pallas``:
    refine one octave's candidates (a single-octave launch of K4's kernel,
    on the unpadded (S+2, H, W) stack).  Same outputs as ``refine_multi``
    with one octave; fr and fc are octave-local."""
    _check([dogs], s, r, c, valid, [s.shape[0]])
    if not on_cuda(s):
        return refine_octave_ref(dogs, s, r, c, valid, border_dist, peak_thresh, max_moves)
    out = _launch([dogs], s, r, c, valid, [s.shape[0]], border_dist, peak_thresh, max_moves)
    refine_octave.launches += 1
    return out


refine_octave.launches = 0


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


def refine_octave_ref(dogs: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
                      c: torch.Tensor, valid: torch.Tensor, border_dist: int,
                      peak_thresh: float, max_moves: int = 5) -> Refined:
    """Plain PyTorch version of ``refine_octave`` (same outputs, same bits)."""
    _check([dogs], s, r, c, valid, [s.shape[0]])
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
            torch.where(v, c_.float() + oc_, zero), torch.where(v, peak, zero),
            acc.to(torch.int32))


def refine_multi_ref(octave_dogs: Sequence[torch.Tensor], s: torch.Tensor, r: torch.Tensor,
                     c: torch.Tensor, valid: torch.Tensor, caps: Sequence[int],
                     border_dist: int, peak_thresh: float, max_moves: int = 5) -> Refined:
    """Plain PyTorch version of ``refine_multi`` (same outputs, same bits):
    ``refine_octave_ref`` over each octave's slots."""
    _check(octave_dogs, s, r, c, valid, caps)
    outs = []
    off = 0
    for d, cap in zip(octave_dogs, caps):
        sl = slice(off, off + int(cap))
        off += int(cap)
        outs.append(refine_octave_ref(d, s[sl], r[sl], c[sl], valid[sl], border_dist,
                                      peak_thresh, max_moves))
    return tuple(torch.cat(parts) for parts in zip(*outs))
