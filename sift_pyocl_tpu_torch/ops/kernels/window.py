"""K6, K11a and K11b: per-keypoint orientation and descriptor histograms.

Port of ``sift_pyocl_tpu/ops/pallas/window.py``: ``orient_desc_fused_pallas``
(K6, here ``orient_desc_fused``), ``orientation_hist_pallas`` (K11a,
``orientation_hist``) and ``descriptor_hist_pallas`` (K11b,
``descriptor_hist``); the kernels are ``csrc/window.cu``.  K6 reads the
gradient atlas of ``ops/kernels/gradpad.py``: keypoint i's octave starts at
atlas row ``row_off[i]`` and is ``oct_h[i]`` x ``oct_w[i]``.  K11a and K11b
read one octave's planes zero-padded by ``pad_grad_planes``
(``ops/orient_desc.py``), as the JAX kernels do, through a view of the
octave inside them.  Window samples outside the octave contribute 0, so the
static window ``win`` may be any size (the TPU kernels' ``win <= 128`` was a
lane limit).  The plain versions share one body of histogram arithmetic
(``_orientation_hists``, ``_descriptor_hists``), which the plain
``kp_backend="xla"`` path runs too.

K6's kernel walks only each keypoint's support inside that window: the
boxes ``support_boxes`` computes (the orientation circle's, and at each
angle the 25 descriptor quads'), which hold every sample the plain
arithmetic counts (``tests/test_torch_window_support.py``).  K11a and K11b
run K6's own step A and step C over the same boxes, so K11b at K6's angles
gives K6's raw descriptors bit for bit.  Each kernel computes each window's
origin from fr/fc itself, so a call with the main path's argument types is
one CUDA launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build, nonzero_first, on_cuda
from ..orient_desc import PAD_C, PAD_R, smooth_orientation_hist
from ...oracle import DESC_GRID, DESC_ORI, MAG_FACTOR, N_ORI_BINS

PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2 * np.pi))
ORI_SCALE = float(np.float32(DESC_ORI / (2 * np.pi)))
MAX_ORI = 8
LOG2E = 1.0 / math.log(2.0)

Fused = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def window_origin(fr: torch.Tensor, fc: torch.Tensor, win: int):
    """Window origin (rs, cs) int32 and the keypoint's subpixel offsets from
    it (fro, fco) float32, as the Pallas wrapper computes them."""
    half = win // 2
    rs = torch.round(fr).to(torch.int32) - half
    cs = torch.round(fc).to(torch.int32) - half
    return rs, cs, fr - rs.to(torch.float32), fc - cs.to(torch.float32)


def slot_octave_geometry(caps: Sequence[int], row_starts: Sequence[int],
                         blurs: Sequence[torch.Tensor]):
    """Per keypoint slot (caps[o] slots per octave, octave by octave) the
    (row_off, oct_h, oct_w) int32 arrays ``orient_desc_fused`` takes: the
    octave's first row in the gradient atlas and its height and width."""
    dev = blurs[0].device

    def per_slot(values):
        return torch.cat([torch.full((cap,), int(v), dtype=torch.int32, device=dev)
                          for v, cap in zip(values, caps)])

    return (per_slot(row_starts), per_slot([b.shape[-2] for b in blurs]),
            per_slot([b.shape[-1] for b in blurs]))


N_QUADS = (DESC_GRID + 1) ** 2   # descriptor quads: (floor(rbin), floor(cbin)) in -1..3


def _box_span(f, centre, half, win: int, origin, extent):
    """[lo, hi) of the window samples whose offset from the keypoint lies
    in [centre - half, centre + half], inside the window and the octave
    (``csrc/window.cu::box_span``, the same f32 operations)."""
    lo = torch.ceil((f + centre) - half).to(torch.int64)
    hi = torch.floor((f + centre) + half).to(torch.int64) + 1
    lo = torch.maximum(lo.clamp(min=0), -origin)
    hi = torch.minimum(hi.clamp(max=win), extent - origin)
    return lo, hi


def support_boxes(fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor, win: int,
                  oct_h, oct_w, angle=None) -> torch.Tensor:
    """K6's support boxes, as the kernel computes them, in window
    coordinates (r0, r1, c0, c1), half-open, empty where r1 <= r0 or
    c1 <= c0; clipped to the win x win window and to the oct_h x oct_w
    octave (ints or (n,) tensors).  Without `angle`: (n, 4), the
    orientation circle's box, |offset| <= floor(4.5 sigma) + 1.  With
    `angle` (n,): (n, 25, 4), the box of each descriptor quad (qr, qc) in
    -1..3 (quad 5 (qr + 1) + qc + 1): the samples whose (floor(rbin),
    floor(cbin)) is (qr, qc), a square of side 3 sigma rotated by `angle`
    and centred at bin offset (qr - 1, qc - 1), plus one sample.  The
    kernel walks these boxes; the plain versions do not use them."""
    rs, cs, fro, fco = window_origin(fr.float(), fc.float(), win)
    sig = sigma.float()
    H = torch.as_tensor(oct_h, device=fr.device).long()
    W = torch.as_tensor(oct_w, device=fr.device).long()
    rs, cs = rs.long(), cs.long()
    if angle is None:
        half = torch.floor(3.0 * (1.5 * sig)) + 1.0
        zero = torch.zeros_like(sig)
        r = _box_span(fro, zero, half, win, rs, H)
        c = _box_span(fco, zero, half, win, cs, W)
        return torch.stack([r[0], r[1], c[0], c[1]], dim=-1)
    a = angle.float()
    cos_t, sin_t = torch.cos(a)[:, None], torch.sin(a)[:, None]
    sp = (3.0 * sig)[:, None]
    q = torch.arange(N_QUADS, device=fr.device)
    ur = (q // (DESC_GRID + 1) - 2).to(torch.float32)   # qr - 1
    uc = (q % (DESC_GRID + 1) - 2).to(torch.float32)    # qc - 1
    cr = sp * (cos_t * ur + sin_t * uc)
    cc = sp * (cos_t * uc - sin_t * ur)
    half = (0.5 * sp) * (torch.abs(cos_t) + torch.abs(sin_t)) + 1.0
    if H.ndim:
        H, W = H[:, None], W[:, None]
    r = _box_span(fro[:, None], cr, half, win, rs[:, None], H)
    c = _box_span(fco[:, None], cc, half, win, cs[:, None], W)
    return torch.stack([r[0], r[1], c[0], c[1]], dim=-1)


def box_samples(boxes: torch.Tensor) -> torch.Tensor:
    """The samples each box holds: (r1 - r0) (c1 - c0), 0 where empty."""
    return ((boxes[..., 1] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 2]).clamp(min=0))


def _check(mag, ori, arrays, win, max_ori) -> None:
    if mag.shape != ori.shape or mag.ndim != 3 or mag.dtype != torch.float32:
        raise ValueError("mag/ori must be matching (S, rows, wmax) float32 atlases")
    n = arrays[0].shape[0]
    for t in arrays:
        if t.shape != (n,) or t.device != mag.device:
            raise ValueError("per-keypoint arrays must be (cap,) on the atlas's device")
    if not 1 <= max_ori <= MAX_ORI or win < 1:
        raise ValueError(f"need 1 <= max_ori <= {MAX_ORI} and win >= 1")


REDUCE_MODES = ("scalar", "colsum")


def orient_desc_fused(mag: torch.Tensor, ori: torch.Tensor, s_int: torch.Tensor,
                      fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                      valid: torch.Tensor, win: int, max_ori: int,
                      row_off: torch.Tensor, oct_h: torch.Tensor,
                      oct_w: torch.Tensor, reduce_mode: str = "scalar") -> Fused:
    """Orientations and raw descriptors of every keypoint slot in one launch.

    fr/fc are octave-local.  Returns (angles (cap, max_ori) f32,
    ok (cap, max_ori) bool, desc_raw (cap, max_ori, 128) f32); slot (i, o)
    is keypoint i's o-th orientation, zeros where not ok.  ``reduce_mode``
    ("scalar" or "colsum") chooses how the TPU kernel sums a window's bins;
    both compute this function, which the one kernel here computes for
    either."""
    if reduce_mode not in REDUCE_MODES:
        raise ValueError(f"reduce_mode must be one of {REDUCE_MODES}, got {reduce_mode!r}")
    _check(mag, ori, (s_int, fr, fc, sigma, valid, row_off, oct_h, oct_w), win, max_ori)
    if not on_cuda(mag):
        return orient_desc_fused_ref(mag, ori, s_int, fr, fc, sigma, valid, win,
                                     max_ori, row_off, oct_h, oct_w)
    mag, ori = mag.contiguous(), ori.contiguous()
    S, rows, wmax = mag.shape
    n = fr.shape[0]
    dev = mag.device
    # no-ops for the main path's types (int32 plane indices and octave
    # geometry, f32 coordinates and sigma, a bool mask viewed as uint8), so
    # a call launches the kernel alone
    i32 = [t.to(torch.int32).contiguous() for t in (s_int, row_off, oct_h, oct_w)]
    f32 = [t.to(torch.float32).contiguous() for t in (fr, fc, sigma)]
    v8 = _build.as_bytes(valid)
    ang = torch.empty(n, max_ori, dtype=torch.float32, device=dev)
    ok = torch.empty(n, max_ori, dtype=torch.bool, device=dev)
    desc = torch.empty(n, max_ori, 128, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_orient_desc",
                         [vp, vp, ci, ci, ci] + [vp] * 8 + [ci, ci, vp, vp, vp, vp])
    p = _build.ptr
    with torch.cuda.device(dev):
        err = fn(p(mag), p(ori), int(rows), int(wmax), int(n), p(i32[0]), p(f32[0]),
                 p(f32[1]), p(v8), p(f32[2]), p(i32[1]), p(i32[2]), p(i32[3]), int(win),
                 int(max_ori), p(ang), p(ok), p(desc), _build.stream_of(mag))
    _build.check(err, "orient_desc_fused")
    orient_desc_fused.launches += 1
    return ang, ok, desc


orient_desc_fused.launches = 0


def _orientation_tail(hist: torch.Tensor, max_ori: int):
    """Smoothing, peak choice and parabolic interpolation of (n, 36)
    histograms: (angles (n, max_ori), ok (n, max_ori)), strongest peak
    first, ties to the lowest bin (as ``lax.top_k``)."""
    h = smooth_orientation_hist(hist)
    hmax = h.max(dim=1, keepdim=True).values
    left = torch.roll(h, 1, dims=1)
    right = torch.roll(h, -1, dims=1)
    is_peak = (h >= 0.8 * hmax) & (h > left) & (h > right) & (hmax > 0)
    ninf = torch.full_like(h, -torch.inf)
    score = torch.where(is_peak, h, ninf)
    angs, oks = [], []
    for _ in range(max_ori):
        m = score.max(dim=1, keepdim=True).values
        bsel = (score == m).to(torch.uint8).argmax(dim=1, keepdim=True)  # lowest bin
        l = left.gather(1, bsel)
        rg = right.gather(1, bsel)
        hh = h.gather(1, bsel)
        denom = l - 2.0 * hh + rg
        nz = denom != 0
        off = torch.where(nz, 0.5 * (l - rg) / torch.where(nz, denom, torch.ones_like(denom)),
                          torch.zeros_like(denom))
        ang = TWO_PI_F * (bsel.to(torch.float32) + 0.5 + off) / N_ORI_BINS - PI_F
        ang = torch.where(ang > PI_F, ang - TWO_PI_F, ang)
        ang = torch.where(ang <= -PI_F, ang + TWO_PI_F, ang)
        angs.append(ang)
        oks.append(torch.isfinite(m))
        score = score.scatter(1, bsel, -torch.inf)
    return torch.cat(angs, dim=1), torch.cat(oks, dim=1)


def _windows(mag, ori, plane, row0, rs, cs, oct_h, oct_w, win: int):
    """(m, win, win) windows of mag / ori (any strides) at origin (rs, cs)
    (m,) in octaves that start at row row0, column 0 of plane `plane` (m,)
    and are oct_h x oct_w; row0, oct_h, oct_w are ints or (m, 1) tensors.
    Zeros outside the octave."""
    ar = torch.arange(win, device=mag.device)
    r = rs.long()[:, None] + ar
    c = cs.long()[:, None] + ar
    in_r = (r >= 0) & (r < oct_h)
    in_c = (c >= 0) & (c < oct_w)
    rows = (row0 + torch.where(in_r, r, 0))[:, :, None]
    cols = torch.where(in_c, c, 0)[:, None, :]
    at = (plane.long()[:, None, None], rows, cols)
    inb = in_r[:, :, None] & in_c[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=mag.device)
    return torch.where(inb, mag[at], zero), torch.where(inb, ori[at], zero)


def _offsets(fro, fco, win: int):
    """Each window sample's row and column offset from its keypoint:
    (m, win, 1) and (m, 1, win)."""
    arf = torch.arange(win, dtype=torch.float32, device=fro.device)
    return arf[None, :, None] - fro[:, None, None], arf[None, None, :] - fco[:, None, None]


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor as exp2 in f64, rounded once to f32 (the
    correctly rounded value but for rare near-ties), so that the plain
    histograms have the same bits in every process.  PyTorch's exp on the
    CPU (f32 and f64) computed one worker thread's chunk of a process's
    first exp call at up to 1.5e-4 relative error in 10 of 240 processes;
    its exp2 and pow never did (``tests/test_torch_window_determinism.py``)."""
    return torch.exp2(x.to(torch.float64) * LOG2E).to(torch.float32)


def _orientation_hists(mw, ow, rr, cc, sig) -> torch.Tensor:
    """(m, 36) orientation histograms of (m, win, win) windows: weight
    exp(-d2 / (2 sw^2)) * mag with sw = 1.5 sigma inside d2 < floor(3 sw)^2
    + 0.5, as a scatter-add (on a card a one-hot sum).  sig: (m, 1, 1)."""
    m_ = mw.shape[0]
    d2 = rr * rr + cc * cc
    sig_w = 1.5 * sig
    radius = torch.floor(3.0 * sig_w)
    inside = d2 < radius * radius + 0.5
    w = _exp_f32(-d2 / (2.0 * sig_w * sig_w)) * mw * inside
    b = torch.floor(N_ORI_BINS * (ow + PI_F) / TWO_PI_F).long().clamp(0, N_ORI_BINS - 1)
    if mw.is_cuda:
        # scatter_add_ on a card adds with float atomics in no fixed order;
        # a one-hot sum has the same value in every run (and in a replay)
        bins = torch.arange(N_ORI_BINS, device=mw.device)
        return torch.where(b.reshape(m_, -1, 1) == bins, w.reshape(m_, -1, 1), 0.0).sum(1)
    hist = torch.zeros(m_, N_ORI_BINS, dtype=torch.float32, device=mw.device)
    return hist.scatter_add_(1, b.reshape(m_, -1), w.reshape(m_, -1))


def _descriptor_hists(mw, ow, rr, cc, sig, angle) -> torch.Tensor:
    """(m, 128) raw descriptors of (m, win, win) windows at `angle`
    (m, 1, 1): the R(+angle) frame, trilinear weights and a Gaussian of
    sigma = DESC_GRID / 2, the separable weights contracted as a batched
    matmul (as ``compute_descriptors`` of the JAX package)."""
    m_ = mw.shape[0]
    grid4 = torch.arange(DESC_GRID, dtype=torch.float32, device=mw.device)
    grid8 = torch.arange(DESC_ORI, dtype=torch.float32, device=mw.device)
    spacing = MAG_FACTOR * sig
    cos_t, sin_t = torch.cos(angle), torch.sin(angle)
    rrot = (cos_t * rr - sin_t * cc) / spacing
    crot = (sin_t * rr + cos_t * cc) / spacing
    rbin = rrot + (DESC_GRID / 2.0 - 0.5)
    cbin = crot + (DESC_GRID / 2.0 - 0.5)
    inside = (rbin > -1.0) & (rbin < DESC_GRID) & (cbin > -1.0) & (cbin < DESC_GRID)
    gw = _exp_f32(-(rrot * rrot + crot * crot) / (2.0 * (0.5 * DESC_GRID) ** 2))
    mm = gw * mw * inside
    obin = (ow - angle) * ORI_SCALE
    obin = obin - torch.floor(obin / DESC_ORI) * DESC_ORI
    wr = torch.clamp(1.0 - torch.abs(rbin.reshape(m_, -1, 1) - grid4), min=0.0)
    wc = torch.clamp(1.0 - torch.abs(cbin.reshape(m_, -1, 1) - grid4), min=0.0)
    do = torch.abs(obin.reshape(m_, -1, 1) - grid8)
    do = torch.minimum(do, DESC_ORI - do)
    wo = torch.clamp(1.0 - do, min=0.0)
    A = (wr[:, :, :, None] * wc[:, :, None, :]).reshape(m_, -1, DESC_GRID * DESC_GRID)
    B = mm.reshape(m_, -1, 1) * wo
    return torch.bmm(A.transpose(1, 2), B).reshape(m_, 128)


def _valid_chunks(valid: torch.Tensor, chunk: int):
    """The valid slots' indices, `chunk` at a time (bounds the memory of the
    dense window tensors), as (slots read, rows written).  On the CPU only
    the valid slots' chunks, which read and write the same rows.  On a card,
    with no host sync and a static loop (a CUDA graph can hold it), the
    valid slots compacted first in the same order and every slot's chunk
    taken: padding entries read slot 0 and write the spare row n, so the
    callers' outputs have n + 1 rows (the last dropped)."""
    v = valid.bool()
    n = v.shape[0]
    if not v.is_cuda:
        todo = torch.nonzero(v).squeeze(1)
        for k0 in range(0, todo.numel(), chunk):
            yield todo[k0 : k0 + chunk], todo[k0 : k0 + chunk]
        return
    idx, ok, _ = nonzero_first(v, n)
    write = torch.where(ok, idx, n)
    for k0 in range(0, n, chunk):
        yield idx[k0 : k0 + chunk], write[k0 : k0 + chunk]


def orient_desc_fused_ref(mag: torch.Tensor, ori: torch.Tensor, s_int: torch.Tensor,
                          fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                          valid: torch.Tensor, win: int, max_ori: int,
                          row_off: torch.Tensor, oct_h: torch.Tensor,
                          oct_w: torch.Tensor, chunk: int = 256) -> Fused:
    """Plain PyTorch version of ``orient_desc_fused``: the orientation
    histograms, ``_orientation_tail`` and one descriptor per angle, each as
    in the plain versions of K11a and K11b, on one window per keypoint;
    sums are taken in another order than the kernel's."""
    _check(mag, ori, (s_int, fr, fc, sigma, valid, row_off, oct_h, oct_w), win, max_ori)
    dev = mag.device
    n = fr.shape[0]
    ang_out = torch.zeros(n + 1, max_ori, dtype=torch.float32, device=dev)
    ok_out = torch.zeros(n + 1, max_ori, dtype=torch.bool, device=dev)
    desc_out = torch.zeros(n + 1, max_ori, 128, dtype=torch.float32, device=dev)
    rs, cs, fro, fco = window_origin(fr.float(), fc.float(), win)
    for ks, kw in _valid_chunks(valid, chunk):
        mw, ow = _windows(mag, ori, s_int[ks] - 1, row_off[ks, None].long(), rs[ks], cs[ks],
                          oct_h[ks, None], oct_w[ks, None], win)
        rr, cc = _offsets(fro[ks], fco[ks], win)
        sig = sigma[ks].to(torch.float32)[:, None, None]
        ang, ok = _orientation_tail(_orientation_hists(mw, ow, rr, cc, sig), max_ori)
        ang_out[kw] = ang
        ok_out[kw] = ok
        for o in range(max_ori):
            d = _descriptor_hists(mw, ow, rr, cc, sig, ang[:, o, None, None])
            desc_out[kw, o] = torch.where(ok[:, o, None], d, torch.zeros_like(d))
    return ang_out[:n], ok_out[:n], desc_out[:n]


def _octave_view(mag_p: torch.Tensor, ori_p: torch.Tensor):
    """The octave inside zero-padded (S, H + 2 PAD_R, W + 2 PAD_C) planes:
    (S, H, W) views of it, and (H, W)."""
    if mag_p.shape != ori_p.shape or mag_p.ndim != 3 or mag_p.dtype != torch.float32:
        raise ValueError("mag_p/ori_p must be matching (S, H + 160, W + 512) float32 planes")
    H, W = mag_p.shape[1] - 2 * PAD_R, mag_p.shape[2] - 2 * PAD_C
    if H < 1 or W < 1:
        raise ValueError(f"planes {tuple(mag_p.shape)} are smaller than their padding")
    return (mag_p[:, PAD_R : PAD_R + H, PAD_C : PAD_C + W],
            ori_p[:, PAD_R : PAD_R + H, PAD_C : PAD_C + W], H, W)


def _plane_hists(mags, oris, s_int, fr, fc, valid, win: int, nbins: int, chunk: int,
                 hists) -> torch.Tensor:
    """The common part of K11a's and K11b's plain versions: each valid
    slot's window of an octave's (S, H, W) planes (any strides),
    ``hists(ks, mw, ow, rr, cc)`` making their (m, nbins) rows; zeros for
    invalid slots."""
    H, W = mags.shape[1], mags.shape[2]
    n = fr.shape[0]
    out = torch.zeros(n + 1, nbins, dtype=torch.float32, device=mags.device)
    rs, cs, fro, fco = window_origin(fr.float(), fc.float(), win)
    for ks, kw in _valid_chunks(valid, chunk):
        mw, ow = _windows(mags, oris, s_int[ks] - 1, 0, rs[ks], cs[ks], H, W, win)
        out[kw] = hists(ks, mw, ow, *_offsets(fro[ks], fco[ks], win))
    return out[:n]


def orientation_hist_planes(mags: torch.Tensor, oris: torch.Tensor, s_int: torch.Tensor,
                            fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                            valid: torch.Tensor, win: int, chunk: int = 256) -> torch.Tensor:
    """K11a's plain arithmetic on an octave's unpadded (S, H, W) gradient
    planes: (n, 36) f32 histograms, zeros for invalid slots."""
    return _plane_hists(mags, oris, s_int, fr, fc, valid, win, N_ORI_BINS, chunk,
                        lambda ks, mw, ow, rr, cc: _orientation_hists(
                            mw, ow, rr, cc, sigma[ks].float()[:, None, None]))


def descriptor_hist_planes(mags: torch.Tensor, oris: torch.Tensor, s_int: torch.Tensor,
                           fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                           angle: torch.Tensor, valid: torch.Tensor, win: int,
                           chunk: int = 256) -> torch.Tensor:
    """K11b's plain arithmetic on an octave's unpadded (S, H, W) gradient
    planes: (n, 128) raw f32 descriptors, zeros for invalid slots."""
    return _plane_hists(mags, oris, s_int, fr, fc, valid, win, 128, chunk,
                        lambda ks, mw, ow, rr, cc: _descriptor_hists(
                            mw, ow, rr, cc, sigma[ks].float()[:, None, None],
                            angle[ks].float()[:, None, None]))


def _check_slots(mag_p, arrays, win: int) -> None:
    n = arrays[0].shape[0]
    for t in arrays:
        if t.shape != (n,) or t.device != mag_p.device:
            raise ValueError("per-keypoint arrays must be (n,) on the planes' device")
    if win < 1:
        raise ValueError("need win >= 1")


def _launch_hist(name, mag_p, ori_p, s_int, floats, valid, win: int, nbins: int):
    """One launch of K11a or K11b (C entry `name`) over padded planes, after
    one validation of the planes and the slot arrays: (n, nbins) f32.  The
    kernel computes each window's origin itself (``window_origin``), and
    the casts are no-ops for the slot arrays' own types (int32 s_int, f32
    coordinates, sigma and angle, a bool mask viewed as bytes), so the call
    is that one launch."""
    _check_slots(mag_p, (s_int, *floats, valid), win)
    mag, ori, H, W = _octave_view(mag_p.contiguous(), ori_p.contiguous())
    n = s_int.shape[0]
    slots = [s_int.to(torch.int32).contiguous()]
    slots += [t.to(torch.float32).contiguous() for t in floats]
    slots.append(_build.as_bytes(valid))
    out = torch.empty(n, nbins, dtype=torch.float32, device=mag.device)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.function(name, [vp, vp, ll, ll, ci, ci, ci] + [vp] * len(slots) + [ci, vp, vp])
    p = _build.ptr
    with torch.cuda.device(mag.device):
        err = fn(p(mag), p(ori), mag.stride(0), mag.stride(1), H, W, n, *map(p, slots),
                 int(win), p(out), _build.stream_of(mag))
    _build.check(err, name)
    return out


def orientation_hist(mag_p: torch.Tensor, ori_p: torch.Tensor, s_int: torch.Tensor,
                     fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                     valid: torch.Tensor, win: int) -> torch.Tensor:
    """K11a: the raw 36-bin orientation histogram of each keypoint slot, over
    a win x win window of its octave's padded gradient planes (``mag_p`` /
    ``ori_p``: ``pad_grad_planes`` output).  Returns (n, 36) f32, zeros for
    invalid slots."""
    if not on_cuda(mag_p):
        return orientation_hist_ref(mag_p, ori_p, s_int, fr, fc, sigma, valid, win)
    out = _launch_hist("sift_orientation_hist", mag_p, ori_p, s_int, (fr, fc, sigma), valid,
                       win, N_ORI_BINS)
    orientation_hist.launches += 1
    return out


orientation_hist.launches = 0


def orientation_hist_ref(mag_p: torch.Tensor, ori_p: torch.Tensor, s_int: torch.Tensor,
                         fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                         valid: torch.Tensor, win: int, chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch version of ``orientation_hist`` (a scatter-add
    histogram per keypoint; sums in another order than the kernel's)."""
    _check_slots(mag_p, (s_int, fr, fc, sigma, valid), win)
    mags, oris, _, _ = _octave_view(mag_p, ori_p)
    return orientation_hist_planes(mags, oris, s_int, fr, fc, sigma, valid, win, chunk)


def descriptor_hist(mag_p: torch.Tensor, ori_p: torch.Tensor, s_int: torch.Tensor,
                    fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                    angle: torch.Tensor, valid: torch.Tensor, win: int) -> torch.Tensor:
    """K11b: the raw (unnormalized) 128-bin descriptor of each keypoint slot
    at its ``angle``, over a win x win window of its octave's padded
    gradient planes.  Returns (n, 128) f32, zeros for invalid slots;
    ``ops.orient_desc.quantize_descriptors`` makes them u8."""
    if not on_cuda(mag_p):
        return descriptor_hist_ref(mag_p, ori_p, s_int, fr, fc, sigma, angle, valid, win)
    out = _launch_hist("sift_descriptor_hist", mag_p, ori_p, s_int, (fr, fc, sigma, angle),
                       valid, win, 128)
    descriptor_hist.launches += 1
    return out


descriptor_hist.launches = 0


def descriptor_hist_ref(mag_p: torch.Tensor, ori_p: torch.Tensor, s_int: torch.Tensor,
                        fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                        angle: torch.Tensor, valid: torch.Tensor, win: int,
                        chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch version of ``descriptor_hist`` (the separable trilinear
    weights as a batched matmul; sums in another order than the kernel's)."""
    _check_slots(mag_p, (s_int, fr, fc, sigma, angle, valid), win)
    mags, oris, _, _ = _octave_view(mag_p, ori_p)
    return descriptor_hist_planes(mags, oris, s_int, fr, fc, sigma, angle, valid, win, chunk)
