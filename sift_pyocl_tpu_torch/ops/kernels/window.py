"""K6: fused orientation assignment + raw descriptors per keypoint.

Port of ``sift_pyocl_tpu/ops/pallas/window.py::orient_desc_fused_pallas``;
the kernel is ``csrc/window.cu``.  Reads the gradient atlas of
``ops/kernels/gradpad.py``: keypoint i's octave starts at atlas row
``row_off[i]`` and is ``oct_h[i]`` x ``oct_w[i]``; window samples outside it
contribute 0.  The static window ``win`` may be any size (the TPU kernel's
``win <= 128`` was a lane limit).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build, on_cuda
from ...oracle import DESC_GRID, DESC_ORI, MAG_FACTOR, N_ORI_BINS

PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2 * np.pi))
ORI_SCALE = float(np.float32(DESC_ORI / (2 * np.pi)))
MAX_ORI = 8

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


def _check(mag, ori, arrays, win, max_ori) -> None:
    if mag.shape != ori.shape or mag.ndim != 3 or mag.dtype != torch.float32:
        raise ValueError("mag/ori must be matching (S, rows, wmax) float32 atlases")
    n = arrays[0].shape[0]
    for t in arrays:
        if t.shape != (n,) or t.device != mag.device:
            raise ValueError("per-keypoint arrays must be (cap,) on the atlas's device")
    if not 1 <= max_ori <= MAX_ORI or win < 1:
        raise ValueError(f"need 1 <= max_ori <= {MAX_ORI} and win >= 1")


def orient_desc_fused(mag: torch.Tensor, ori: torch.Tensor, s_int: torch.Tensor,
                      fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                      valid: torch.Tensor, win: int, max_ori: int,
                      row_off: torch.Tensor, oct_h: torch.Tensor,
                      oct_w: torch.Tensor) -> Fused:
    """Orientations and raw descriptors of every keypoint slot in one launch.

    fr/fc are octave-local.  Returns (angles (cap, max_ori) f32,
    ok (cap, max_ori) bool, desc_raw (cap, max_ori, 128) f32); slot (i, o)
    is keypoint i's o-th orientation, zeros where not ok."""
    _check(mag, ori, (s_int, fr, fc, sigma, valid, row_off, oct_h, oct_w), win, max_ori)
    if not on_cuda(mag):
        return orient_desc_fused_ref(mag, ori, s_int, fr, fc, sigma, valid, win,
                                     max_ori, row_off, oct_h, oct_w)
    mag, ori = mag.contiguous(), ori.contiguous()
    S, rows, wmax = mag.shape
    n = fr.shape[0]
    dev = mag.device
    rs, cs, fro, fco = window_origin(fr.float(), fc.float(), win)
    i32 = [t.to(torch.int32).contiguous()
           for t in (s_int - 1, rs, cs, row_off, oct_h, oct_w)]
    f32 = [t.to(torch.float32).contiguous() for t in (fro, fco, sigma)]
    v8 = valid.to(torch.uint8).contiguous()
    ang = torch.empty(n, max_ori, dtype=torch.float32, device=dev)
    ok = torch.empty(n, max_ori, dtype=torch.bool, device=dev)
    desc = torch.empty(n, max_ori, 128, dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("sift_orient_desc",
                         [vp, vp, ci, ci, ci] + [vp] * 10 + [ci, ci, vp, vp, vp, vp])
    p = _build.ptr
    with torch.cuda.device(dev):
        err = fn(p(mag), p(ori), int(rows), int(wmax), int(n), p(i32[0]), p(i32[1]),
                 p(i32[2]), p(v8), p(f32[0]), p(f32[1]), p(f32[2]), p(i32[3]),
                 p(i32[4]), p(i32[5]), int(win), int(max_ori), p(ang), p(ok), p(desc),
                 _build.stream_of(mag))
    _build.check(err, "orient_desc_fused")
    orient_desc_fused.launches += 1
    return ang, ok, desc


orient_desc_fused.launches = 0


def _orientation_tail(hist: torch.Tensor, max_ori: int):
    """Smoothing, peak choice and parabolic interpolation of (n, 36) histograms."""
    h = hist
    for _ in range(6):
        h = (torch.roll(h, 1, dims=1) + h + torch.roll(h, -1, dims=1)) / 3.0
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


def orient_desc_fused_ref(mag: torch.Tensor, ori: torch.Tensor, s_int: torch.Tensor,
                          fr: torch.Tensor, fc: torch.Tensor, sigma: torch.Tensor,
                          valid: torch.Tensor, win: int, max_ori: int,
                          row_off: torch.Tensor, oct_h: torch.Tensor,
                          oct_w: torch.Tensor, chunk: int = 256) -> Fused:
    """Plain PyTorch version of ``orient_desc_fused`` (dense window tensors,
    a scatter-add histogram and the separable trilinear descriptor as a
    batched matmul, as in ``ops/orient_desc.py::compute_descriptors`` of the
    JAX package); sums are taken in another order than the kernel's."""
    _check(mag, ori, (s_int, fr, fc, sigma, valid, row_off, oct_h, oct_w), win, max_ori)
    dev = mag.device
    S, rows, wmax = mag.shape
    n = fr.shape[0]
    ang_out = torch.zeros(n, max_ori, dtype=torch.float32, device=dev)
    ok_out = torch.zeros(n, max_ori, dtype=torch.bool, device=dev)
    desc_out = torch.zeros(n, max_ori, 128, dtype=torch.float32, device=dev)
    rs, cs, fro, fco = window_origin(fr.float(), fc.float(), win)
    ar = torch.arange(win, device=dev)
    arf = ar.to(torch.float32)
    grid4 = torch.arange(DESC_GRID, dtype=torch.float32, device=dev)
    grid8 = torch.arange(DESC_ORI, dtype=torch.float32, device=dev)
    mag_flat, ori_flat = mag.reshape(-1), ori.reshape(-1)
    todo = torch.nonzero(valid.bool()).squeeze(1)
    for k0 in range(0, todo.numel(), chunk):
        ks = todo[k0 : k0 + chunk]
        m_ = ks.numel()
        rows_k = rs[ks, None].long() + ar                              # (m, win)
        cols_k = cs[ks, None].long() + ar
        in_r = (rows_k >= 0) & (rows_k < oct_h[ks, None])
        in_c = (cols_k >= 0) & (cols_k < oct_w[ks, None])
        inb = in_r[:, :, None] & in_c[:, None, :]                      # (m, win, win)
        base = ((s_int[ks].long() - 1) * rows + row_off[ks].long())[:, None, None]
        flat = ((base + rows_k.clamp(min=0)[:, :, None]) * wmax
                + cols_k.clamp(min=0)[:, None, :]).clamp(max=mag_flat.numel() - 1)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mw = torch.where(inb, mag_flat[flat], zero)
        ow = torch.where(inb, ori_flat[flat], zero)
        rr = arf[None, :, None] - fro[ks, None, None]                  # (m, win, 1)
        cc = arf[None, None, :] - fco[ks, None, None]                  # (m, 1, win)
        sig = sigma[ks].to(torch.float32)[:, None, None]

        d2 = rr * rr + cc * cc
        sig_w = 1.5 * sig
        radius = torch.floor(3.0 * sig_w)
        inside = d2 < radius * radius + 0.5
        w = torch.exp(-d2 / (2.0 * sig_w * sig_w)) * mw * inside
        b = torch.floor(N_ORI_BINS * (ow + PI_F) / TWO_PI_F).long().clamp(0, N_ORI_BINS - 1)
        hist = torch.zeros(m_, N_ORI_BINS, dtype=torch.float32, device=dev)
        hist.scatter_add_(1, b.reshape(m_, -1), w.reshape(m_, -1))
        ang, ok = _orientation_tail(hist, max_ori)
        ang_out[ks] = ang
        ok_out[ks] = ok

        spacing = MAG_FACTOR * sig
        for o in range(max_ori):
            angle = ang[:, o, None, None]
            cos_t, sin_t = torch.cos(angle), torch.sin(angle)
            rrot = (cos_t * rr - sin_t * cc) / spacing
            crot = (sin_t * rr + cos_t * cc) / spacing
            rbin = rrot + (DESC_GRID / 2.0 - 0.5)
            cbin = crot + (DESC_GRID / 2.0 - 0.5)
            inside_d = (rbin > -1.0) & (rbin < DESC_GRID) & (cbin > -1.0) & (cbin < DESC_GRID)
            gw = torch.exp(-(rrot * rrot + crot * crot) / (2.0 * (0.5 * DESC_GRID) ** 2))
            mm = gw * mw * inside_d
            obin = (ow - angle) * ORI_SCALE
            obin = obin - torch.floor(obin / DESC_ORI) * DESC_ORI
            wr = torch.clamp(1.0 - torch.abs(rbin.reshape(m_, -1, 1) - grid4), min=0.0)
            wc = torch.clamp(1.0 - torch.abs(cbin.reshape(m_, -1, 1) - grid4), min=0.0)
            do = torch.abs(obin.reshape(m_, -1, 1) - grid8)
            do = torch.minimum(do, DESC_ORI - do)
            wo = torch.clamp(1.0 - do, min=0.0)
            A = (wr[:, :, :, None] * wc[:, :, None, :]).reshape(m_, -1, DESC_GRID * DESC_GRID)
            B = mm.reshape(m_, -1, 1) * wo
            d = torch.bmm(A.transpose(1, 2), B).reshape(m_, 128)
            desc_out[ks, o] = torch.where(ok[:, o, None], d, torch.zeros_like(d))
    return ang_out, ok_out, desc_out
