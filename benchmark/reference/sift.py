"""Plain PyTorch SIFT: the reference that the benchmark holds the port's
frontend to.

A frozen copy of the port's plain arithmetic (the plain pyramid, the
extrema stencil, ``compact_extrema`` and ``refine_candidates``, the
gradient planes and the plain orientation and descriptor histograms), laid
out as the port's kernel path lays out its keypoint buffer: per octave
``cap`` candidate slots in flat mask order, each repeated ``max_ori`` times
(slot ``i * max_ori + o`` holds candidate i's o-th orientation).  It
imports nothing of the port and takes nothing the port made.

``lower=True`` is the control: every image plane (the normalized input,
each blur level, each DoG, the gradient planes) is stored in bfloat16, the
precision below the float32 that the configuration states.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

N_ORI_BINS = 36
DESC_GRID = 4
DESC_ORI = 8
MAG_FACTOR = 3.0
PI_F = float(np.float32(np.pi))
TWO_PI_F = float(np.float32(2 * np.pi))
ORI_SCALE = float(np.float32(DESC_ORI / (2 * np.pi)))
LOG2E = 1.0 / math.log(2.0)


@dataclass(frozen=True)
class Params:
    """The published SIFT parameters a configuration file states."""

    double_im_size: bool = False
    init_sigma: float = 1.6
    border_dist: int = 5
    scales: int = 3
    peak_thresh: float = 255.0 * 0.04 / 3.0
    edge_thresh: float = 0.06
    edge_thresh1: float = 0.08
    orig_sigma: float = 0.5
    pix_per_kp: int = 10
    downsample_mode: str = "shrink"
    kp_per_octave_cap: int = 2048
    ori_window: int = 40
    desc_window: int = 80
    max_interp_moves: int = 5
    max_ori: int = 2
    min_octave_size: int = 13

    @classmethod
    def from_dict(cls, d: dict) -> "Params":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def n_octaves(self, shape) -> int:
        h, w = shape
        if self.double_im_size:
            h, w = 2 * h, 2 * w
        n = 0
        while min(h, w) > self.min_octave_size:
            n += 1
            h, w = h // 2, w // 2
        return max(n, 1)

    def increments(self) -> Tuple[float, ...]:
        lad = [self.init_sigma * 2.0 ** (s / self.scales) for s in range(self.scales + 3)]
        return tuple(math.sqrt(lad[s] ** 2 - lad[s - 1] ** 2) for s in range(1, len(lad)))


class Buffer(NamedTuple):
    """Fixed-capacity keypoints in the port's slot layout."""

    x: torch.Tensor
    y: torch.Tensor
    scale: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor     # (n, 128) uint8
    valid: torch.Tensor
    counts: torch.Tensor   # (n_octaves, 2) int32: refined, oriented


def octave_capacities(shape, p: Params) -> List[int]:
    """Candidate slots a octave: kp_per_octave_cap for octave 0, halved
    each octave down to 128, rounded up to 64."""
    h, w = shape
    if p.double_im_size:
        h, w = 2 * h, 2 * w
    caps, bound = [], p.kp_per_octave_cap
    for _ in range(p.n_octaves(shape)):
        cap = int(min(bound, max(h * w // p.pix_per_kp, 64)))
        caps.append((cap + 63) // 64 * 64)
        h, w = h // 2, w // 2
        bound = max(bound // 2, 128)
    return caps


def gaussian_kernel(sigma: float) -> np.ndarray:
    size = int(math.ceil(8.0 * sigma + 1.0))
    if size % 2 == 0:
        size += 1
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _store(x: torch.Tensor, lower: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if lower else x


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    img = img.to(torch.float32)
    lo, hi = img.min(), img.max()
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    return (img - lo) * scale


def _conv1d(img: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    half = (taps.numel() - 1) // 2
    x = img[None, None]
    if axis == 1:
        x = F.pad(x, (half, half, 0, 0), mode="replicate")
        k = taps.view(1, 1, 1, -1)
    else:
        x = F.pad(x, (0, 0, half, half), mode="replicate")
        k = taps.view(1, 1, -1, 1)
    return F.conv2d(x, k)[0, 0]


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    taps = torch.as_tensor(gaussian_kernel(sigma), device=img.device)
    return _conv1d(_conv1d(img, taps, 1), taps, 0)


def upscale2(img: torch.Tensor) -> torch.Tensor:
    def up(x, dim):
        n = x.shape[dim]
        nxt = torch.clamp(torch.arange(n, device=x.device) + 1, max=n - 1)
        mid = 0.5 * x + 0.5 * x.index_select(dim, nxt)
        return torch.stack([x, mid], dim=dim + 1).flatten(dim, dim + 1)

    return up(up(img, 0), 1)


def downsample(img: torch.Tensor, mode: str) -> torch.Tensor:
    if mode != "bin":
        return img[::2, ::2].contiguous()

    def pair(x, dim):
        if x.shape[dim] % 2:
            x = torch.cat([x, x.narrow(dim, x.shape[dim] - 1, 1)], dim=dim)
        x = x.movedim(dim, 0)
        return (0.5 * x[0::2] + 0.5 * x[1::2]).movedim(0, dim)

    return pair(pair(img, 0), 1).contiguous()


def scale_space(img: torch.Tensor, p: Params, lower: bool = False):
    """[(blurs (S+3, H, W), dogs (S+2, H, W))] for every octave."""
    data = _store(normalize_image(img), lower)
    if p.double_im_size:
        data = upscale2(data)
    cur = p.orig_sigma * (2.0 if p.double_im_size else 1.0)
    if p.init_sigma > cur:
        data = _store(blur(data, float(np.sqrt(p.init_sigma ** 2 - cur ** 2))), lower)
    octaves, base = [], data
    for o in range(p.n_octaves(tuple(img.shape[:2]))):
        if o:
            base = downsample(octaves[-1][0][p.scales], p.downsample_mode)
        levels = [base]
        for inc in p.increments():
            levels.append(_store(blur(levels[-1], inc), lower))
        stack = torch.stack(levels)
        octaves.append((stack, _store(stack[1:] - stack[:-1], lower)))
    return octaves


def extrema_mask(dogs: torch.Tensor, p: Params, octave: int) -> torch.Tensor:
    """Strict 26-neighbour extrema over 0.8 peak_thresh that pass the 2x2
    spatial-Hessian edge test, border stripped: (S, H-2bd, W-2bd)."""
    octsize = 2.0 ** (octave - 1) if p.double_im_size else 2.0 ** octave
    eth = p.edge_thresh1 if octsize <= 1.0 else p.edge_thresh
    bd = p.border_dist
    S, H, W = dogs.shape
    v = dogs[1:S - 1, bd:H - bd, bd:W - bd]
    strong = v.abs() > 0.8 * p.peak_thresh
    is_max = torch.ones_like(strong)
    is_min = torch.ones_like(strong)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if ds == 0 and dr == 0 and dc == 0:
                    continue
                nb = dogs[1 + ds:S - 1 + ds, bd + dr:H - bd + dr, bd + dc:W - bd + dc]
                is_max &= v > nb
                is_min &= v < nb
    d = dogs[1:S - 1]
    ctr = d[:, bd:H - bd, bd:W - bd]
    hxx = d[:, bd:H - bd, bd - 1:W - bd - 1] + d[:, bd:H - bd, bd + 1:W - bd + 1] - 2 * ctr
    hyy = d[:, bd - 1:H - bd - 1, bd:W - bd] + d[:, bd + 1:H - bd + 1, bd:W - bd] - 2 * ctr
    hxy = 0.25 * (d[:, bd + 1:H - bd + 1, bd + 1:W - bd + 1]
                  - d[:, bd + 1:H - bd + 1, bd - 1:W - bd - 1]
                  - d[:, bd - 1:H - bd - 1, bd + 1:W - bd + 1]
                  + d[:, bd - 1:H - bd - 1, bd - 1:W - bd - 1])
    det = hxx * hyy - hxy * hxy
    tr = hxx + hyy
    return strong & (is_max | is_min) & (det > 0) & (det >= eth * tr * tr)


def first_set(flags: torch.Tensor, size: int):
    """The first `size` set positions of 1-D `flags` in order (zeros past
    the count) and their validity."""
    f = flags.bool()
    rank = torch.cumsum(f, 0) - 1
    slot = torch.where(f & (rank < size), rank, size)
    idx = torch.zeros(size + 1, dtype=torch.long, device=f.device)
    idx.scatter_(0, slot, torch.arange(f.numel(), device=f.device))
    return idx[:size], torch.arange(size, device=f.device) < f.sum()


def _grad_hess(d):
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
    a, bb, cc, d, e, f = h
    det = a * (d * f - e * e) - bb * (bb * f - e * cc) + cc * (bb * e - d * cc)
    adj = ((d * f - e * e, cc * e - bb * f, bb * e - cc * d),
           (e * cc - bb * f, a * f - cc * cc, bb * cc - a * e),
           (bb * e - d * cc, cc * bb - a * e, a * d - bb * bb))
    ok = det.abs() > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    x = torch.stack([(row[0] * b[0] + row[1] * b[1]) + row[2] * b[2] for row in adj])
    return x / safe, ok


def detect(dogs: torch.Tensor, p: Params, octave: int, cap: int):
    """(s_int, fs, fr, fc, valid) of the first `cap` extrema, refined by up
    to max_interp_moves one-pixel moves and a final 3-D quadratic solve."""
    mask = extrema_mask(dogs, p, octave)
    _, Hm, Wm = mask.shape
    bd = p.border_dist
    idx, cvalid = first_set(mask.reshape(-1), cap)
    rem = idx % (Hm * Wm)
    s_int = (idx // (Hm * Wm) + 1).to(torch.int32)
    S, H, W = dogs.shape
    s = s_int.long()
    d3 = torch.arange(3, device=dogs.device)

    def gather_solve(r_, c_):
        s0 = (s - 1).clamp(0, S - 3)
        r0 = (r_ - 1).clamp(0, H - 3)
        c0 = (c_ - 1).clamp(0, W - 3)
        cube = dogs[(s0 + d3[:, None])[:, None, None, :], (r0 + d3[:, None])[None, :, None, :],
                    (c0 + d3[:, None])[None, None, :, :]]
        g, h = _grad_hess(cube)
        off, ok = _solve3(h, -g)
        return cube, g, off, ok

    r_, c_ = rem // Wm + bd, rem % Wm + bd
    for _ in range(p.max_interp_moves):
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
    accept = ok & (peak.abs() > p.peak_thresh) & (off.abs() <= 1.5).all(dim=0)
    return s_int, s.float() + off[0], r_.float() + off[1], c_.float() + off[2], accept & cvalid


def gradient(img: torch.Tensor):
    q = torch.cat([img[..., :1, :], img, img[..., -1:, :]], dim=-2)
    q = torch.cat([q[..., :1], q, q[..., -1:]], dim=-1)
    dx = q[..., 1:-1, 2:] - q[..., 1:-1, :-2]
    dy = q[..., 2:, 1:-1] - q[..., :-2, 1:-1]
    return 0.5 * torch.sqrt(dx * dx + dy * dy), torch.atan2(dy, dx)


def _desc_window(p: Params) -> int:
    sigma_max = p.init_sigma * 2.0 ** ((p.scales + 1.5) / p.scales)
    rad = math.sqrt(2.0) * MAG_FACTOR * sigma_max * (DESC_GRID + 1) / 2.0
    need = 2 * int(rad + 0.5) + 3
    return max(p.desc_window, (need + 7) // 8 * 8)


def _ori_window(p: Params) -> int:
    sigma_max = p.init_sigma * 2.0 ** ((p.scales + 1.5) / p.scales)
    need = 2 * int(4.5 * sigma_max) + 3
    return max(p.ori_window, (need + 7) // 8 * 8)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x.to(torch.float64) * LOG2E).to(torch.float32)


def _windows(mag, ori, plane, rs, cs, H, W, win):
    ar = torch.arange(win, device=mag.device)
    r = rs.long()[:, None] + ar
    c = cs.long()[:, None] + ar
    in_r = (r >= 0) & (r < H)
    in_c = (c >= 0) & (c < W)
    at = (plane.long()[:, None, None], torch.where(in_r, r, 0)[:, :, None],
          torch.where(in_c, c, 0)[:, None, :])
    inb = in_r[:, :, None] & in_c[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=mag.device)
    return torch.where(inb, mag[at], zero), torch.where(inb, ori[at], zero)


def _window_hists(mags, oris, s_int, fr, fc, valid, win, nbins, hists, chunk=256):
    """Each valid slot's win x win window of an octave's gradient planes,
    ``hists(ks, mw, ow, rr, cc)`` making its (m, nbins) rows."""
    H, W = mags.shape[1], mags.shape[2]
    out = torch.zeros(fr.shape[0], nbins, dtype=torch.float32, device=mags.device)
    half = win // 2
    rs = torch.round(fr).to(torch.int32) - half
    cs = torch.round(fc).to(torch.int32) - half
    fro, fco = fr - rs.float(), fc - cs.float()
    arf = torch.arange(win, dtype=torch.float32, device=fr.device)
    todo = torch.nonzero(valid).squeeze(1)
    for k0 in range(0, todo.numel(), chunk):
        ks = todo[k0:k0 + chunk]
        mw, ow = _windows(mags, oris, s_int[ks] - 1, rs[ks], cs[ks], H, W, win)
        rr = arf[None, :, None] - fro[ks][:, None, None]
        cc = arf[None, None, :] - fco[ks][:, None, None]
        out[ks] = hists(ks, mw, ow, rr, cc)
    return out


def _orientation_hists(mw, ow, rr, cc, sig):
    m_ = mw.shape[0]
    d2 = rr * rr + cc * cc
    sig_w = 1.5 * sig
    radius = torch.floor(3.0 * sig_w)
    w = _exp_f32(-d2 / (2.0 * sig_w * sig_w)) * mw * (d2 < radius * radius + 0.5)
    b = torch.floor(N_ORI_BINS * (ow + PI_F) / TWO_PI_F).long().clamp(0, N_ORI_BINS - 1)
    bins = torch.arange(N_ORI_BINS, device=mw.device)
    return torch.where(b.reshape(m_, -1, 1) == bins, w.reshape(m_, -1, 1), 0.0).sum(1)


def _descriptor_hists(mw, ow, rr, cc, sig, angle):
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
    wo = torch.clamp(1.0 - torch.minimum(do, DESC_ORI - do), min=0.0)
    A = (wr[:, :, :, None] * wc[:, :, None, :]).reshape(m_, -1, DESC_GRID * DESC_GRID)
    return torch.bmm(A.transpose(1, 2), mm.reshape(m_, -1, 1) * wo).reshape(m_, 128)


def _orientation_peaks(hist: torch.Tensor, max_ori: int):
    h = hist
    for _ in range(6):
        h = (torch.roll(h, 1, dims=-1) + h + torch.roll(h, -1, dims=-1)) / 3.0
    hmax = h.max(dim=1, keepdim=True).values
    left = torch.roll(h, 1, dims=1)
    right = torch.roll(h, -1, dims=1)
    is_peak = (h >= 0.8 * hmax) & (h > left) & (h > right) & (hmax > 0)
    score = torch.where(is_peak, h, torch.full_like(h, -torch.inf))
    angs, oks = [], []
    for _ in range(max_ori):
        m = score.max(dim=1, keepdim=True).values
        bsel = (score == m).to(torch.uint8).argmax(dim=1, keepdim=True)
        l, rg, hh = left.gather(1, bsel), right.gather(1, bsel), h.gather(1, bsel)
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


def quantize(raw: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(raw * raw, dim=-1, keepdim=True))
    v = torch.where(n > 0, raw / torch.where(n > 0, n, torch.ones_like(n)), raw)
    v = torch.clamp(v, max=0.2)
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    v = torch.where(n > 0, v / torch.where(n > 0, n, torch.ones_like(n)), v)
    return torch.clamp(512.0 * v, max=255.0).to(torch.uint8)


def detect_and_describe(img: torch.Tensor, p: Params, lower: bool = False) -> Buffer:
    """The frontend on one (H, W) image on its device."""
    caps = octave_capacities(tuple(img.shape[:2]), p)
    mo = p.max_ori
    parts = {f: [] for f in Buffer._fields}
    octsize = 0.5 if p.double_im_size else 1.0
    for o, (blurs, dogs) in enumerate(scale_space(img, p, lower)):
        cap = caps[o]
        s_int, fs, fr, fc, kvalid = detect(dogs, p, o, cap)
        mags, oris = gradient(blurs[1:p.scales + 1])
        mags, oris = _store(mags, lower), _store(oris, lower)
        sigma = p.init_sigma * 2.0 ** (fs / p.scales)
        sig3 = sigma[:, None, None]
        hist = _window_hists(mags, oris, s_int, fr, fc, kvalid, _ori_window(p), N_ORI_BINS,
                             lambda ks, mw, ow, rr, cc: _orientation_hists(
                                 mw, ow, rr, cc, sig3[ks]))
        ang, ok = _orientation_peaks(hist, mo)
        ok = ok & kvalid[:, None]
        raws = []
        for k in range(mo):
            a3 = ang[:, k, None, None]
            raws.append(_window_hists(mags, oris, s_int, fr, fc, ok[:, k], _desc_window(p), 128,
                                      lambda ks, mw, ow, rr, cc, a3=a3: _descriptor_hists(
                                          mw, ow, rr, cc, sig3[ks], a3[ks])))
        raw = torch.stack(raws, 1).reshape(cap * mo, 128)

        def rep(t):
            return torch.repeat_interleave(t, mo, dim=0)

        parts["x"].append(rep(fc * octsize))
        parts["y"].append(rep(fr * octsize))
        parts["scale"].append(rep(sigma * octsize))
        parts["angle"].append(ang.reshape(-1))
        parts["desc"].append(quantize(raw))
        parts["valid"].append(ok.reshape(-1))
        parts["counts"].append(torch.stack([kvalid.sum().to(torch.int32),
                                            ok.sum().to(torch.int32)]))
        octsize *= 2.0
    return Buffer(**{f: torch.stack(v) if f == "counts" else torch.cat(v)
                     for f, v in parts.items()})
