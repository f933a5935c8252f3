"""K6's support boxes (``ops/kernels/window.py::support_boxes``), on the CPU.

The CUDA kernel of K6 walks, for each keypoint, only the box of its
orientation circle and, at each angle, the boxes of the 25 descriptor quads
(the samples whose (floor(rbin), floor(cbin)) is one quad); K11a and K11b
walk the same boxes on their own windows (48 and 104 at ``SiftConfig()``).
These tests show with the plain arithmetic of ``_orientation_hists`` and
``_descriptor_hists`` (f32, as there) that every sample where the plain
``inside`` test holds lies in its box, whatever the magnitudes, and that
the plain K6, K11a and K11b on planes zeroed outside the boxes give the
same bits.
"""

import math

import numpy as np
import pytest
import torch

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.oracle import DESC_GRID, MAG_FACTOR
from sift_pyocl_tpu_torch.ops.kernels.window import (N_QUADS, _offsets, box_samples,
                                                     descriptor_hist_ref, orient_desc_fused_ref,
                                                     orientation_hist_ref, support_boxes,
                                                     window_origin)
from sift_pyocl_tpu_torch.ops.orient_desc import (PAD_C, PAD_R, _desc_window_size,
                                                  _ori_window_size, pad_grad_planes)
from _torch_threads import _one_torch_thread  # noqa: F401

WINDOWS = [16, 48, 80, 104, 136]   # 48 and 104: K11a's and K11b's at SiftConfig()
SIGMAS = [0.5, 1.3, 2.5, 4.53, 6.0]
ANGLES = [math.pi, -math.pi, 0.0] + [k * math.pi / 4 for k in (-3, -2, -1, 1, 2, 3)]
OCT = (61, 93)   # octave rows, columns


def _keypoints(sigma: float, seed: int, n: int = 48):
    """n keypoints in an OCT octave: a third near its corners and edges (the
    octave clips their boxes), the rest anywhere, subpixel offsets random;
    sigma jittered by up to 10 %, angles ANGLES then random."""
    rng = np.random.default_rng(seed)
    h, w = OCT
    fr = rng.uniform(-0.5, h - 0.5, n)
    fc = rng.uniform(-0.5, w - 0.5, n)
    edge = n // 3
    fr[:edge] = rng.choice([-0.49, 0.3, h - 1.2, h - 0.51], edge) + rng.uniform(-0.01, 0.01, edge)
    fc[:edge] = rng.choice([-0.49, 0.7, w - 1.4, w - 0.51], edge) + rng.uniform(-0.01, 0.01, edge)
    sig = sigma * rng.uniform(0.9, 1.1, n)
    ang = np.concatenate([ANGLES, rng.uniform(-math.pi, math.pi, n)])[:n]
    as_t = lambda a: torch.from_numpy(a.astype(np.float32))
    return as_t(fr), as_t(fc), as_t(sig), as_t(ang)


def _in_octave(fr, fc, win: int):
    """(n, win, win): whether each window sample lies inside the octave."""
    rs, cs, _, _ = window_origin(fr, fc, win)
    ar = torch.arange(win)
    r = rs.long()[:, None] + ar
    c = cs.long()[:, None] + ar
    return (((r >= 0) & (r < OCT[0]))[:, :, None] & ((c >= 0) & (c < OCT[1]))[:, None, :])


def _in_box(boxes, win: int):
    """(n, win, win): whether each window sample lies in its row of (n, 4)
    boxes."""
    ar = torch.arange(win)
    rows = (ar >= boxes[:, 0, None]) & (ar < boxes[:, 1, None])
    cols = (ar >= boxes[:, 2, None]) & (ar < boxes[:, 3, None])
    return rows[:, :, None] & cols[:, None, :]


@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_orientation_box_covers_the_circle(win, sigma):
    """Every sample of the window and the octave with d2 < floor(3 sw)^2 +
    0.5 (``_orientation_hists``) lies in the orientation box."""
    fr, fc, sig, _ = _keypoints(sigma, seed=int(100 * sigma) + win)
    _, _, fro, fco = window_origin(fr, fc, win)
    rr, cc = _offsets(fro, fco, win)
    s = sig[:, None, None]
    d2 = rr * rr + cc * cc
    radius = torch.floor(3.0 * (1.5 * s))
    inside = (d2 < radius * radius + 0.5) & _in_octave(fr, fc, win)
    boxes = support_boxes(fr, fc, sig, win, *OCT)
    box = _in_box(boxes, win)
    assert not bool((inside & ~box).any())
    # and the box holds no sample outside the window or the octave
    assert not bool((box & ~_in_octave(fr, fc, win)).any())
    assert int(inside.sum()) > 0


@pytest.mark.parametrize("win", WINDOWS)
@pytest.mark.parametrize("sigma", SIGMAS)
def test_descriptor_quad_boxes_cover_the_square(win, sigma):
    """Every sample of the window and the octave with -1 < rbin, cbin < 4
    (``_descriptor_hists``, f32) lies in the box of its quad (floor(rbin),
    floor(cbin)), at every angle; the quads' boxes are the kernel's only
    descriptor samples."""
    fr, fc, sig, ang = _keypoints(sigma, seed=int(10 * sigma) + 7 * win)
    _, _, fro, fco = window_origin(fr, fc, win)
    rr, cc = _offsets(fro, fco, win)
    s, a = sig[:, None, None], ang[:, None, None]
    spacing = MAG_FACTOR * s
    cos_t, sin_t = torch.cos(a), torch.sin(a)
    rrot = (cos_t * rr - sin_t * cc) / spacing
    crot = (sin_t * rr + cos_t * cc) / spacing
    rbin = rrot + (DESC_GRID / 2.0 - 0.5)
    cbin = crot + (DESC_GRID / 2.0 - 0.5)
    inside = ((rbin > -1.0) & (rbin < DESC_GRID) & (cbin > -1.0) & (cbin < DESC_GRID)
              & _in_octave(fr, fc, win))
    quad = ((torch.floor(rbin).long() + 1) * (DESC_GRID + 1)
            + torch.floor(cbin).long() + 1).clamp(0, N_QUADS - 1)
    boxes = support_boxes(fr, fc, sig, win, *OCT, angle=ang)
    assert boxes.shape == (fr.shape[0], N_QUADS, 4)
    ar = torch.arange(win)
    b = boxes.gather(1, quad.reshape(fr.shape[0], -1, 1).expand(-1, -1, 4))
    b = b.reshape(fr.shape[0], win, win, 4)
    in_box = ((ar[None, :, None] >= b[..., 0]) & (ar[None, :, None] < b[..., 1])
              & (ar[None, None, :] >= b[..., 2]) & (ar[None, None, :] < b[..., 3]))
    assert not bool((inside & ~in_box).any())
    assert int(inside.sum()) > 0
    # the quads together hold at most 25 x (3 sigma sqrt 2 + 3)^2 samples
    bound = N_QUADS * (3 * 1.1 * sigma * math.sqrt(2) + 3) ** 2
    assert int(box_samples(boxes).sum(1).max()) <= bound


def test_plain_k6_ignores_samples_outside_the_boxes():
    """The plain K6 on an atlas whose magnitudes and orientations are zeroed
    outside a keypoint's orientation box and its quad boxes at its angles
    equals, bit for bit, the plain K6 on the full atlas."""
    rng = np.random.default_rng(5)
    S, win, max_ori = 3, 104, 2
    rows = OCT[0] + 40                        # the octave starts at atlas row 40
    mag = torch.from_numpy(rng.gamma(2.0, 3.0, (S, rows, OCT[1])).astype(np.float32))
    ori = torch.from_numpy(rng.uniform(-math.pi, math.pi, (S, rows, OCT[1])).astype(np.float32))
    fr, fc, sig, _ = _keypoints(2.8, seed=9, n=6)
    n = fr.shape[0]
    s_int = torch.from_numpy(rng.integers(1, S + 1, n).astype(np.int32))
    geom = (torch.full((n,), 40, dtype=torch.int32), torch.full((n,), OCT[0], dtype=torch.int32),
            torch.full((n,), OCT[1], dtype=torch.int32))
    rs, cs, _, _ = window_origin(fr, fc, win)
    for k in range(n):
        valid = torch.zeros(n, dtype=torch.bool)
        valid[k] = True
        args = (s_int, fr, fc, sig, valid, win, max_ori, *geom)
        want = orient_desc_fused_ref(mag, ori, *args)
        keep = _in_box(support_boxes(fr[k:k + 1], fc[k:k + 1], sig[k:k + 1], win, *OCT), win)[0]
        ok = want[1][k]
        assert bool(ok[0])
        for o in range(max_ori):
            if bool(ok[o]):
                quads = support_boxes(fr[k:k + 1], fc[k:k + 1], sig[k:k + 1], win, *OCT,
                                      angle=want[0][k, o:o + 1])[0]
                keep |= _in_box(quads, win).any(0)
        # the window's samples in atlas coordinates (inside the octave)
        r = rs[k].long() + torch.arange(win)
        c = cs[k].long() + torch.arange(win)
        in_oct = ((r >= 0) & (r < OCT[0]))[:, None] & ((c >= 0) & (c < OCT[1]))[None, :]
        assert not bool((keep & ~in_oct).any())
        plane = int(s_int[k]) - 1
        mask = torch.zeros(rows, OCT[1], dtype=torch.bool)
        rr, cc = torch.meshgrid(r, c, indexing="ij")
        mask[40 + rr[keep], cc[keep]] = True
        mag_z, ori_z = mag.clone(), ori.clone()
        mag_z[plane][~mask] = 0.0
        ori_z[plane][~mask] = 0.0
        got = orient_desc_fused_ref(mag_z, ori_z, *args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert float(mag_z[plane].abs().sum()) < float(mag[plane].abs().sum())


@pytest.mark.parametrize("kernel", ["orientation_hist", "descriptor_hist"])
def test_plain_k11_ignores_samples_outside_the_boxes(kernel):
    """The plain K11a (K11b) on padded planes whose magnitudes and
    orientations are zeroed outside one slot's orientation box (its quad
    boxes at its angle), on SiftConfig()'s window, equals, bit for bit, the
    plain K11a (K11b) on the full planes; one slot valid at a time."""
    rng = np.random.default_rng(11)
    S = 3
    mags = torch.from_numpy(rng.gamma(2.0, 3.0, (S,) + OCT).astype(np.float32))
    oris = torch.from_numpy(rng.uniform(-math.pi, math.pi, (S,) + OCT).astype(np.float32))
    mag_p, ori_p = pad_grad_planes(mags, oris)
    fr, fc, sig, ang = _keypoints(2.8, seed=13, n=8)
    n = fr.shape[0]
    s_int = torch.from_numpy(rng.integers(1, S + 1, n).astype(np.int32))
    cfg = SiftConfig()
    if kernel == "orientation_hist":
        win = _ori_window_size(cfg)
        assert win == 48
        run = lambda mp, op, v: orientation_hist_ref(mp, op, s_int, fr, fc, sig, v, win)
    else:
        win = _desc_window_size(cfg)
        assert win == 104
        run = lambda mp, op, v: descriptor_hist_ref(mp, op, s_int, fr, fc, sig, ang, v, win)
    rs, cs, _, _ = window_origin(fr, fc, win)
    for k in range(n):
        valid = torch.zeros(n, dtype=torch.bool)
        valid[k] = True
        want = run(mag_p, ori_p, valid)
        assert bool(want[k].any())
        one = (fr[k:k + 1], fc[k:k + 1], sig[k:k + 1], win, *OCT)
        if kernel == "orientation_hist":
            keep = _in_box(support_boxes(*one), win)[0]
        else:
            keep = _in_box(support_boxes(*one, angle=ang[k:k + 1])[0], win).any(0)
        r = rs[k].long() + torch.arange(win)
        c = cs[k].long() + torch.arange(win)
        rr, cc = torch.meshgrid(r, c, indexing="ij")
        mask = torch.zeros(mag_p.shape[1:], dtype=torch.bool)
        mask[PAD_R + rr[keep], PAD_C + cc[keep]] = True
        plane = int(s_int[k]) - 1
        mag_z, ori_z = mag_p.clone(), ori_p.clone()
        mag_z[plane][~mask] = 0.0
        ori_z[plane][~mask] = 0.0
        assert float(mag_z[plane].abs().sum()) < float(mag_p[plane].abs().sum())
        assert torch.equal(run(mag_z, ori_z, valid), want)
