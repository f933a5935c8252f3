"""The numbers that decide ``correct``: what the timed path produced
against the plain reference (``benchmark/reference/``), on the same input.

Keypoints are compared as sets, since one extremum more or less near the
threshold moves every later slot of its octave: a reference keypoint is
found where a program keypoint lies within TOL_XY px (|dx| + |dy|) and,
where both carry them, TOL_SCALE in scale and TOL_ANGLE rad in angle.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

TOL_XY = 0.1
TOL_SCALE = 0.05
TOL_ANGLE = 0.05
CHUNK = 1024


def _pairs_ok(a: dict, b: dict, i0: int, i1: int) -> torch.Tensor:
    """(i1 - i0, len(b)) bool: a[i] and b[j] agree within the tolerances."""
    ok = ((a["x"][i0:i1, None] - b["x"][None, :]).abs()
          + (a["y"][i0:i1, None] - b["y"][None, :]).abs()) < TOL_XY
    if "scale" in a and "scale" in b:
        ok &= (a["scale"][i0:i1, None] - b["scale"][None, :]).abs() < TOL_SCALE
    if "angle" in a and "angle" in b:
        d = (a["angle"][i0:i1, None] - b["angle"][None, :]).abs()
        ok &= torch.minimum(d, 2 * math.pi - d) < TOL_ANGLE
    return ok


def valid_keypoints(buf: dict) -> dict:
    """The valid slots of a buffer (x, y, [scale, angle,] desc, valid)."""
    v = buf["valid"].bool()
    return {k: t[v].float() if k != "desc" else t[v].int()
            for k, t in buf.items() if k in ("x", "y", "scale", "angle", "desc")}


def keypoint_gaps(program: dict, reference: dict) -> Dict[str, float]:
    """missing: share of reference keypoints the program lacks; extra:
    share of program keypoints the reference lacks; desc_l1: mean absolute
    difference of the u8 descriptors of found pairs (the closest
    descriptor among the program keypoints that agree), inf where both
    sides have keypoints and no pair is found."""
    p, r = valid_keypoints(program), valid_keypoints(reference)
    n_r, n_p = r["x"].numel(), p["x"].numel()
    if n_r == 0 or n_p == 0:
        return {"missing": 1.0 if n_r else 0.0, "extra": 1.0 if n_p else 0.0, "desc_l1": 0.0}
    found = torch.zeros(n_r, dtype=torch.bool, device=r["x"].device)
    has = torch.zeros(n_p, dtype=torch.bool, device=p["x"].device)
    l1_sum, n_pairs = 0.0, 0
    for i0 in range(0, n_r, CHUNK):
        i1 = min(i0 + CHUNK, n_r)
        ok = _pairs_ok(r, p, i0, i1)
        found[i0:i1] = ok.any(1)
        has |= ok.any(0)
        rows = torch.nonzero(ok.any(1)).squeeze(1)
        for k0 in range(0, rows.numel(), 64):
            rk = rows[k0:k0 + 64]
            d = (r["desc"][i0 + rk][:, None, :] - p["desc"][None, :, :]).abs().float().mean(-1)
            d = torch.where(ok[rk], d, torch.inf).min(1).values
            l1_sum += float(d.sum())
            n_pairs += rk.numel()
    return {"missing": 1.0 - float(found.float().mean()),
            "extra": 1.0 - float(has.float().mean()),
            "desc_l1": l1_sum / n_pairs if n_pairs else math.inf}


def matched_scale(program: dict, reference: dict) -> torch.Tensor:
    """A scale for each slot of the program's buffer, which carries none:
    that of a valid reference keypoint within TOL_XY px of the slot's
    valid keypoint, else the reference's at the same slot."""
    scale = reference["scale"].clone()
    pv = torch.nonzero(program["valid"].bool()).squeeze(1)
    rv = torch.nonzero(reference["valid"].bool()).squeeze(1)
    if pv.numel() == 0 or rv.numel() == 0:
        return scale
    rx, ry = reference["x"][rv].float(), reference["y"][rv].float()
    for i0 in range(0, pv.numel(), CHUNK):
        rows = pv[i0:i0 + CHUNK]
        d = ((program["x"][rows].float()[:, None] - rx[None, :]).abs()
             + (program["y"][rows].float()[:, None] - ry[None, :]).abs())
        best, j = d.min(1)
        hit = best < TOL_XY
        scale[rows[hit]] = reference["scale"][rv[j[hit]]]
    return scale


def rotation_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angle in degrees between rotations, per leading index, from the
    chord ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2) (exact 0 for equal
    matrices, where the trace's arccos reads their rounding)."""
    chord = (Ra - Rb).flatten(-2).norm(dim=-1) / (2.0 * math.sqrt(2.0))
    return torch.rad2deg(2.0 * torch.asin(chord.clamp(max=1.0)))


def centres(Rs: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    return -(Rs.transpose(-1, -2) @ ts[..., None])[..., 0]


def pose_gaps(Rs_p, ts_p, Rs_r, ts_r) -> Dict[str, float]:
    """The worst rotation gap (deg) and camera-centre gap (map units) over
    the window's cameras."""
    Rs_p, ts_p, Rs_r, ts_r = (t.double() for t in (Rs_p, ts_p, Rs_r, ts_r))
    return {"rot_deg": float(rotation_deg(Rs_p, Rs_r).max()),
            "centre": float((centres(Rs_p, ts_p) - centres(Rs_r, ts_r)).norm(dim=-1).max())}


def reprojection_gap(K, Rs_p, ts_p, X_p, v_p, Rs_r, ts_r, X_r, v_r) -> float:
    """Where two windows put the map in the image, in px: for every camera
    of the window the median, over the points valid in both, of the
    distance between the program's projection (its pose, its point) and
    the reference's; the worst camera.  A projection is unchanged by the
    gauge, scale and rotation-translation ambiguities that leave a VO
    window's poses ill-determined, so this number is steady where the
    poses are not."""
    K = K.double()
    both = (v_p.reshape(-1) > 0) & (v_r.reshape(-1) > 0)
    if not bool(both.any()):
        return math.inf
    Xp, Xr = X_p.reshape(-1, 3)[both].double(), X_r.reshape(-1, 3)[both].double()
    worst = 0.0
    for k in range(Rs_p.shape[0]):
        cp = Xp @ Rs_p[k].double().T + ts_p[k].double()
        cr = Xr @ Rs_r[k].double().T + ts_r[k].double()
        front = (cp[:, 2] > 1e-6) & (cr[:, 2] > 1e-6)
        if not bool(front.any()):
            continue
        up = cp[front, :2] / cp[front, 2:] * K.diagonal()[:2] + K[:2, 2]
        ur = cr[front, :2] / cr[front, 2:] * K.diagonal()[:2] + K[:2, 2]
        worst = max(worst, float((up - ur).norm(dim=-1).median()))
    return worst


def fit_gap(K, cams, X, obs) -> float:
    """Where two states put the window's observations, in px: for each
    camera the median over its weighted observations (``obs``: uv, cam,
    pt, w) of the distance between the first state's projection (its
    pose, its point) and the second's; the worst camera.  ``cams``,
    ``X``: pairs of (Rs, ts) and of (P, 3) points.  Projections of what a
    camera observes are pinned by the observations, so the gauge and the
    near-null directions of a short window, which move poses and depths
    far, move this little."""
    K = K.double()
    _, cam, pt, w = obs
    on = w > 0
    if not bool(on.any()):
        return 0.0
    cam, pt = cam[on].long(), pt[on].long()
    proj = []
    for (Rs, ts), Xs in zip(cams, X):
        Xc = torch.einsum("mij,mj->mi", Rs.double()[cam], Xs.double()[pt]) + ts.double()[cam]
        z = torch.where(Xc[:, 2].abs() > 1e-9, Xc[:, 2], 1e-9)
        proj.append(Xc[:, :2] / z[:, None] * K.diagonal()[:2] + K[:2, 2])
    gap = (proj[0] - proj[1]).norm(dim=-1)
    return float(torch.stack([gap[cam == c].median() for c in torch.unique(cam)]).max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Optional[str]:
    """None where every number is within its limit (a NaN never is), else
    the first that is not."""
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None or not (value <= limit):
            return f"{name} {value} over its limit {limit}"
    return None
