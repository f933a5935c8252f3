"""Windowed bundle adjustment: one Levenberg-Marquardt iteration with a
Schur-complement solve, in the VO window's layout.

Port of ``sift_pyocl_tpu/sfm/ba.py`` (``BAParams`` ... ``lm_iteration``) for
the layout the VO step uses: observations in per-camera blocks
(``cam_blocked=True``: ``obs.cam == repeat(arange(C), M // C)``, so camera
reductions are a reshape and a sum) and point reductions as products with a
one-hot (P, M) matrix (``pt_onehot=True``).  The reduced camera system is
solved exactly (``dense_schur=True``, a (6C, 6C) solve) or by matrix-free
CG.  The products, einsums and the small dense solve are plain PyTorch, as
they were plain XLA outside any Pallas kernel in the JAX package.

Still to come (ROADMAP.md, Queue 1 items 11-12): the scatter form
(``cam_blocked=False`` or ``pt_onehot=False``), which on the card needs a
segment sum that does not depend on the order of float atomics,
``axis_name`` (the distributed BA) and ``run_ba``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .geometry import pose_retract, project, project_jacobians

_SCATTER_TODO = ("the scatter form of BA (cam_blocked=False or pt_onehot=False) is not "
                 "ported yet (ROADMAP.md, Queue 1 item 11: a deterministic segment sum)")
_DIST_TODO = ("axis_name (distributed BA) is not ported yet (ROADMAP.md, Queue 1 item 12)")


class BAParams(NamedTuple):
    """Optimization parameters."""

    Rs: torch.Tensor   # (C, 3, 3)
    ts: torch.Tensor   # (C, 3)
    X: torch.Tensor    # (P, 3)


class BAObs(NamedTuple):
    """Static-capacity observation table."""

    uv: torch.Tensor   # (M, 2) f32 pixel measurements
    cam: torch.Tensor  # (M,) int32
    pt: torch.Tensor   # (M,) int32, may be -1 in padding
    w: torch.Tensor    # (M,) f32, 0 = padding


def _check_layout(cam_blocked: bool, pt_onehot: bool, axis_name=None) -> None:
    if axis_name is not None:
        raise NotImplementedError(_DIST_TODO)
    if not (cam_blocked and pt_onehot):
        raise NotImplementedError(_SCATTER_TODO)


def _seg_cam(vals: torch.Tensor, n_cams: int) -> torch.Tensor:
    """Per-camera sums of per-observation blocks (blocked layout)."""
    return vals.reshape((n_cams, -1) + tuple(vals.shape[1:])).sum(1)


def _take_cam(x: torch.Tensor, m: int) -> torch.Tensor:
    """x[cam] for the blocked layout: each camera's row repeated M/C times."""
    reps = m // x.shape[0]
    return x[:, None].expand((x.shape[0], reps) + tuple(x.shape[1:])).reshape(
        (m,) + tuple(x.shape[1:]))


def _pt_onehot_matrix(pt: torch.Tensor, n_points: int) -> torch.Tensor:
    """(P, M) f32 one-hot of obs.pt; pt < 0 columns are all zero."""
    ids = torch.arange(n_points, dtype=pt.dtype, device=pt.device)
    return (pt[None, :] == ids[:, None]).to(torch.float32)


def _seg_pt(vals: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Per-point sums as G @ vals."""
    out = G @ vals.reshape(vals.shape[0], -1)
    return out.reshape((G.shape[0],) + tuple(vals.shape[1:]))


def _take_pt(y: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """y[pt] as G^T @ y (pt < 0 rows read zero; their W blocks are zero)."""
    out = G.T @ y.reshape(y.shape[0], -1)
    return out.reshape((G.shape[1],) + tuple(y.shape[1:]))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


def residuals(params: BAParams, obs: BAObs, K: torch.Tensor) -> torch.Tensor:
    """(M, 2) reprojection residuals."""
    p, _ = project(K, _gather(params.Rs, obs.cam), _gather(params.ts, obs.cam),
                   _gather(params.X, obs.pt))
    return p - obs.uv


def robust_weights(r: torch.Tensor, w: torch.Tensor, huber_px: float) -> torch.Tensor:
    """Huber IRLS weights on the residual norm."""
    nrm = torch.sqrt((r * r).sum(-1) + 1e-12)
    return w * torch.clamp(huber_px / nrm, max=1.0)


def robust_cost(r: torch.Tensor, w: torch.Tensor, huber_px: float) -> torch.Tensor:
    """Sum of Huber losses (the objective of the accept/reject test)."""
    n2 = (r * r).sum(-1)
    nrm = torch.sqrt(n2 + 1e-12)
    quad = 0.5 * n2
    lin = huber_px * (nrm - 0.5 * huber_px)
    return (w * torch.where(nrm <= huber_px, quad, lin)).sum()


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() > 1e-20, det, 1e-20)
    adj = torch.stack([torch.stack([A11, A12, A13], -1),
                       torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj / det[..., None, None]


class _System(NamedTuple):
    U: torch.Tensor      # (C, 6, 6) damped camera blocks
    Vinv: torch.Tensor   # (P, 3, 3) inverted damped point blocks
    W: torch.Tensor      # (M, 6, 3) cross blocks
    g_c: torch.Tensor    # (C, 6) camera gradient
    g_p: torch.Tensor    # (P, 3) point gradient
    G: torch.Tensor      # (P, M) one-hot of obs.pt


def build_system(params: BAParams, obs: BAObs, K: torch.Tensor, lam: torch.Tensor,
                 huber_px: float, n_points: int, axis_name=None, cam_blocked: bool = True,
                 pt_onehot: bool = True) -> Tuple[_System, torch.Tensor]:
    """Weighted, damped normal-equation blocks; returns (system, robust cost).
    The weight multiplies each block after its product, as in the JAX
    package."""
    _check_layout(cam_blocked, pt_onehot, axis_name)
    r = residuals(params, obs, K)
    wq = robust_weights(r, obs.w, huber_px)
    cost = robust_cost(r, obs.w, huber_px)
    Jc, Jp = project_jacobians(K, _gather(params.Rs, obs.cam), _gather(params.ts, obs.cam),
                               _gather(params.X, obs.pt))
    n_cams = params.Rs.shape[0]
    G = _pt_onehot_matrix(obs.pt, n_points)
    JcT = Jc.transpose(1, 2)
    JpT = Jp.transpose(1, 2)
    wq_ = wq[:, None, None]
    Um = wq_ * (JcT @ Jc)
    Vm = wq_ * (JpT @ Jp)
    W = wq_ * (JcT @ Jp)
    gcm = -(wq[:, None] * torch.einsum("mij,mj->mi", JcT, r))
    gpm = -(wq[:, None] * torch.einsum("mij,mj->mi", JpT, r))
    U = _seg_cam(Um, n_cams)
    g_c = _seg_cam(gcm, n_cams)
    V = _seg_pt(Vm, G)
    g_p = _seg_pt(gpm, G)
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
    # Marquardt damping: lam * (diag + small identity floor)
    U = U + lam * (eye6 * torch.diagonal(U, dim1=1, dim2=2)[:, :, None] * eye6 + 1e-8 * eye6)
    V = V + lam * (eye3 * torch.diagonal(V, dim1=1, dim2=2)[:, :, None] * eye3 + 1e-8 * eye3)
    return _System(U, _inv3(V), W, g_c, g_p, G), cost


def _schur_matvec(sys: _System, x: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """S x with S = U - W V^-1 W^T, never assembled."""
    x = x * free[:, None]
    xg = _take_cam(x, sys.W.shape[0])
    u = torch.einsum("mij,mi->mj", sys.W, xg)
    q = _seg_pt(u, sys.G)
    y = torch.einsum("pij,pj->pi", sys.Vinv, q)
    z = torch.einsum("mij,mj->mi", sys.W, _take_pt(y, sys.G))
    acc = _seg_cam(z, x.shape[0])
    Ux = torch.einsum("cij,cj->ci", sys.U, x)
    return (Ux - acc) * free[:, None]


def _cg(matvec, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration conjugate gradients."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = (r * r).sum()
    for _ in range(iters):
        Ap = matvec(p)
        denom = (p * Ap).sum()
        alpha = rs / torch.where(denom.abs() > 1e-20, denom, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = (r * r).sum()
        beta = rs_new / torch.where(rs > 1e-20, rs, 1e-20)
        p = r + beta * p
        rs = rs_new
    return x


def solve_step_dense(sys: _System, free: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact Schur solve: S = U - W V^-1 W^T assembled as a (6C, 6C) matrix
    from the per-point camera blocks A[p, c] = sum over obs of p in c of W."""
    C = sys.U.shape[0]
    P, M = sys.G.shape
    obs_f = M // C
    Wb = sys.W.reshape(C, obs_f, 6, 3)
    Gb = sys.G.reshape(P, C, obs_f)
    A = torch.einsum("pcf,cfij->pcij", Gb, Wb)
    T = torch.einsum("pcij,pjk->pcik", A, sys.Vinv)           # A V^-1
    S2 = torch.einsum("pcik,pdjk->cidj", T, A)                # (C, 6, C, 6)
    eyeC = torch.eye(C, dtype=sys.U.dtype, device=sys.U.device)
    Ubd = torch.einsum("cij,cd->cidj", sys.U, eyeC)
    S = (Ubd - S2).reshape(C * 6, C * 6)
    b = sys.g_c - torch.einsum("pcij,pj->ci", T, sys.g_p)
    # gauge fixing: zero fixed-camera rows/cols, identity on their diagonal
    m6 = torch.repeat_interleave(free.to(S.dtype), 6)
    S = S * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
    b = b.reshape(-1) * m6
    dc = torch.linalg.solve_ex(S, b).result.reshape(C, 6)
    q = torch.einsum("pcij,ci->pj", A, dc)
    dp = torch.einsum("pij,pj->pi", sys.Vinv, sys.g_p - q)
    return dc, dp


def solve_step(sys: _System, free: torch.Tensor, cg_iters: int = 30
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped step by matrix-free CG: camera (C, 6) and point (P, 3)
    updates."""
    y = torch.einsum("pij,pj->pi", sys.Vinv, sys.g_p)
    z = torch.einsum("mij,mj->mi", sys.W, _take_pt(y, sys.G))
    b = (sys.g_c - _seg_cam(z, sys.g_c.shape[0])) * free[:, None]
    dc = _cg(lambda x: _schur_matvec(sys, x, free), b, cg_iters)
    u = torch.einsum("mij,mi->mj", sys.W, _take_cam(dc, sys.W.shape[0]))
    q = _seg_pt(u, sys.G)
    dp = torch.einsum("pij,pj->pi", sys.Vinv, sys.g_p - q)
    return dc, dp


def apply_step(params: BAParams, dc: torch.Tensor, dp: torch.Tensor) -> BAParams:
    Rs, ts = pose_retract(params.Rs, params.ts, dc)
    return BAParams(Rs, ts, params.X + dp)


def lm_iteration(params: BAParams, obs: BAObs, K: torch.Tensor, lam: torch.Tensor,
                 free: torch.Tensor, huber_px: float = 2.0, cg_iters: int = 30,
                 n_points: int = 0, axis_name=None, cam_blocked: bool = True,
                 pt_onehot: bool = True, dense_schur: bool = False):
    """One accept/reject LM iteration.  Returns (params, lam, cost, accepted).

    ``free`` (C,) marks the cameras that move (the rest are the gauge).
    Only the VO layout (``cam_blocked`` and ``pt_onehot``) is ported."""
    _check_layout(cam_blocked, pt_onehot, axis_name)
    free = free.to(torch.float32)
    nP = n_points or params.X.shape[0]
    sys, cost = build_system(params, obs, K, lam, huber_px, nP)
    dc, dp = solve_step_dense(sys, free) if dense_schur else solve_step(sys, free, cg_iters)
    cand = apply_step(params, dc, dp)
    new_cost = robust_cost(residuals(cand, obs, K), obs.w, huber_px)
    accept = new_cost < cost
    params = BAParams(*(torch.where(accept, a, b) for a, b in zip(cand, params)))
    lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
    return params, lam, cost, accept


def run_ba(*args, **kwargs):
    """The host-driven LM loop of the JAX package: still to come."""
    raise NotImplementedError("run_ba is not ported yet (ROADMAP.md, Queue 1 item 11)")
