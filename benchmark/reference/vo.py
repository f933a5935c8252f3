"""Plain PyTorch visual odometry step: the reference that the benchmark
holds the port's ``vo_step`` to.

A frozen copy of the port's plain step after the frontend (ratio-test
matching against the window map, robust pose refinement, the window roll
with its spawn and depth refresh, one dense-Schur LM iteration of
windowed BA), fed by ``reference.sift``'s frontend.  It takes the state it
is given (a step follows the program from the program's own state) and
imports nothing of the port.  ``keypoints`` hands the step a frame's
keypoint buffer in place of its own frontend's (the check follows the
program's keypoints through the back end).  ``lower=True`` runs the
control: the frontend's image planes, and the back end's keypoint
positions, poses, map points and observations, stored in bfloat16, and
the matcher's distances computed in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import sift

INT_MAX = 2 ** 31 - 1

STATE_FIELDS = ("Rs", "ts", "X", "Xvalid", "Xdesc", "obs_uv", "obs_pt", "obs_w", "prev_desc",
                "prev_uv", "prev_valid", "key_desc", "key_uv", "key_valid", "key_R", "key_t",
                "key_frame", "tri_par", "lam", "frame")


class VOParams(NamedTuple):
    window: int = 8
    pts_per_frame: int = 256
    obs_per_frame: int = 512
    pnp_n: int = 512
    pnp_iters: int = 8
    cg_iters: int = 8
    huber_px: float = 3.0
    ratio_sq: float = 0.7
    match_metric: str = "L2"
    min_track_matches: int = 12
    reloc_ratio_sq: float = 0.85
    max_rms_px: float = 12.0
    ba_pt_onehot: bool = True
    ba_solver: str = "dense"
    ba_iters: int = 1
    min_parallax_px: float = 6.0
    kf_promote_px: float = 12.0
    kf_max_age: int = 40
    depth_refresh: bool = True
    metric_weight: float = 3.0

    @classmethod
    def from_dict(cls, d: dict) -> "VOParams":
        return cls(**{k: v for k, v in d.items() if k in cls._fields})


# --- geometry ---------------------------------------------------------------

def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _se3_exp(xi):
    w, u = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = _hat(w)
    big = theta2 > 1e-12
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0)
    R = _eye3(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)
    V = _eye3(w) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return R, (V @ u[..., None])[..., 0]


def _retract(R, t, xi):
    dR, dt = _se3_exp(xi)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt


def _project(K, R, t, X):
    Xc = (X @ R.T if R.ndim == 2 else torch.einsum("...ij,...j->...i", R, X)) + t
    z = Xc[..., 2]
    zs = torch.where(z.abs() > 1e-9, z, 1e-9)
    return torch.stack([K[0, 0] * Xc[..., 0] / zs + K[0, 2], K[1, 1] * Xc[..., 1] / zs + K[1, 2]],
                       -1), z


def _jacobians(K, R, t, X):
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / torch.where(z.abs() > 1e-9, z, 1e-9)
    fx_iz, fy_iz = K[0, 0] * iz, K[1, 1] * iz
    zero = torch.zeros_like(x)
    A = torch.stack([torch.stack([fx_iz, zero, -fx_iz * x * iz], -1),
                     torch.stack([zero, fy_iz, -fy_iz * y * iz], -1)], -2)
    neg_hat = torch.stack([torch.stack([zero, z, -y], -1), torch.stack([-z, zero, x], -1),
                           torch.stack([y, -x, zero], -1)], -2)
    return torch.cat([A @ neg_hat, A], -1), A @ R


def _solve3(A, b):
    a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11, c12, c13 = a22 * a33 - a23 * a32, a13 * a32 - a12 * a33, a12 * a23 - a13 * a22
    c21, c22, c23 = a23 * a31 - a21 * a33, a11 * a33 - a13 * a31, a13 * a21 - a11 * a23
    c31, c32, c33 = a21 * a32 - a22 * a31, a12 * a31 - a11 * a32, a11 * a22 - a12 * a21
    det = a11 * c11 + a12 * c21 + a13 * c31
    det = torch.where(det.abs() > 1e-20, det, 1e-20)
    x = torch.stack([c11 * b[..., 0] + c12 * b[..., 1] + c13 * b[..., 2],
                     c21 * b[..., 0] + c22 * b[..., 1] + c23 * b[..., 2],
                     c31 * b[..., 0] + c32 * b[..., 1] + c33 * b[..., 2]], -1)
    return x / det[..., None]


def _triangulate(K, R1, t1, R2, t2, uv1, uv2):
    P1 = K @ torch.cat([R1, t1[:, None]], 1)
    P2 = K @ torch.cat([R2, t2[:, None]], 1)
    rows = torch.stack([uv1[:, 0, None] * P1[2] - P1[0], uv1[:, 1, None] * P1[2] - P1[1],
                        uv2[:, 0, None] * P2[2] - P2[0], uv2[:, 1, None] * P2[2] - P2[1]], 1)
    B, b = rows[:, :, :3], -rows[:, :, 3]
    X = _solve3(torch.einsum("nij,nik->njk", B, B) + 1e-12 * _eye3(B),
                torch.einsum("nij,ni->nj", B, b))
    return X, _project(K, R1, t1, X)[1], _project(K, R2, t2, X)[1]


# --- matching and pose ------------------------------------------------------

def _match(desc1, valid1, desc2, valid2, ratio_sq, lower=False):
    """(keep, idx2, d1, d2): best-2 squared L2 by one f32 matmul (with
    ``lower``, the distances in bfloat16)."""
    dt = torch.bfloat16 if lower else torch.float32
    a, b = desc1.to(dt), desc2.to(dt)
    dist = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)).float()
    dist = torch.where(valid2.bool()[None, :], dist.clamp_min(0.0), torch.inf)
    d1 = dist.min(dim=1).values
    i1 = dist.argmin(dim=1)
    col = torch.arange(dist.shape[1], device=dist.device)
    d2 = torch.where(col[None, :] == i1[:, None], torch.inf, dist).min(dim=1).values
    keep = valid1.bool() & (d2 < float(INT_MAX)) & (d2 > 0) & (d1 < ratio_sq * d2)
    return keep, i1.to(torch.int32), d1, d2


def _pnp_refine(K, R0, t0, X, uv, w, iters, huber_px):
    R, t = R0, t0
    lam = torch.full((), 1e-3, dtype=torch.float32, device=X.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=X.device)
    for _ in range(iters):
        p, z = _project(K, R, t, X)
        r = p - uv
        wr = w * (z > 1e-6) * torch.clamp(huber_px / torch.sqrt((r * r).sum(-1) + 1e-12), max=1.0)
        J, _ = _jacobians(K, R, t, X)
        JT = J.transpose(1, 2)
        H = torch.einsum("nij,njk->ik", JT * wr[:, None, None], J)
        g = -torch.einsum("nij,nj->i", JT * wr[:, None, None], r)
        H = H + lam * torch.diag(torch.diagonal(H))
        xi = torch.linalg.solve_ex(H + 1e-8 * eye6, g).result
        R2, t2 = _retract(R, t, xi)
        r2 = _project(K, R2, t2, X)[0] - uv
        acc = (wr * (r2 * r2).sum(-1)).sum() < (wr * (r * r).sum(-1)).sum()
        R, t = torch.where(acc, R2, R), torch.where(acc, t2, t)
        lam = torch.where(acc, lam * 0.5, lam * 4.0)
    p, z = _project(K, R, t, X)
    nrm2 = ((p - uv) ** 2).sum(-1)
    inl = w * (z > 1e-6) * (nrm2 < huber_px ** 2)
    return R, t, torch.sqrt((inl * nrm2).sum() / torch.clamp(inl.sum(), min=1.0))


# --- windowed BA: one LM iteration, dense Schur, blocked cameras ------------

def _inv3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() > 1e-20, det, 1e-20)
    adj = torch.stack([torch.stack([A11, A12, A13], -1), torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj / det[..., None, None]


def _huber_cost(r, w, huber_px):
    n2 = (r * r).sum(-1)
    nrm = torch.sqrt(n2 + 1e-12)
    return (w * torch.where(nrm <= huber_px, 0.5 * n2, huber_px * (nrm - 0.5 * huber_px))).sum()


def _lm_iteration(Rs, ts, X, uv, cam, pt, w, K, lam, free, huber_px):
    """One accept/reject LM iteration, the reduced camera system solved
    exactly.  Returns (Rs, ts, X, lam, cost, the proposed (Rs, ts, X))."""
    C, P, M = Rs.shape[0], X.shape[0], uv.shape[0]
    cl, pl = cam.long(), pt.long()

    def resid(Rs_, ts_, X_):
        return _project(K, Rs_[cl], ts_[cl], X_[pl])[0] - uv

    r = resid(Rs, ts, X)
    wq = w * torch.clamp(huber_px / torch.sqrt((r * r).sum(-1) + 1e-12), max=1.0)
    cost = _huber_cost(r, w, huber_px)
    Jc, Jp = _jacobians(K, Rs[cl], ts[cl], X[pl])
    G = (pt[None, :] == torch.arange(P, dtype=pt.dtype, device=pt.device)[:, None]).float()
    JcT, JpT = Jc.transpose(1, 2), Jp.transpose(1, 2)
    wq_ = wq[:, None, None]
    U = (wq_ * (JcT @ Jc)).reshape(C, M // C, 6, 6).sum(1)
    V = (G @ (wq_ * (JpT @ Jp)).reshape(M, 9)).reshape(P, 3, 3)
    Wm = wq_ * (JcT @ Jp)
    g_c = (-(wq[:, None] * torch.einsum("mij,mj->mi", JcT, r))).reshape(C, M // C, 6).sum(1)
    g_p = G @ (-(wq[:, None] * torch.einsum("mij,mj->mi", JpT, r)))
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
    U = U + lam * (eye6 * torch.diagonal(U, dim1=1, dim2=2)[:, :, None] * eye6 + 1e-8 * eye6)
    V = V + lam * (eye3 * torch.diagonal(V, dim1=1, dim2=2)[:, :, None] * eye3 + 1e-8 * eye3)
    Vinv = _inv3(V)
    A = torch.einsum("pcf,cfij->pcij", G.reshape(P, C, M // C), Wm.reshape(C, M // C, 6, 3))
    T = torch.einsum("pcij,pjk->pcik", A, Vinv)
    S2 = torch.einsum("pcik,pdjk->cidj", T, A)
    Ubd = torch.einsum("cij,cd->cidj", U, torch.eye(C, dtype=U.dtype, device=U.device))
    S = (Ubd - S2).reshape(C * 6, C * 6)
    b = g_c - torch.einsum("pcij,pj->ci", T, g_p)
    m6 = torch.repeat_interleave(free.to(S.dtype), 6)
    S = S * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
    dc = torch.linalg.solve_ex(S, b.reshape(-1) * m6).result.reshape(C, 6)
    dp = torch.einsum("pij,pj->pi", Vinv, g_p - torch.einsum("pcij,ci->pj", A, dc))
    Rs2, ts2 = _retract(Rs, ts, dc)
    X2 = X + dp
    accept = _huber_cost(resid(Rs2, ts2, X2), w, huber_px) < cost
    lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
    return (torch.where(accept, Rs2, Rs), torch.where(accept, ts2, ts),
            torch.where(accept, X2, X), lam, cost, (Rs2, ts2, X2))


def window_cost(state: dict, K: torch.Tensor, vo: VOParams) -> float:
    """The windowed BA's robust cost at a state's cameras and points, over
    its observations (what one LM iteration lowers)."""
    W, OBS_F = vo.window, vo.obs_per_frame
    pt = state["obs_pt"].reshape(-1)
    cam = torch.arange(W, device=pt.device).repeat_interleave(OBS_F)
    X = state["X"].reshape(-1, 3)
    w = state["obs_w"].reshape(-1) * state["Xvalid"].reshape(-1)[pt.long()]
    r = _project(K, state["Rs"][cam], state["ts"][cam], X[pt.long()])[0] \
        - state["obs_uv"].reshape(-1, 2)
    return float(_huber_cost(r.double(), w.double(), vo.huber_px))


# --- the step ---------------------------------------------------------------

def _rays(K, uv):
    return torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1],
                        torch.ones_like(uv[..., 0])], -1)


def _top_k(score, k):
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


LOWER_FIELDS = ("Rs", "ts", "X", "obs_uv", "key_uv", "key_R", "key_t")


def vo_step(state: dict, frame: torch.Tensor, K: torch.Tensor, p: sift.Params, vo: VOParams,
            lower: bool = False, keypoints: sift.Buffer = None):
    """One step from `state` (a dict of STATE_FIELDS tensors) on `frame`,
    or on the buffer `keypoints` where given: returns (new state dict,
    output dict of the VOOut fields plus ``ba_input`` and ``ba_proposal``,
    the last BA iteration's (Rs, ts, X) before it and as proposed, the
    frame's keypoint buffer)."""
    if vo.match_metric != "L2" or vo.ba_solver != "dense" or not vo.ba_pt_onehot:
        raise ValueError("the reference covers L2 matching and the dense BA solve")
    buf = keypoints if keypoints is not None else sift.detect_and_describe(frame, p, lower)
    st = state
    if lower:
        buf = buf._replace(x=_bf16(buf.x), y=_bf16(buf.y))
        st = dict(st, **{k: _bf16(st[k]) for k in LOWER_FIELDS})
    W, PN, OBS_F = vo.window, vo.pts_per_frame, vo.obs_per_frame
    P = W * PN
    dev = frame.device
    f32, i32 = torch.float32, torch.int32
    kp_uv = torch.stack([buf.x, buf.y], -1)
    n_kp = buf.valid.sum().to(i32)
    mw = vo.metric_weight - 1.0

    keep, map_id, dist, dist2 = _match(buf.desc, buf.valid, st["Xdesc"].reshape(P, 128),
                                       st["Xvalid"].reshape(P) > 0, vo.ratio_sq, lower)
    map_id = map_id.long()
    n_matches = keep.sum().to(i32)
    keep_loose = (buf.valid & (dist2 < float(INT_MAX)) & (dist2 > 0)
                  & (dist < vo.reloc_ratio_sq * dist2))
    strict_ok = n_matches >= vo.min_track_matches
    use_loose = (~strict_ok) & (keep_loose.sum() >= vo.min_track_matches)
    keep_pnp = torch.where(use_loose, keep_loose, keep)

    score = torch.where(keep_pnp, -dist, -torch.inf)
    sel = _top_k(score, vo.pnp_n)
    tri_flat = st["tri_par"].reshape(P)
    X_flat = st["X"].reshape(P, 3)
    w_sel = keep_pnp[sel].to(f32) * (1.0 + mw * (tri_flat[map_id[sel]] > 0).to(f32))
    uv_sel = kp_uv[sel]
    X_sel = X_flat[map_id[sel]]
    R_prev, t_prev = st["Rs"][W - 1], st["ts"][W - 1]
    R_fit, t_fit, rms = _pnp_refine(K, R_prev, t_prev, X_sel, uv_sel, w_sel, vo.pnp_iters,
                                    vo.huber_px)
    tracked = ((w_sel > 0).to(f32).sum() >= vo.min_track_matches) & (rms < vo.max_rms_px)
    R_new = torch.where(tracked, R_fit, R_prev)
    t_new = torch.where(tracked, t_fit, t_prev)

    Rs = torch.cat([st["Rs"][1:], R_new[None]])
    ts = torch.cat([st["ts"][1:], t_new[None]])
    shift = st["obs_pt"] - PN
    obs_w_old = st["obs_w"] * (shift >= 0)
    obs_pt_old = torch.clamp(shift, min=0)
    osel = _top_k(score, OBS_F)
    ow = keep_pnp[osel].to(f32) * (1.0 + mw * (tri_flat[map_id[osel]] > 0).to(f32))
    ouv = kp_uv[osel]
    opt = torch.clamp(map_id[osel] - PN, min=0)
    ow = ow * (map_id[osel] - PN >= 0)
    obs_uv = torch.cat([st["obs_uv"][1:], ouv[None]])
    obs_pt = torch.cat([obs_pt_old[1:], opt.to(i32)[None]])
    obs_w = torch.cat([obs_w_old[1:], ow[None]])

    Xc_sel = X_sel @ R_new.T + t_new
    depths = torch.where(w_sel > 0, Xc_sel[:, 2], torch.nan)
    med_depth = torch.clamp(torch.nan_to_num(torch.nanquantile(depths, 0.5), nan=5.0), 0.5, 100.0)
    carried_raw = keep_pnp & (map_id < PN)
    cols = torch.arange(PN, device=dev)
    colmat = torch.where(carried_raw[:, None] & (map_id[:, None] == cols[None, :]),
                         dist[:, None], torch.inf)
    winner = colmat.argmin(dim=0)
    carried = carried_raw & (winner[torch.clamp(map_id, max=PN - 1)]
                             == torch.arange(map_id.shape[0], device=dev))
    spawn_ok = (buf.valid & ~keep_pnp) | carried
    new_score = torch.where(spawn_ok, buf.scale + torch.where(carried, 1e4, 0.0), -torch.inf)
    nsel = _top_k(new_score, PN)
    nok = spawn_ok[nsel].to(f32)
    car = carried[nsel]
    nuv = kp_uv[nsel]
    Xbp = (_rays(K, nuv) * med_depth.expand(PN)[:, None] - t_new) @ R_new
    pk, pidx, _, _ = _match(buf.desc[nsel], nok > 0, st["key_desc"], st["key_valid"],
                            vo.ratio_sq, lower)
    uv_key = st["key_uv"][pidx.long()]
    Xtri, z_key, z_new = _triangulate(K, st["key_R"], st["key_t"], R_new, t_new, uv_key, nuv)
    ray_new = _rays(K, uv_key) @ (R_new @ st["key_R"].T).T
    uv_rot = torch.stack([K[0, 0] * ray_new[:, 0] / ray_new[:, 2] + K[0, 2],
                          K[1, 1] * ray_new[:, 1] / ray_new[:, 2] + K[1, 2]], -1)
    parallax = torch.linalg.vector_norm(nuv - uv_rot, dim=-1)
    tri_ok = (pk & ~car & (parallax > vo.min_parallax_px)
              & (z_key > 0.2 * med_depth) & (z_new > 0.2 * med_depth)
              & (z_key < 10.0 * med_depth) & (z_new < 10.0 * med_depth))
    X_car = X_flat[map_id[nsel]]
    par_car = tri_flat[map_id[nsel]]
    Xnew = torch.where(car[:, None], X_car, torch.where(tri_ok[:, None], Xtri, Xbp))
    X = torch.cat([st["X"][1:], Xnew[None]])
    Xvalid = torch.cat([st["Xvalid"][1:], nok[None]])
    Xdesc = torch.cat([st["Xdesc"][1:], buf.desc[nsel][None]])
    obs_uv[W - 1, OBS_F - PN:] = nuv
    obs_pt[W - 1, OBS_F - PN:] = (W - 1) * PN + torch.arange(PN, dtype=i32, device=dev)
    spawn_metric = tri_ok | (car & (par_car > 0))
    obs_w[W - 1, OBS_F - PN:] = nok * (1.0 + mw * spawn_metric.to(f32))

    tri_par_new = torch.where(car, par_car, tri_ok.to(f32) * (parallax / K[0, 0]) ** 2)
    tri_par = torch.cat([st["tri_par"][1:], tri_par_new[None]])
    if vo.depth_refresh:
        w_src, j_loc = opt // PN, opt % PN
        sp_idx = w_src * OBS_F + (OBS_F - PN) + j_loc
        sp_uv = obs_uv.reshape(W * OBS_F, 2)[sp_idx]
        sp_w = obs_w.reshape(W * OBS_F)[sp_idx]
        R_src, t_src = Rs[w_src], ts[w_src]
        c_src = -torch.einsum("nji,nj->ni", R_src, t_src)
        d_src = torch.einsum("nji,nj->ni", R_src, _rays(K, sp_uv))
        d_src = d_src / torch.linalg.vector_norm(d_src, dim=-1, keepdim=True)
        c_cur = -R_new.T @ t_new
        d_cur = _rays(K, ouv) @ R_new
        d_cur = d_cur / torch.linalg.vector_norm(d_cur, dim=-1, keepdim=True)
        b = c_cur[None, :] - c_src
        m = (d_src * d_cur).sum(-1)
        denom = torch.clamp(1.0 - m * m, min=1e-12)
        bd1, bd2 = (b * d_src).sum(-1), (b * d_cur).sum(-1)
        s_len = (bd1 - m * bd2) / denom
        t_len = s_len * m - bd2
        X_mid = 0.5 * (c_src + s_len[:, None] * d_src + c_cur[None, :] + t_len[:, None] * d_cur)
        z_cur = (X_mid @ R_new.T + t_new)[:, 2]
        Xflat = X.reshape(P, 3)
        z_est = (Xflat[opt] @ R_new.T + t_new)[:, 2]
        bperp2 = torch.clamp((b * b).sum(-1) - bd2 * bd2, min=0.0)
        exp_sin2 = bperp2 / torch.clamp(z_est * z_est, min=1e-12)
        min_sin2 = (vo.min_parallax_px / K[0, 0]) ** 2
        last_par = tri_par.reshape(P)[opt]
        gate = (exp_sin2 > min_sin2) | (denom > 4.0 * min_sin2)
        upd = ((ow > 0) & (sp_w > 0) & gate
               & (torch.maximum(exp_sin2, denom) > 2.25 * last_par)
               & (denom > 0.25 * min_sin2) & (s_len > 0) & (t_len > 0)
               & (z_cur > 0.2 * med_depth) & (z_cur < 10.0 * med_depth))
        U = ((opt[:, None] == torch.arange(P, device=dev)[None, :]) & upd[:, None]).to(f32)
        den = U.sum(0)
        Xflat = torch.where(den[:, None] > 0, (U.T @ X_mid) / torch.clamp(den, min=1.0)[:, None],
                            Xflat)
        X = Xflat.reshape(W, PN, 3)
        par_num = U.T @ torch.maximum(exp_sin2, denom)
        tri_par = torch.where(den > 0, par_num / torch.clamp(den, min=1.0),
                              tri_par.reshape(P)).reshape(W, PN)

    obs_pt_flat = obs_pt.reshape(-1)
    cam = torch.arange(W, dtype=i32, device=dev).repeat_interleave(OBS_F)
    w_obs = obs_w.reshape(-1) * Xvalid.reshape(P)[obs_pt_flat.long()]
    free = (torch.arange(W, device=dev) > 1).to(f32)
    Rs2, ts2, Xb, lam2 = Rs, ts, X.reshape(P, 3), st["lam"]
    cost = torch.zeros((), dtype=f32, device=dev)
    ba_input = proposal = (Rs2, ts2, Xb)
    for _ in range(vo.ba_iters):
        ba_input = (Rs2, ts2, Xb)
        Rs2, ts2, Xb, lam2, cost, proposal = _lm_iteration(
            Rs2, ts2, Xb, obs_uv.reshape(-1, 2), cam, obs_pt_flat, w_obs, K, lam2, free,
            vo.huber_px)

    c_new = -R_new.T @ t_new
    c_key = -st["key_R"].T @ st["key_t"]
    base_px = K[0, 0] * torch.linalg.vector_norm(c_new - c_key) / med_depth
    promote = (base_px > vo.kf_promote_px) | (st["frame"] - st["key_frame"] >= vo.kf_max_age)
    rolled = dict(
        Rs=Rs2, ts=ts2, X=Xb.reshape(W, PN, 3), Xvalid=Xvalid, Xdesc=Xdesc, obs_uv=obs_uv,
        obs_pt=obs_pt, obs_w=obs_w, prev_desc=buf.desc, prev_uv=kp_uv, prev_valid=buf.valid,
        key_desc=torch.where(promote, buf.desc, st["key_desc"]),
        key_uv=torch.where(promote, kp_uv, st["key_uv"]),
        key_valid=torch.where(promote, buf.valid, st["key_valid"]),
        key_R=torch.where(promote, Rs2[W - 1], st["key_R"]),
        key_t=torch.where(promote, ts2[W - 1], st["key_t"]),
        key_frame=torch.where(promote, st["frame"], st["key_frame"]),
        tri_par=tri_par, lam=lam2, frame=st["frame"] + 1)
    hold = dict(st, prev_desc=buf.desc, prev_uv=kp_uv, prev_valid=buf.valid, frame=st["frame"] + 1)
    new = {k: torch.where(tracked, rolled[k], hold[k]) for k in STATE_FIELDS}
    out = dict(R=new["Rs"][W - 1], t=new["ts"][W - 1], n_kp=n_kp, n_matches=n_matches,
               rms_px=rms, ba_cost=cost, tracked=tracked,
               n_spawn_tri=(tri_ok & (nok > 0)).sum().to(i32),
               ba_input=ba_input, ba_proposal=proposal)
    return new, out, buf
