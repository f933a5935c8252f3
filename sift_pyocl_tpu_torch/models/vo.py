"""Visual odometry: SIFT + map matching + PnP + windowed BA, one step a frame.

Port of ``sift_pyocl_tpu/models/vo.py`` (``VOConfig``, ``VOState``,
``VOOut``, ``vo_init``, ``vo_step``) with the same fields, slot layouts and
arithmetic.  The sliding-window state lives in per-frame blocks that roll
along the window axis; selection is a top-k over dense masks, so every step
has static shapes and no data-dependent host branch.  Per step:

  1. ``detect_and_describe`` (the frontend, kernels K1-K6);
  2. ratio-test match against the window map (K7);
  3. robust pose-only refinement (``sfm.pnp.pnp_refine``);
  4. roll the window, spawn new map points (carry-over, keyframe
     triangulation, median-depth backprojection) and refresh depths;
  5. ``ba_iters`` LM iterations over the window (``sfm.ba.lm_iteration``).

Everything after the frontend is ``_vo_update``, so a caller (or a test) can
feed it any frontend's keypoint buffer.  The JAX package's top-k
(``lax.top_k``, exact ``approx_max_k`` off the TPU) breaks ties by the
lowest index; a stable descending sort does the same here.
"""

from __future__ import annotations

import logging
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SiftConfig
from ..ops import resolve_device
from ..ops.match import INT_MAX, match_descriptors_dense
from ..sfm.ba import BAObs, BAParams, lm_iteration
from ..sfm.geometry import triangulate_two_view
from ..sfm.pnp import pnp_refine
from ..utils import graphs
from .sift import KeypointBuffer, detect_and_describe

logger = logging.getLogger(__name__)


class VOConfig(NamedTuple):
    """Static VO parameters; fields and defaults as in the JAX package."""

    window: int = 8           # sliding window size W (cameras in BA)
    pts_per_frame: int = 256  # PN: new map points spawned per frame
    obs_per_frame: int = 512  # OBS_F: observations kept per frame
    pnp_n: int = 512          # matches fed to pose refinement
    pnp_iters: int = 8
    cg_iters: int = 8
    huber_px: float = 3.0
    ratio_sq: float = 0.7
    match_metric: str = "L2"
    min_track_matches: int = 12   # below this the frame counts as lost
    reloc_ratio_sq: float = 0.85  # looser re-localization gate when lost
    max_rms_px: float = 12.0      # PnP residual gate on pose acceptance
    ba_pt_onehot: bool = True
    ba_solver: str = "dense"      # "dense" exact (6W, 6W) Schur solve | "cg"
    ba_iters: int = 1
    min_parallax_px: float = 6.0
    kf_promote_px: float = 12.0
    kf_max_age: int = 40
    depth_refresh: bool = True
    metric_weight: float = 3.0


class VOState(NamedTuple):
    Rs: torch.Tensor         # (W, 3, 3) world->cam per window slot (slot = cam id)
    ts: torch.Tensor         # (W, 3)
    X: torch.Tensor          # (W, PN, 3) map points, blocked by source frame
    Xvalid: torch.Tensor     # (W, PN) f32 0/1
    Xdesc: torch.Tensor      # (W, PN, 128) uint8
    obs_uv: torch.Tensor     # (W, OBS_F, 2)
    obs_pt: torch.Tensor     # (W, OBS_F) int32 flat map id (slot*PN+local), -1 pad
    obs_w: torch.Tensor      # (W, OBS_F) f32
    prev_desc: torch.Tensor  # (N, 128) uint8 previous frame's keypoint buffer
    prev_uv: torch.Tensor    # (N, 2) f32
    prev_valid: torch.Tensor  # (N,) bool
    key_desc: torch.Tensor   # (N, 128) uint8 spawn keyframe
    key_uv: torch.Tensor     # (N, 2) f32
    key_valid: torch.Tensor  # (N,) bool
    key_R: torch.Tensor      # (3, 3) keyframe pose
    key_t: torch.Tensor      # (3,)
    key_frame: torch.Tensor  # () int32 frame id at promotion
    tri_par: torch.Tensor    # (W, PN) f32 sin^2 of the ray angle at the last
                             # metric triangulation (0 = still flat-depth)
    lam: torch.Tensor        # () f32 LM damping carried across frames
    frame: torch.Tensor      # () int32


class VOOut(NamedTuple):
    R: torch.Tensor          # (3, 3) latest pose
    t: torch.Tensor          # (3,)
    n_kp: torch.Tensor       # () int32
    n_matches: torch.Tensor  # () int32
    rms_px: torch.Tensor     # () f32 PnP inlier RMS
    ba_cost: torch.Tensor    # () f32 robust BA cost of the iteration
    tracked: torch.Tensor    # () bool; False = frame rejected, pose held
    n_spawn_tri: torch.Tensor  # () int32 spawns that passed the parallax gate


def _kp_xy(buf: KeypointBuffer) -> torch.Tensor:
    return torch.stack([buf.x, buf.y], -1)


def _rays(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1],
                        torch.ones_like(uv[..., 0])], -1)


def _backproject(K, R, t, uv, depth):
    """World point for pixel uv at camera depth `depth`."""
    Xc = _rays(K, uv) * depth[..., None]
    return (Xc - t) @ R          # R^T (Xc - t)


def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties to the lowest index (lax.top_k)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _as_frame(frame, device: torch.device) -> torch.Tensor:
    x = frame if torch.is_tensor(frame) else torch.from_numpy(np.asarray(frame))
    return x.to(device)


def _as_K(K, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(K, dtype=torch.float32, device=device)


def vo_init(frame0, K, cfg: SiftConfig, vo: VOConfig, init_depth: float = 5.0,
            plain: bool = False,
            device: Optional[Union[str, torch.device]] = None) -> VOState:
    """Bootstrap: frame 0 at identity; its strongest keypoints seed the map
    at a nominal depth.  Runs on the device of `frame0` when it is a tensor,
    else on `device` (default: the CUDA card; pass "cpu" for the CPU)."""
    if device is None and torch.is_tensor(frame0):
        dev = frame0.device
    else:
        dev = resolve_device(device)
    frame0 = _as_frame(frame0, dev)
    K = _as_K(K, dev)
    logger.info("vo_init: frame %s on %s, window %d, %d pts/frame, metric %s",
                tuple(frame0.shape), dev, vo.window, vo.pts_per_frame, vo.match_metric)
    W, PN, OBS_F = vo.window, vo.pts_per_frame, vo.obs_per_frame
    if OBS_F < PN:
        raise ValueError("obs_per_frame must cover the spawned points")
    buf = detect_and_describe(frame0, cfg, plain=plain)
    score = torch.where(buf.valid, buf.scale, -torch.inf)
    sel = _top_k(score, PN)
    ok = buf.valid[sel].to(torch.float32)
    uv = _kp_xy(buf)[sel]
    f32, i32 = torch.float32, torch.int32
    R0 = torch.eye(3, dtype=f32, device=dev)
    t0 = torch.zeros(3, dtype=f32, device=dev)
    X0 = _backproject(K, R0, t0, uv, torch.full((PN,), init_depth, dtype=f32, device=dev))
    X = torch.zeros((W, PN, 3), dtype=f32, device=dev)
    X[W - 1] = X0
    Xvalid = torch.zeros((W, PN), dtype=f32, device=dev)
    Xvalid[W - 1] = ok
    Xdesc = torch.zeros((W, PN, 128), dtype=torch.uint8, device=dev)
    Xdesc[W - 1] = buf.desc[sel]
    # seed self-observations live in the TAIL block [OBS_F-PN:], the slots
    # vo_step writes spawn self-observations into and its depth refresh reads
    obs_uv = torch.zeros((W, OBS_F, 2), dtype=f32, device=dev)
    obs_uv[W - 1, OBS_F - PN:] = uv
    obs_pt = torch.full((W, OBS_F), -1, dtype=i32, device=dev)
    obs_pt[W - 1, OBS_F - PN:] = (W - 1) * PN + torch.arange(PN, dtype=i32, device=dev)
    obs_w = torch.zeros((W, OBS_F), dtype=f32, device=dev)
    obs_w[W - 1, OBS_F - PN:] = ok
    kp_uv = _kp_xy(buf)
    return VOState(
        Rs=R0.expand(W, 3, 3).clone(), ts=torch.zeros((W, 3), dtype=f32, device=dev),
        X=X, Xvalid=Xvalid, Xdesc=Xdesc, obs_uv=obs_uv, obs_pt=obs_pt, obs_w=obs_w,
        prev_desc=buf.desc, prev_uv=kp_uv, prev_valid=buf.valid,
        key_desc=buf.desc, key_uv=kp_uv, key_valid=buf.valid, key_R=R0, key_t=t0,
        key_frame=torch.zeros((), dtype=i32, device=dev),
        tri_par=torch.zeros((W, PN), dtype=f32, device=dev),
        lam=torch.full((), 1e-3, dtype=f32, device=dev),
        frame=torch.ones((), dtype=i32, device=dev),
    )


def vo_step(state: VOState, frame, K, cfg: SiftConfig, vo: VOConfig,
            plain: bool = False,
            on_stage: Optional[Callable[[str], None]] = None) -> Tuple[VOState, VOOut]:
    """One VO frame on the device of `state`: detect -> match -> PnP ->
    roll -> BA.  ``plain=True`` runs every kernel's plain version instead;
    ``on_stage(name)``, if given, is called as each stage is enqueued
    ("frontend", "match", "pnp", "roll_spawn", "ba").

    On a CUDA state the step is one CUDA graph per (device, frame shape and
    dtype, cfg, vo), as the JAX package jits one program per (shape, cfg,
    vo): the first call of a key captures it (``STEP_GRAPHS``), every call
    copies the state, the frame and K (host arrays or tensors) into the
    graph's buffers and replays it; the results are fresh tensors.  The CPU,
    ``plain=True`` and ``on_stage`` (host callbacks between the stages) run
    the step eagerly.  A capture or replay that fails raises."""
    dev = state.Rs.device
    if dev.type != "cuda" or plain or on_stage is not None:
        return _vo_step_eager(state, frame, K, cfg, vo, plain=plain, on_stage=on_stage)
    # host arrays stay on the host: the graph's input copy moves them
    frame = frame if torch.is_tensor(frame) else torch.from_numpy(np.asarray(frame))
    out = STEP_GRAPHS(dev, (cfg, vo), (*state, frame, torch.as_tensor(K, dtype=torch.float32)))
    n = len(VOState._fields)
    return VOState(*out[:n]), VOOut(*out[n:])


def _vo_step_eager(state: VOState, frame, K, cfg: SiftConfig, vo: VOConfig,
                   plain: bool = False,
                   on_stage: Optional[Callable[[str], None]] = None) -> Tuple[VOState, VOOut]:
    """``vo_step`` op by op (what its graph captures)."""
    dev = state.Rs.device
    buf = detect_and_describe(_as_frame(frame, dev), cfg, plain=plain)
    if on_stage is not None:
        on_stage("frontend")
    return _vo_update(state, buf, _as_K(K, dev), vo, plain=plain, on_stage=on_stage)


def _step_flat(static: Tuple[SiftConfig, VOConfig], *tensors: torch.Tensor):
    """The eager step on flat tensors (the state's fields, the frame, K),
    returning the new state's fields and the output's."""
    cfg, vo = static
    n = len(VOState._fields)
    state, out = _vo_step_eager(VOState(*tensors[:n]), tensors[n], tensors[n + 1], cfg, vo)
    return (*state, *out)


# vo_step's graphs on the card
STEP_GRAPHS = graphs.GraphCache(_step_flat)


def _vo_update(state: VOState, buf: KeypointBuffer, K: torch.Tensor, vo: VOConfig,
               plain: bool = False,
               on_stage: Optional[Callable[[str], None]] = None) -> Tuple[VOState, VOOut]:
    """Everything of ``vo_step`` after the frontend, on a keypoint buffer."""
    stage = on_stage or (lambda _name: None)
    W, PN, OBS_F = vo.window, vo.pts_per_frame, vo.obs_per_frame
    P = W * PN
    dev = state.Rs.device
    f32, i32 = torch.float32, torch.int32
    kp_uv = _kp_xy(buf)
    n_kp = buf.valid.sum().to(i32)
    mw = vo.metric_weight - 1.0

    # 2. match new descriptors against the window map
    map_desc = state.Xdesc.reshape(P, 128)
    map_valid = state.Xvalid.reshape(P) > 0
    keep, map_id, dist, dist2 = match_descriptors_dense(
        buf.desc, buf.valid, map_desc, map_valid, metric=vo.match_metric,
        ratio_sq=vo.ratio_sq, plain=plain)
    map_id = map_id.long()
    n_matches = keep.sum().to(i32)
    # 2b. tracking loss: re-gate the same distances with the looser ratio
    finite = dist2 < float(INT_MAX)
    keep_loose = buf.valid & finite & (dist2 > 0) & (dist < vo.reloc_ratio_sq * dist2)
    strict_ok = n_matches >= vo.min_track_matches
    use_loose = (~strict_ok) & (keep_loose.sum() >= vo.min_track_matches)
    keep_pnp = torch.where(use_loose, keep_loose, keep)
    stage("match")

    # 3. robust pose refinement on the best pnp_n matches
    score = torch.where(keep_pnp, -dist, -torch.inf)
    sel = _top_k(score, vo.pnp_n)
    tri_flat = state.tri_par.reshape(P)
    X_flat = state.X.reshape(P, 3)
    w_sel = keep_pnp[sel].to(f32)
    met_sel = (tri_flat[map_id[sel]] > 0).to(f32)
    w_sel = w_sel * (1.0 + mw * met_sel)
    uv_sel = kp_uv[sel]
    X_sel = X_flat[map_id[sel]]
    R_prev = state.Rs[W - 1]
    t_prev = state.ts[W - 1]
    R_fit, t_fit, rms = pnp_refine(K, R_prev, t_prev, X_sel, uv_sel, w_sel,
                                   iters=vo.pnp_iters, huber_px=vo.huber_px)
    tracked = ((w_sel > 0).to(f32).sum() >= vo.min_track_matches) & (rms < vo.max_rms_px)
    R_new = torch.where(tracked, R_fit, R_prev)
    t_new = torch.where(tracked, t_fit, t_prev)
    stage("pnp")

    # 4a. roll the window; stored ids shift one frame down
    Rs = torch.cat([state.Rs[1:], R_new[None]])
    ts = torch.cat([state.ts[1:], t_new[None]])
    obs_pt_shift = state.obs_pt - PN          # ids < 0 fell off the window
    obs_w_old = state.obs_w * (obs_pt_shift >= 0)
    obs_pt_old = torch.clamp(obs_pt_shift, min=0)

    # 4b. new observation block: best OBS_F matched keypoints of this frame
    osel = _top_k(score, OBS_F)
    ow = keep_pnp[osel].to(f32)
    met_o = (tri_flat[map_id[osel]] > 0).to(f32)
    ow = ow * (1.0 + mw * met_o)
    ouv = kp_uv[osel]
    opt = torch.clamp(map_id[osel] - PN, min=0)
    ow = ow * (map_id[osel] - PN >= 0)
    obs_uv = torch.cat([state.obs_uv[1:], ouv[None]])
    obs_pt = torch.cat([obs_pt_old[1:], opt.to(i32)[None]])
    obs_w = torch.cat([obs_w_old[1:], ow[None]])

    # 4c. spawn the new PN-point block: carry-overs of still-tracked points
    # of the dying block, keyframe-triangulated landmarks when the parallax
    # gate passes, median-depth backprojections otherwise
    Xc_sel = X_sel @ R_new.T + t_new
    depths = torch.where(w_sel > 0, Xc_sel[:, 2], torch.nan)
    med_depth = torch.nan_to_num(torch.nanquantile(depths, 0.5), nan=5.0)
    med_depth = torch.clamp(med_depth, 0.5, 100.0)
    carried_raw = keep_pnp & (map_id < PN)
    # one carry per dying map id: the best-distance claimant wins
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
    Xbp = _backproject(K, R_new, t_new, nuv, med_depth.expand(PN))
    # triangulate against the spawn keyframe (real parallax), not the
    # previous frame
    pk, pidx, _, _ = match_descriptors_dense(
        buf.desc[nsel], nok > 0, state.key_desc, state.key_valid,
        metric=vo.match_metric, ratio_sq=vo.ratio_sq, plain=plain)
    uv_key = state.key_uv[pidx.long()]
    Xtri, z_key, z_new = triangulate_two_view(K, state.key_R, state.key_t, K, R_new, t_new,
                                              uv_key, nuv)
    # rotation-compensated parallax
    ray_new = _rays(K, uv_key) @ (R_new @ state.key_R.T).T
    uv_rot = torch.stack([K[0, 0] * ray_new[:, 0] / ray_new[:, 2] + K[0, 2],
                          K[1, 1] * ray_new[:, 1] / ray_new[:, 2] + K[1, 2]], -1)
    parallax = torch.linalg.vector_norm(nuv - uv_rot, dim=-1)
    tri_ok = (pk & ~car & (parallax > vo.min_parallax_px)
              & (z_key > 0.2 * med_depth) & (z_new > 0.2 * med_depth)
              & (z_key < 10.0 * med_depth) & (z_new < 10.0 * med_depth))
    X_car = X_flat[map_id[nsel]]
    par_car = tri_flat[map_id[nsel]]
    Xnew = torch.where(car[:, None], X_car, torch.where(tri_ok[:, None], Xtri, Xbp))
    X = torch.cat([state.X[1:], Xnew[None]])
    Xvalid = torch.cat([state.Xvalid[1:], nok[None]])
    Xdesc = torch.cat([state.Xdesc[1:], buf.desc[nsel][None]])
    # the spawning frame observes its new points, in the tail of its block
    obs_uv[W - 1, OBS_F - PN:] = nuv
    obs_pt[W - 1, OBS_F - PN:] = (W - 1) * PN + torch.arange(PN, dtype=i32, device=dev)
    spawn_metric = tri_ok | (car & (par_car > 0))
    obs_w[W - 1, OBS_F - PN:] = nok * (1.0 + mw * spawn_metric.to(f32))

    # 4d. deferred two-view triangulation ("depth refresh") from the spawn
    # ray stored in each point's self-observation and the current ray, gated
    # on pose-predicted parallax
    tri_par_new = torch.where(car, par_car, tri_ok.to(f32) * (parallax / K[0, 0]) ** 2)
    tri_par = torch.cat([state.tri_par[1:], tri_par_new[None]])
    if vo.depth_refresh:
        w_src = opt // PN
        j_loc = opt % PN
        sp_idx = w_src * OBS_F + (OBS_F - PN) + j_loc
        sp_uv = obs_uv.reshape(W * OBS_F, 2)[sp_idx]
        # a zero spawn-slot weight means no spawn pixel was ever recorded
        sp_w = obs_w.reshape(W * OBS_F)[sp_idx]
        R_src = Rs[w_src]
        t_src = ts[w_src]
        c_src = -torch.einsum("nji,nj->ni", R_src, t_src)
        d_src = torch.einsum("nji,nj->ni", R_src, _rays(K, sp_uv))
        d_src = d_src / torch.linalg.vector_norm(d_src, dim=-1, keepdim=True)
        c_cur = -R_new.T @ t_new
        d_cur = _rays(K, ouv) @ R_new            # R^T ray, rows
        d_cur = d_cur / torch.linalg.vector_norm(d_cur, dim=-1, keepdim=True)
        b = c_cur[None, :] - c_src
        m = (d_src * d_cur).sum(-1)
        denom = torch.clamp(1.0 - m * m, min=1e-12)   # sin^2(measured angle)
        bd1 = (b * d_src).sum(-1)
        bd2 = (b * d_cur).sum(-1)
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
               & (denom > 0.25 * min_sin2)
               & (s_len > 0) & (t_len > 0)
               & (z_cur > 0.2 * med_depth) & (z_cur < 10.0 * med_depth))
        U = ((opt[:, None] == torch.arange(P, device=dev)[None, :]) & upd[:, None]).to(f32)
        num = U.T @ X_mid
        den = U.sum(0)
        Xflat = torch.where(den[:, None] > 0, num / torch.clamp(den, min=1.0)[:, None], Xflat)
        X = Xflat.reshape(W, PN, 3)
        # store the parallax actually achieved at refresh
        par_num = U.T @ torch.maximum(exp_sin2, denom)
        tp = tri_par.reshape(P)
        tri_par = torch.where(den > 0, par_num / torch.clamp(den, min=1.0), tp).reshape(W, PN)
    stage("roll_spawn")

    # 5. windowed BA (the two oldest cameras anchor the gauge and the scale)
    params = BAParams(Rs, ts, X.reshape(P, 3))
    obs_pt_flat = obs_pt.reshape(-1)
    obs = BAObs(
        uv=obs_uv.reshape(-1, 2),
        cam=torch.arange(W, dtype=i32, device=dev).repeat_interleave(OBS_F),
        pt=obs_pt_flat,
        w=obs_w.reshape(-1) * Xvalid.reshape(P)[obs_pt_flat.long()],
    )
    free = torch.arange(W, device=dev) > 1
    dense = vo.ba_solver == "dense"
    params2, lam2 = params, state.lam
    cost = torch.zeros((), dtype=f32, device=dev)
    for _ in range(vo.ba_iters):
        params2, lam2, cost, _ = lm_iteration(
            params2, obs, K, lam2, free, huber_px=vo.huber_px, cg_iters=vo.cg_iters,
            n_points=P, cam_blocked=True, pt_onehot=vo.ba_pt_onehot or dense,
            dense_schur=dense)
    stage("ba")

    # keyframe promotion once the expected disparity against the keyframe
    # (or its age) passes the gate
    c_new = -R_new.T @ t_new
    c_key = -state.key_R.T @ state.key_t
    base_px = K[0, 0] * torch.linalg.vector_norm(c_new - c_key) / med_depth
    promote = (base_px > vo.kf_promote_px) | (state.frame - state.key_frame >= vo.kf_max_age)
    rolled = VOState(
        Rs=params2.Rs, ts=params2.ts, X=params2.X.reshape(W, PN, 3),
        Xvalid=Xvalid, Xdesc=Xdesc, obs_uv=obs_uv, obs_pt=obs_pt, obs_w=obs_w,
        prev_desc=buf.desc, prev_uv=kp_uv, prev_valid=buf.valid,
        key_desc=torch.where(promote, buf.desc, state.key_desc),
        key_uv=torch.where(promote, kp_uv, state.key_uv),
        key_valid=torch.where(promote, buf.valid, state.key_valid),
        key_R=torch.where(promote, params2.Rs[W - 1], state.key_R),
        key_t=torch.where(promote, params2.ts[W - 1], state.key_t),
        key_frame=torch.where(promote, state.frame, state.key_frame),
        tri_par=tri_par, lam=lam2, frame=state.frame + 1,
    )
    # on tracking loss hold the whole window; only the previous-frame
    # buffers and the counter advance
    hold = state._replace(prev_desc=buf.desc, prev_uv=kp_uv, prev_valid=buf.valid,
                          frame=state.frame + 1)
    new_state = VOState(*(torch.where(tracked, a, b) for a, b in zip(rolled, hold)))
    out = VOOut(R=new_state.Rs[W - 1], t=new_state.ts[W - 1], n_kp=n_kp,
                n_matches=n_matches, rms_px=rms, ba_cost=cost, tracked=tracked,
                n_spawn_tri=(tri_ok & (nok > 0)).sum().to(i32))
    return new_state, out
