"""Sparse bundle adjustment: Levenberg-Marquardt with a Schur-complement
solve.

Port of ``sift_pyocl_tpu/sfm/ba.py`` (single device).  Observations are
(M,) rows of (cam, pt, uv, w), 0-weight padding allowed.  Per-observation
2x6 / 2x3 Jacobian blocks are closed-form; the reduced camera system S =
U - W V^-1 W^T is applied matrix-free by CG, or (``dense_schur``) assembled
as a (6C, 6C) matrix and solved exactly.  Reductions over observations, by
layout:

* the scatter form (the defaults, ``cam_blocked=False``,
  ``pt_onehot=False``): segment sums over the observations sorted by id
  once per iteration (``segment.segment_sum``: the JAX package's
  ``segment_sum``, in an order that does not depend on float atomics) and
  gathers;
* ``cam_blocked=True``: observations in per-camera blocks (``obs.cam ==
  repeat(arange(C), M // C)``, the VO window), so camera sums are a reshape
  and a sum;
* ``pt_onehot=True``: point sums and gathers as products with a one-hot
  (P, M) matrix.

The products, einsums and solves are plain PyTorch, as they were plain XLA
outside any Pallas kernel in the JAX package.

``axis_name`` is None (one device) or a ``torch.distributed`` process group
whose ranks each hold one shard of the points and their observations (the
cameras replicated, ``sfm/distributed.py``): the sums over observations
that reach a camera, and the robust cost, are then all-reduced over the
group, where the JAX package ``psum``s them over a mesh axis.  An LM
iteration all-reduces 4 + ``cg_iters`` times: the cost, ``U`` with
``g_c`` (one flattened tensor), the Schur right-hand side, each CG
matvec's camera sums and the candidate's cost.

The JAX package jits ``lm_iteration``, one program per shape and static
arguments.  On a CUDA card ``run_ba`` likewise replays one CUDA graph of
one iteration (``LM_GRAPHS``, ``lm_iteration_replayed``) per (device,
shapes of the parameters and observations, huber_px, cg_iters, n_points,
layout), once an iteration: the segment layouts (a stable sort,
``searchsorted``) and the segment sums are made inside it and sync no
host.  The eager loop (``_run_ba_eager``) is what the CPU runs.  A group
(``axis_name``) stays eager: a gloo all-reduce cannot be captured.  The
VO step calls ``lm_iteration`` itself, inside its own graph.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import as_tensor, device_of
from ..utils import graphs
from .geometry import pose_retract, project, project_jacobians
from .segment import Segments, segment_sum, segments


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


def _psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """x summed over the ranks of process group `axis_name` (in place), or x
    where it is None."""
    if axis_name is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis_name)
    return x


def _seg_cam(vals: torch.Tensor, seg: Optional[Segments], n_cams: int) -> torch.Tensor:
    """Per-camera sums of per-observation blocks: a reshape and a sum in the
    blocked layout (`seg` None), else a segment sum."""
    if seg is None:
        return vals.reshape((n_cams, -1) + tuple(vals.shape[1:])).sum(1)
    return segment_sum(vals, seg)


def _take_cam(x: torch.Tensor, seg: Optional[Segments], m: int) -> torch.Tensor:
    """x[cam]: in the blocked layout each camera's row repeated M/C times."""
    if seg is not None:
        return x[seg.ids]
    reps = m // x.shape[0]
    return x[:, None].expand((x.shape[0], reps) + tuple(x.shape[1:])).reshape(
        (m,) + tuple(x.shape[1:]))


def _pt_onehot_matrix(pt: torch.Tensor, n_points: int) -> torch.Tensor:
    """(P, M) f32 one-hot of obs.pt; pt < 0 columns are all zero."""
    ids = torch.arange(n_points, dtype=pt.dtype, device=pt.device)
    return (pt[None, :] == ids[:, None]).to(torch.float32)


def _seg_pt(vals: torch.Tensor, seg: Optional[Segments], G: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-point sums: G @ vals with the one-hot G, else a segment sum."""
    if G is None:
        return segment_sum(vals, seg)
    out = G @ vals.reshape(vals.shape[0], -1)
    return out.reshape((G.shape[0],) + tuple(vals.shape[1:]))


def _take_pt(y: torch.Tensor, seg: Optional[Segments], G: Optional[torch.Tensor]) -> torch.Tensor:
    """y[pt]; as G^T @ y with the one-hot G (pt < 0 rows read zero; their W
    blocks are zero)."""
    if G is None:
        return y[seg.ids]
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


def robust_cost(r: torch.Tensor, w: torch.Tensor, huber_px: float, axis_name=None
                ) -> torch.Tensor:
    """Sum of Huber losses (the objective of the accept/reject test), over
    the group's ranks where `axis_name` is one."""
    n2 = (r * r).sum(-1)
    nrm = torch.sqrt(n2 + 1e-12)
    quad = 0.5 * n2
    lin = huber_px * (nrm - 0.5 * huber_px)
    return _psum((w * torch.where(nrm <= huber_px, quad, lin)).sum(), axis_name)


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
    G: Optional[torch.Tensor]                 # (P, M) one-hot of obs.pt when pt_onehot
    cam_seg: Optional[Segments] = None        # camera segments unless cam_blocked
    pt_seg: Optional[Segments] = None         # point segments unless pt_onehot


def build_system(params: BAParams, obs: BAObs, K: torch.Tensor, lam: torch.Tensor,
                 huber_px: float, n_points: int, axis_name=None, cam_blocked: bool = False,
                 pt_onehot: bool = False) -> Tuple[_System, torch.Tensor]:
    """Weighted, damped normal-equation blocks; returns (system, robust cost).
    The weight multiplies each block after its product, as in the JAX
    package.  With a group `axis_name`, `n_points` is the shard's point
    count, and U, g_c and the cost are sums over its ranks."""
    r = residuals(params, obs, K)
    wq = robust_weights(r, obs.w, huber_px)
    cost = robust_cost(r, obs.w, huber_px, axis_name)
    Jc, Jp = project_jacobians(K, _gather(params.Rs, obs.cam), _gather(params.ts, obs.cam),
                               _gather(params.X, obs.pt))
    n_cams = params.Rs.shape[0]
    cam_seg = None if cam_blocked else segments(obs.cam, n_cams)
    G, pt_seg = (_pt_onehot_matrix(obs.pt, n_points), None) if pt_onehot else \
        (None, segments(obs.pt, n_points))
    JcT = Jc.transpose(1, 2)
    JpT = Jp.transpose(1, 2)
    wq_ = wq[:, None, None]
    Um = wq_ * (JcT @ Jc)
    Vm = wq_ * (JpT @ Jp)
    W = wq_ * (JcT @ Jp)
    gcm = -(wq[:, None] * torch.einsum("mij,mj->mi", JcT, r))
    gpm = -(wq[:, None] * torch.einsum("mij,mj->mi", JpT, r))
    U = _seg_cam(Um, cam_seg, n_cams)
    g_c = _seg_cam(gcm, cam_seg, n_cams)
    if axis_name is not None:       # one all-reduce for both: the same sums
        Ug = _psum(torch.cat([U.reshape(-1), g_c.reshape(-1)]), axis_name)
        U, g_c = Ug[:U.numel()].view_as(U), Ug[U.numel():].view_as(g_c)
    V = _seg_pt(Vm, pt_seg, G)
    g_p = _seg_pt(gpm, pt_seg, G)
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
    # Marquardt damping: lam * (diag + small identity floor)
    U = U + lam * (eye6 * torch.diagonal(U, dim1=1, dim2=2)[:, :, None] * eye6 + 1e-8 * eye6)
    V = V + lam * (eye3 * torch.diagonal(V, dim1=1, dim2=2)[:, :, None] * eye3 + 1e-8 * eye3)
    return _System(U, _inv3(V), W, g_c, g_p, G, cam_seg, pt_seg), cost


def _schur_matvec(sys: _System, x: torch.Tensor, free: torch.Tensor, axis_name=None
                  ) -> torch.Tensor:
    """S x with S = U - W V^-1 W^T, never assembled (the W V^-1 W^T part
    summed over the group's ranks)."""
    x = x * free[:, None]
    m = sys.W.shape[0]
    u = torch.einsum("mij,mi->mj", sys.W, _take_cam(x, sys.cam_seg, m))
    q = _seg_pt(u, sys.pt_seg, sys.G)
    y = torch.einsum("pij,pj->pi", sys.Vinv, q)
    z = torch.einsum("mij,mj->mi", sys.W, _take_pt(y, sys.pt_seg, sys.G))
    acc = _psum(_seg_cam(z, sys.cam_seg, x.shape[0]), axis_name)
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


def solve_step(sys: _System, free: torch.Tensor, cg_iters: int = 30, axis_name=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped step by matrix-free CG: camera (C, 6) and point (P, 3)
    updates, in the system's layout (the camera side summed over the
    group's ranks, the point side the shard's own)."""
    m = sys.W.shape[0]
    y = torch.einsum("pij,pj->pi", sys.Vinv, sys.g_p)
    z = torch.einsum("mij,mj->mi", sys.W, _take_pt(y, sys.pt_seg, sys.G))
    red = _psum(_seg_cam(z, sys.cam_seg, sys.g_c.shape[0]), axis_name)
    b = (sys.g_c - red) * free[:, None]
    dc = _cg(lambda x: _schur_matvec(sys, x, free, axis_name), b, cg_iters)
    u = torch.einsum("mij,mi->mj", sys.W, _take_cam(dc, sys.cam_seg, m))
    q = _seg_pt(u, sys.pt_seg, sys.G)
    dp = torch.einsum("pij,pj->pi", sys.Vinv, sys.g_p - q)
    return dc, dp


def apply_step(params: BAParams, dc: torch.Tensor, dp: torch.Tensor) -> BAParams:
    Rs, ts = pose_retract(params.Rs, params.ts, dc)
    return BAParams(Rs, ts, params.X + dp)


def lm_iteration(params: BAParams, obs: BAObs, K: torch.Tensor, lam: torch.Tensor,
                 free: torch.Tensor, huber_px: float = 2.0, cg_iters: int = 30,
                 n_points: int = 0, axis_name=None, cam_blocked: bool = False,
                 pt_onehot: bool = False, dense_schur: bool = False):
    """One accept/reject LM iteration.  Returns (params, lam, cost, accepted).

    ``free`` (C,) marks the cameras that move (the rest are the gauge).
    ``cam_blocked`` / ``pt_onehot`` pick the reductions (module docstring);
    ``dense_schur`` solves the reduced camera system exactly instead of by
    CG and needs both.  ``axis_name``: None, or the process group over
    whose ranks the points are sharded (``n_points`` the shard's count);
    every rank returns the same cameras, lam, cost and flag."""
    if dense_schur and not (cam_blocked and pt_onehot):
        raise ValueError("dense_schur needs cam_blocked and pt_onehot")
    if dense_schur and axis_name is not None:
        raise ValueError("dense_schur runs on one device: it takes no axis_name")
    free = free.to(torch.float32)
    nP = n_points or params.X.shape[0]
    sys, cost = build_system(params, obs, K, lam, huber_px, nP, axis_name, cam_blocked, pt_onehot)
    dc, dp = solve_step_dense(sys, free) if dense_schur else \
        solve_step(sys, free, cg_iters, axis_name)
    cand = apply_step(params, dc, dp)
    new_cost = robust_cost(residuals(cand, obs, K), obs.w, huber_px, axis_name)
    accept = new_cost < cost
    params = BAParams(*(torch.where(accept, a, b) for a, b in zip(cand, params)))
    lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-9), torch.clamp(lam * 4.0, max=1e6))
    return params, lam, cost, accept


def _lm_flat(static, Rs, ts, X, lam, uv, cam, pt, w, K, free):
    """One ``lm_iteration`` from flat inputs (a graph body): (Rs, ts, X,
    lam, cost, accepted)."""
    huber_px, cg_iters, n_points, cam_blocked, pt_onehot, dense_schur = static
    params, lam, cost, acc = lm_iteration(BAParams(Rs, ts, X), BAObs(uv, cam, pt, w), K, lam,
                                          free, huber_px=huber_px, cg_iters=cg_iters,
                                          n_points=n_points, cam_blocked=cam_blocked,
                                          pt_onehot=pt_onehot, dense_schur=dense_schur)
    return (*params, lam, cost, acc)


# one LM iteration on the card: one CUDA graph per (device, shapes of the
# parameters and observations, static arguments), as the JAX package jits
# ``lm_iteration`` (its ``_ba_rounds_packed`` loops that one program)
LM_GRAPHS = graphs.GraphCache(_lm_flat)


def lm_iteration_replayed(params: BAParams, obs: BAObs, K: torch.Tensor, lam: torch.Tensor,
                          free: torch.Tensor, huber_px: float = 2.0, cg_iters: int = 30,
                          n_points: int = 0, cam_blocked: bool = False,
                          pt_onehot: bool = False, dense_schur: bool = False):
    """``lm_iteration`` on one device (no group), its tensors on one CUDA
    card: the replay of its graph (``LM_GRAPHS``).  The inputs are copied
    into the graph's buffer; the results are views of one fresh buffer."""
    static = (float(huber_px), int(cg_iters), int(n_points or params.X.shape[0]),
              bool(cam_blocked), bool(pt_onehot), bool(dense_schur))
    Rs, ts, X, lam, cost, acc = LM_GRAPHS(params.Rs.device, static,
                                          (*params, lam, *obs, K, free.to(torch.float32)))
    return BAParams(Rs, ts, X), lam, cost, acc


def _ba_inputs(params, obs, K, fixed_cams, device):
    """run_ba's tensors on its device: params and observations as f32 /
    int32, K, and the (C,) free-camera mask."""
    dev = device_of(params.Rs, device)
    params = BAParams(*(as_tensor(x, dev, torch.float32) for x in params))
    obs = BAObs(as_tensor(obs.uv, dev, torch.float32), as_tensor(obs.cam, dev, torch.int32),
                as_tensor(obs.pt, dev, torch.int32), as_tensor(obs.w, dev, torch.float32))
    free = torch.ones(params.Rs.shape[0], dtype=torch.float32)
    free[list(fixed_cams)] = 0.0
    return dev, params, obs, as_tensor(K, dev, torch.float32), free.to(dev)


def run_ba(params: BAParams, obs: BAObs, K, fixed_cams=(0,), iters: int = 20,
           huber_px: float = 2.0, cg_iters: int = 30, lam0: float = 1e-3,
           verbose: bool = False, fetch_costs: bool = True, device=None
           ) -> Tuple[BAParams, List[float]]:
    """The LM loop over the scatter form with CG, from lam0.  Returns
    (params, costs): the cost before each iteration's step, or with
    ``fetch_costs=False`` only the last (one host read instead of one an
    iteration).  Tensors or arrays; on `device` where given, else on
    params.Rs's device if it is a tensor, else on the CUDA card (raises
    without one).  On a card each iteration replays one graph
    (``lm_iteration_replayed``: the segment layouts are made inside it,
    with no host sync); elsewhere the eager loop, ``_run_ba_eager``."""
    dev, params, obs, K, free = _ba_inputs(params, obs, K, fixed_cams, device)
    step = lm_iteration_replayed if dev.type == "cuda" else lm_iteration
    return _lm_loop(step, params, obs, K, free, iters, huber_px, cg_iters, lam0, verbose,
                    fetch_costs)


def _run_ba_eager(params: BAParams, obs: BAObs, K, fixed_cams=(0,), iters: int = 20,
                  huber_px: float = 2.0, cg_iters: int = 30, lam0: float = 1e-3,
                  verbose: bool = False, fetch_costs: bool = True, device=None
                  ) -> Tuple[BAParams, List[float]]:
    """``run_ba`` with every iteration the eager ``lm_iteration`` (what
    its graph captures)."""
    dev, params, obs, K, free = _ba_inputs(params, obs, K, fixed_cams, device)
    return _lm_loop(lm_iteration, params, obs, K, free, iters, huber_px, cg_iters, lam0,
                    verbose, fetch_costs)


def _lm_loop(step, params, obs, K, free, iters, huber_px, cg_iters, lam0, verbose,
             fetch_costs):
    lam = torch.full((), lam0, dtype=torch.float32, device=free.device)
    costs, cost = [], None
    for it in range(iters):
        params, lam, cost, acc = step(params, obs, K, lam, free, huber_px=huber_px,
                                      cg_iters=cg_iters, n_points=params.X.shape[0])
        if fetch_costs:
            costs.append(float(cost))
        if verbose:
            print(f"  LM it {it}: cost {float(cost):.4f} lam {float(lam):.2e} acc {bool(acc)}")
    if not fetch_costs and cost is not None:
        costs.append(float(cost))
    return params, costs
