"""Pose-graph optimization over SE(3).

Port of ``sift_pyocl_tpu/sfm/posegraph.py``.  Given relative pose
measurements Z_ij, optimize absolute world-to-camera poses T_i minimizing
the Huber-weighted sum of || log(Z_ij * T_i * T_j^-1) ||^2 by Gauss-Newton
with a dense 6C x 6C system.

The edge Jacobians are forward-mode derivatives of the residual through
``pose_retract`` at zero, as ``jax.jacfwd`` takes them there: one
``torch.func.jvp`` of all edges' residuals a tangent direction, the six
directions under ``vmap``.  (A ``vmap`` over edges would run each edge's
arithmetic on 0-d tensors, whose forward-mode tangents PyTorch promotes to
float64 where a Python float is added.)  The normal matrix and gradient are sums of edge
blocks over repeated camera ids, taken by ``segment.segment_sum``, so they
do not depend on the order of float atomics on the card.

The JAX package jits the solve with ``iters`` static and a ``lax.scan``
over the Gauss-Newton steps.  Every step of a call has one shape, so on a
CUDA card ``optimize_pose_graph`` replays one CUDA graph of one step
(``POSEGRAPH_GRAPHS``, ``_pose_graph_flat``) per (device, C, E, huber),
``iters`` times, the carry (Rs, ts, lam) fed back; the segment layouts
(a stable sort, ``searchsorted``) are made inside it and sync no host.
The eager loop (``_optimize_pose_graph_eager``) is what the CPU runs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import graphs
from .geometry import pose_compose, pose_inverse, pose_retract, so3_log
from .segment import Segments, segment_sum, segments


class PoseGraph(NamedTuple):
    """Static-capacity edge list."""

    i: torch.Tensor      # (E,) int32 source camera
    j: torch.Tensor      # (E,) int32 target camera
    Z_R: torch.Tensor    # (E, 3, 3) measured relative rotation (i -> j)
    Z_t: torch.Tensor    # (E, 3) measured relative translation
    w: torch.Tensor      # (E,) f32 edge weight (0 = padding)


def relative_pose(Ri, ti, Rj, tj):
    """Z = T_j * T_i^-1: the i -> j transform."""
    Rinv, tinv = pose_inverse(Ri, ti)
    return pose_compose(Rj, tj, Rinv, tinv)


def _edge_residual(Ri, ti, Rj, tj, ZR, Zt):
    """6-vector log residual of T_j against Z * T_i."""
    PR, Pt = pose_compose(ZR, Zt, Ri, ti)          # predicted T_j
    JR, Jt = pose_inverse(Rj, tj)
    ER, Et = pose_compose(PR, Pt, JR, Jt)          # E = pred * T_j^-1
    return torch.cat([so3_log(ER), Et], -1)


def _retracted_residual(xi_i, xi_j, Ri, ti, Rj, tj, ZR, Zt):
    return _edge_residual(*pose_retract(Ri, ti, xi_i), *pose_retract(Rj, tj, xi_j), ZR, Zt)


def _edge_jacobians(Ri, ti, Rj, tj, ZR, Zt) -> Tuple[torch.Tensor, torch.Tensor]:
    """d residual / d xi_i and d residual / d xi_j at zero, (E, 6, 6) each."""
    zero = torch.zeros(ti.shape[:-1] + (6,), dtype=ti.dtype, device=ti.device)
    basis = torch.eye(6, dtype=ti.dtype, device=ti.device)[:, None, :].expand((6,) + zero.shape)

    def jac(fn):
        cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (zero,), (v,))[1])(basis)
        return cols.permute(1, 2, 0)            # (E, residual, direction)

    return (jac(lambda xi: _retracted_residual(xi, zero, Ri, ti, Rj, tj, ZR, Zt)),
            jac(lambda xi: _retracted_residual(zero, xi, Ri, ti, Rj, tj, ZR, Zt)))


def _layouts(i: torch.Tensor, j: torch.Tensor, C: int) -> Tuple[Segments, Segments]:
    """The segment layouts of the gradient (camera ids) and of the normal
    matrix's (c, d) blocks; no host synchronisation."""
    # H[c, :, d, :] gathers the blocks of the (c, d) pairs (i, i), (j, j), (i, j), (j, i)
    return (segments(torch.cat([i, j]), C),
            segments(torch.cat([i * C + i, j * C + j, i * C + j, j * C + i]), C * C))


def _gn_step(Rs, ts, lam, i, j, Z_R, Z_t, w, free, seg_g, seg_H, huber: float):
    """One Gauss-Newton step with the Levenberg damping `lam`: (Rs, ts, lam,
    the candidate step's cost); the step is taken where it lowers the
    cost."""
    C = Rs.shape[0]
    fm = free[:, None].expand(C, 6).reshape(-1)
    eye = torch.eye(6 * C, dtype=torch.float32, device=Rs.device)

    def residual_all(Rs, ts):
        return _edge_residual(Rs[i], ts[i], Rs[j], ts[j], Z_R, Z_t)    # (E, 6)

    def weights(r):
        nrm = torch.sqrt((r * r).sum(-1) + 1e-12)
        return w * torch.clamp(huber / nrm, max=1.0)

    r = residual_all(Rs, ts)
    wr = weights(r)
    Ji, Jj = _edge_jacobians(Rs[i], ts[i], Rs[j], ts[j], Z_R, Z_t)
    JiT = Ji.transpose(1, 2) * wr[:, None, None]
    JjT = Jj.transpose(1, 2) * wr[:, None, None]
    blocks = torch.cat([JiT @ Ji, JjT @ Jj, JiT @ Jj, JjT @ Ji])
    H = segment_sum(blocks, seg_H).reshape(C, C, 6, 6).permute(0, 2, 1, 3)
    g = segment_sum(torch.cat([-torch.einsum("eij,ej->ei", JiT, r),
                               -torch.einsum("eij,ej->ei", JjT, r)]), seg_g)
    # gauge: project out fixed cameras
    Hm = H.reshape(6 * C, 6 * C) * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    Hm = Hm + lam * torch.diag(torch.diagonal(Hm)) + 1e-8 * eye
    dx = torch.linalg.solve_ex(Hm, g.reshape(-1) * fm).result.reshape(C, 6) * free[:, None]
    Rs2, ts2 = pose_retract(Rs, ts, dx)
    c_old = (wr * (r * r).sum(-1)).sum()
    r2 = residual_all(Rs2, ts2)
    c_new = (weights(r2) * (r2 * r2).sum(-1)).sum()
    acc = c_new < c_old
    return (torch.where(acc, Rs2, Rs), torch.where(acc, ts2, ts),
            torch.where(acc, lam * 0.5, lam * 4.0), c_new)


def _pose_graph_flat(static, Rs, ts, lam, i, j, Z_R, Z_t, w, free):
    """One Gauss-Newton step from flat inputs (a graph body), its segment
    layouts made here: (Rs, ts, lam, the candidate step's cost)."""
    (huber,) = static
    i, j = i.long(), j.long()
    return _gn_step(Rs, ts, lam, i, j, Z_R, Z_t, w, free, *_layouts(i, j, Rs.shape[0]), huber)


# one Gauss-Newton step on the card: one CUDA graph per (device, C, E,
# huber), as the JAX package jits ``optimize_pose_graph`` (its ``lax.scan``
# loops that one step)
POSEGRAPH_GRAPHS = graphs.GraphCache(_pose_graph_flat)


def _pose_graph_inputs(Rs, ts, graph: PoseGraph, free):
    dev = Rs.device
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    return (Rs, ts, lam, graph.i.to(dev), graph.j.to(dev), *(x.to(dev, torch.float32) for x in (
        graph.Z_R, graph.Z_t, graph.w, free)))


def optimize_pose_graph(Rs: torch.Tensor, ts: torch.Tensor, graph: PoseGraph, free: torch.Tensor,
                        iters: int = 15, huber: float = 0.1
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gauss-Newton pose-graph solve from (Rs (C, 3, 3), ts (C, 3));
    `free` (C,) 1 = optimize, 0 = fixed (gauge).  Returns (Rs, ts, the
    cost after the last iteration's candidate step).  On a CUDA device each
    iteration replays one graph (``POSEGRAPH_GRAPHS``: one key per (C, E,
    huber)); elsewhere the eager loop, ``_optimize_pose_graph_eager``.  No
    host synchronisation."""
    if Rs.device.type != "cuda":
        return _optimize_pose_graph_eager(Rs, ts, graph, free, iters, huber)
    Rs, ts, lam, *edges = _pose_graph_inputs(Rs, ts, graph, free)
    cost = torch.zeros((), dtype=torch.float32, device=Rs.device)
    for _ in range(iters):
        Rs, ts, lam, cost = POSEGRAPH_GRAPHS(Rs.device, (float(huber),), (Rs, ts, lam, *edges))
    return Rs, ts, cost


def _optimize_pose_graph_eager(Rs: torch.Tensor, ts: torch.Tensor, graph: PoseGraph,
                               free: torch.Tensor, iters: int = 15, huber: float = 0.1
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``optimize_pose_graph`` op by op, the segment layouts made once (what
    its graph captures an iteration)."""
    Rs, ts, lam, i, j, *edges = _pose_graph_inputs(Rs, ts, graph, free)
    i, j = i.long(), j.long()
    layouts = _layouts(i, j, Rs.shape[0])
    cost = torch.zeros((), dtype=torch.float32, device=Rs.device)
    for _ in range(iters):
        Rs, ts, lam, cost = _gn_step(Rs, ts, lam, i, j, *edges, *layouts, float(huber))
    return Rs, ts, cost
