"""Bundle adjustment with the points sharded over the ranks of a
``torch.distributed`` process group (BASELINE.json config 5).

Port of ``sift_pyocl_tpu/sfm/distributed.py``.  The cameras are replicated
on every rank; each rank holds one block of points and all of their
observations, and runs ``sfm.ba.lm_iteration`` with the group as its
``axis_name``: the camera blocks ((C, 6, 6) + (C, 6) a build, one (C, 6)
vector a CG matvec) and the robust costs are all-reduced over the group,
where the JAX package ``psum``s them over a mesh axis under ``shard_map``.
As in the JAX package's multi-process branch, every rank builds the same
global NumPy problem and keeps its own shard; the point blocks meet again
at the end, so every rank returns the merged points.

Partitioning invariant: all the observations of a point live on that
point's shard, so the point blocks and their updates never travel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops import as_tensor
from ..parallel.multihost import BAMesh, global_ba_mesh
from .ba import BAObs, BAParams, lm_iteration


class ShardedProblem(NamedTuple):
    """Host-built sharded layout (leading axis = shard)."""

    uv: np.ndarray        # (S, Ms, 2)
    cam: np.ndarray       # (S, Ms)
    pt_local: np.ndarray  # (S, Ms) local point index within the shard
    w: np.ndarray         # (S, Ms)
    X: np.ndarray         # (S, Ps, 3) padded point blocks
    pt_rng: np.ndarray    # (S, 2) [start, count) of each shard's points
    p_shard: int          # Ps


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def partition_problem(params: BAParams, obs: BAObs, n_shards: int) -> ShardedProblem:
    """Split points into contiguous ranges with ~balanced observation counts;
    route each observation to its point's shard.  A pure function of the
    problem and `n_shards`, so every rank builds the same layout."""
    pt = _np(obs.pt)
    X = _np(params.X)
    n_pts = X.shape[0]
    counts = np.bincount(pt, weights=_np(obs.w) > 0, minlength=n_pts)
    cum = np.cumsum(counts)
    total = cum[-1] if len(cum) else 0
    bounds = [0]
    for k in range(1, n_shards):
        bounds.append(int(np.searchsorted(cum, total * k / n_shards)))
    bounds.append(n_pts)
    bounds = np.maximum.accumulate(np.array(bounds))

    order = np.argsort(pt, kind="stable")
    pt_s = pt[order]
    shard_sizes_p = [bounds[k + 1] - bounds[k] for k in range(n_shards)]
    p_shard = max(max(shard_sizes_p), 1)

    uvs, cams, pls, ws, Xs, rngs = [], [], [], [], [], []
    m_shard = 0
    per_shard = []
    for k in range(n_shards):
        lo, hi = bounds[k], bounds[k + 1]
        sel = order[(pt_s >= lo) & (pt_s < hi)]
        per_shard.append(sel)
        m_shard = max(m_shard, len(sel))
    m_shard = max(m_shard, 1)
    for k in range(n_shards):
        lo, hi = bounds[k], bounds[k + 1]
        sel = per_shard[k]
        pad = m_shard - len(sel)
        uvs.append(np.pad(_np(obs.uv)[sel], ((0, pad), (0, 0))))
        cams.append(np.pad(_np(obs.cam)[sel], (0, pad)))
        pls.append(np.pad(pt[sel] - lo, (0, pad)))
        ws.append(np.pad(_np(obs.w)[sel], (0, pad)))
        Xp = np.zeros((p_shard, 3), X.dtype)
        Xp[: hi - lo] = X[lo:hi]
        Xs.append(Xp)
        rngs.append([lo, hi - lo])
    return ShardedProblem(
        uv=np.stack(uvs).astype(np.float32),
        cam=np.stack(cams).astype(np.int32),
        pt_local=np.stack(pls).astype(np.int32),
        w=np.stack(ws).astype(np.float32),
        X=np.stack(Xs).astype(np.float32),
        pt_rng=np.array(rngs, np.int32),
        p_shard=p_shard,
    )


def merge_points(sp: ShardedProblem, X_sharded: np.ndarray, n_pts: int) -> np.ndarray:
    out = np.zeros((n_pts, 3), np.float32)
    for k in range(X_sharded.shape[0]):
        lo, cnt = sp.pt_rng[k]
        out[lo : lo + cnt] = X_sharded[k, :cnt]
    return out


class DistributedBA:
    """Sharded LM bundle adjuster over the ranks of ``mesh.group``."""

    def __init__(self, mesh: Optional[BAMesh] = None, huber_px: float = 2.0,
                 cg_iters: int = 30, device: Optional[Union[str, torch.device]] = None):
        if mesh is not None and device is not None:
            raise ValueError("give the device in the mesh or as device=, not both")
        self.mesh = mesh if mesh is not None else global_ba_mesh(device=device)
        self.huber = huber_px
        self.cg_iters = cg_iters

    def run(self, params: BAParams, obs: BAObs, K, fixed_cams=(0,), iters: int = 20,
            lam0: float = 1e-3, verbose: bool = False) -> Tuple[BAParams, List[float]]:
        """`iters` LM iterations from lam0 on this rank's shard.  Every rank
        of the group calls it with the same problem (arrays or tensors) and
        returns the same (params as NumPy arrays, with the merged points;
        the cost before each iteration's step)."""
        mesh = self.mesh
        dev, group = mesh.device, mesh.group
        sp = partition_problem(params, obs, mesh.size)
        k = mesh.rank
        p = BAParams(as_tensor(_np(params.Rs), dev, torch.float32),
                     as_tensor(_np(params.ts), dev, torch.float32),
                     torch.from_numpy(sp.X[k]).to(dev))
        o = BAObs(*(torch.from_numpy(a[k]).to(dev) for a in (sp.uv, sp.cam, sp.pt_local, sp.w)))
        Kd = as_tensor(_np(K), dev, torch.float32)
        free = torch.ones(p.Rs.shape[0], dtype=torch.float32)
        free[list(fixed_cams)] = 0.0
        free = free.to(dev)
        lam = torch.full((), lam0, dtype=torch.float32, device=dev)
        costs = []
        for it in range(iters):
            p, lam, cost, _ = lm_iteration(p, o, Kd, lam, free, huber_px=self.huber,
                                           cg_iters=self.cg_iters, n_points=sp.p_shard,
                                           axis_name=group)
            costs.append(float(cost))
            if verbose:
                print(f"  dist-LM it {it}: cost {costs[-1]:.4f} lam {float(lam):.2e}")
        # the point blocks, gathered as a sum of zero-padded copies: one
        # all-reduce, which every backend takes for CUDA tensors (gloo's
        # all_gather takes only CPU tensors)
        Xs = torch.zeros((mesh.size,) + tuple(p.X.shape), dtype=p.X.dtype, device=dev)
        Xs[k] = p.X
        if group is not None:
            dist.all_reduce(Xs, op=dist.ReduceOp.SUM, group=group)
        X = merge_points(sp, Xs.cpu().numpy(), params.X.shape[0])
        return BAParams(p.Rs.cpu().numpy(), p.ts.cpu().numpy(), X), costs
