"""Pose from 2D-3D correspondences (PnP).

Port of ``sift_pyocl_tpu/sfm/pnp.py``:

* ``pnp_refine``: pose-only robust LM (Huber) from an initial guess; the
  ``lax.scan`` over iterations is a Python loop;
* ``ransac_pnp``: LM restarts from jittered inits on random 12-point
  subsets, scored by inlier count, the winner refined on its inliers.  The
  hypotheses run batched (``torch.func.vmap`` of ``pnp_refine``).  The
  JAX package draws the jitter and the subsets from a key; here they come
  from a CPU ``torch.Generator`` seeded with `seed` (``pnp_draws``: the
  same rows on the card and the CPU), or from ``draws`` where a caller
  passes them, as the parity tests pass JAX's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import _first_argmax, pose_retract, project, project_jacobians

JITTER = (0.05, 0.05, 0.05, 0.2, 0.2, 0.2)   # std of the init jitter (omega, upsilon)
SUBSET = 12                                   # correspondences a hypothesis refines on


def _residuals_pose(K, R, t, X, uv):
    p, z = project(K, R, t, X)
    return p - uv, z


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6x6 SPD solve; ``solve_ex`` leaves its info flag on the device."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A + 1e-8 * eye, b).result


def pnp_refine(K: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor, X: torch.Tensor,
               uv: torch.Tensor, w: torch.Tensor, iters: int = 10,
               huber_px: float = 3.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Huber-IRLS Gauss-Newton/LM on the pose from the initial (R0, t0):
    X (N, 3), uv (N, 2), w (N,) weights.  Returns (R, t, rms_px_on_inliers).

    The weight multiplies J^T before the product, as in the JAX package, so
    a zero-weight row over a point at z ~ 0 overflows exactly where it does
    there."""
    R, t = R0, t0
    lam = torch.full((), 1e-3, dtype=torch.float32, device=X.device)   # no host copy
    for _ in range(iters):
        r, z = _residuals_pose(K, R, t, X, uv)
        nrm = torch.sqrt((r * r).sum(-1) + 1e-12)
        wr = w * (z > 1e-6) * torch.clamp(huber_px / nrm, max=1.0)
        J, _ = project_jacobians(K, R, t, X)                   # (N, 2, 6)
        JT = J.transpose(1, 2)
        H = torch.einsum("nij,njk->ik", JT * wr[:, None, None], J)
        g = -torch.einsum("nij,nj->i", JT * wr[:, None, None], r)
        H = H + lam * torch.diag(torch.diagonal(H))
        xi = _solve6(H, g)
        R2, t2 = pose_retract(R, t, xi)
        c_old = (wr * (r * r).sum(-1)).sum()
        r2, _ = _residuals_pose(K, R2, t2, X, uv)
        c_new = (wr * (r2 * r2).sum(-1)).sum()
        acc = c_new < c_old
        R = torch.where(acc, R2, R)
        t = torch.where(acc, t2, t)
        lam = torch.where(acc, lam * 0.5, lam * 4.0)
    r, z = _residuals_pose(K, R, t, X, uv)
    nrm2 = (r * r).sum(-1)
    inl = w * (z > 1e-6) * (nrm2 < huber_px**2)
    rms = torch.sqrt((inl * nrm2).sum() / torch.clamp(inl.sum(), min=1.0))
    return R, t, rms


def pnp_draws(seed: int, w: torch.Tensor, n_hypo: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random draws of ``ransac_pnp`` on `w`'s device: (xi (n_hypo, 6)
    init jitter, subset (n_hypo, N) 0/1 rows of SUBSET distinct entries
    with w > 0, by masked Gumbel top-k, as the JAX package draws them).
    The numbers come from a CPU generator seeded with `seed`."""
    n = w.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    xi = torch.randn((n_hypo, 6), generator=gen) * torch.tensor(JITTER)
    u = torch.rand((n_hypo, n), generator=gen).clamp(min=torch.finfo(torch.float32).tiny)
    g = torch.where(w[None, :] > 0, (-torch.log(-torch.log(u))).to(w.device), -torch.inf)
    idx = torch.topk(g, min(SUBSET, n), dim=1).indices
    sub = torch.zeros((n_hypo, n), dtype=torch.float32, device=w.device)
    return xi.to(w.device), sub.scatter_(1, idx, 1.0)


def _inliers(K, R, t, X, uv, w, thresh_px: float) -> torch.Tensor:
    r, z = _residuals_pose(K, R, t, X, uv)
    return (w > 0) & (z > 1e-6) & ((r * r).sum(-1) < thresh_px ** 2)


def ransac_pnp_given_draws(K, R0, t0, X, uv, w, xi, sub, iters: int = 8,
                           thresh_px: float = 4.0):
    """``ransac_pnp`` with its draws (xi (n_hypo, 6), sub (n_hypo, N)):
    pure tensor arithmetic, so it also runs under ``vmap`` (the loop-closure
    probe maps it over frames).  The refine from the init on all points
    rides in the hypotheses' batch as one more row (xi = 0 retracts to the
    init exactly)."""
    n_hypo = xi.shape[0]
    Rj, tj = pose_retract(R0, t0, torch.cat([xi, torch.zeros_like(xi[:1])]))
    refine = torch.func.vmap(lambda R_, t_, w_: pnp_refine(K, R_, t_, X, uv, w_, iters=iters))
    Rs, ts, _ = refine(Rj, tj, torch.cat([sub * w, w[None]]))
    scores = torch.func.vmap(lambda R_, t_: _inliers(K, R_, t_, X, uv, w, thresh_px))(
        Rs, ts).sum(1, dtype=torch.int32)
    best = _first_argmax(scores[:n_hypo]).view(1)
    # the init refine wins ties
    use_a = scores[n_hypo] >= scores.index_select(0, best)[0]
    Rb = torch.where(use_a, Rs[n_hypo], Rs.index_select(0, best)[0])
    tb = torch.where(use_a, ts[n_hypo], ts.index_select(0, best)[0])
    # final refine on the winner's inliers
    inl = _inliers(K, Rb, tb, X, uv, w, thresh_px)
    R, t, _ = pnp_refine(K, Rb, tb, X, uv, inl.to(torch.float32), iters=iters)
    inl = _inliers(K, R, t, X, uv, w, thresh_px)
    return R, t, inl, inl.sum(dtype=torch.int32)


def ransac_pnp(seed: int, K: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor, X: torch.Tensor,
               uv: torch.Tensor, w: torch.Tensor, n_hypo: int = 16, iters: int = 8,
               thresh_px: float = 4.0, draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Robust PnP from the init (R0, t0): X (N, 3), uv (N, 2), w (N,) 0/1.
    ``draws``: (xi, subset) to use in place of ``pnp_draws(seed, w,
    n_hypo)``.  The winner is the first hypothesis of the highest inlier
    count, unless the refine from the init on all points scores at least as
    many; it is refined on its inliers.  No host synchronisation.

    Returns (R, t, inliers (N,) bool, n_inliers () int32)."""
    xi, sub = pnp_draws(seed, w, n_hypo) if draws is None else \
        (d.to(device=X.device, dtype=torch.float32) for d in draws)
    return ransac_pnp_given_draws(K, R0, t0, X, uv, w, xi, sub, iters, thresh_px)
