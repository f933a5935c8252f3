"""Pose from 2D-3D correspondences: pose-only robust LM.

Port of ``sift_pyocl_tpu/sfm/pnp.py::pnp_refine``; the ``lax.scan`` over
iterations is a Python loop.  ``ransac_pnp`` comes with the SfM slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .geometry import pose_retract, project, project_jacobians


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
