"""Multi-view geometry primitives: the part the VO step uses.

Port of ``sift_pyocl_tpu/sfm/geometry.py`` (``hat`` ... ``triangulate_two_view``),
with the same conventions:

* image points are (u, v) = (col, row) pixel coordinates;
* a pose (R, t) maps x_cam = R @ x_world + t (world to camera);
* K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]];
* se(3) tangents xi = (omega, upsilon) act on the left: exp(xi) * pose.

``hat``, ``so3_exp``, ``se3_exp``, ``pose_retract`` and
``_normalize_points`` take any leading batch dimensions (the JAX package
maps them with ``vmap``).  The 8-point, essential and homography functions
come with the SfM slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3), with Taylor guards near zero."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    big = theta2 > 1e-12
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """se(3) (..., 6) = (omega, upsilon) -> (R (..., 3, 3), t (..., 3))."""
    w, u = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    R = so3_exp(w)
    big = theta2 > 1e-12
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    V = _eye3(w) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return R, (V @ u[..., None])[..., 0]


def pose_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def pose_retract(R, t, xi):
    """Left-multiplicative update: exp(xi) o (R, t)."""
    dR, dt = se3_exp(xi)
    return pose_compose(dR, dt, R, t)


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """World points X (..., 3) -> pixels (u, v) (..., 2) and depth.  One pose
    (R (3, 3), t (3,)) for all points, or one per point (R (..., 3, 3),
    t (..., 3): the JAX package's ``vmap(project)``)."""
    Xc = (X @ R.T if R.ndim == 2 else torch.einsum("...ij,...j->...i", R, X)) + t
    z = Xc[..., 2]
    zs = torch.where(z.abs() > 1e-9, z, 1e-9)
    u = K[0, 0] * Xc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / zs + K[1, 2]
    return torch.stack([u, v], -1), z


def project_jacobians(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """Closed-form Jacobians of the reprojection residual at the current
    pose: (Jc (..., 2, 6) wrt xi = (omega, upsilon), Jp (..., 2, 3) wrt X).
    R and t broadcast against X's leading dimensions or are batched alike."""
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = torch.where(z.abs() > 1e-9, z, 1e-9)
    iz = 1.0 / zs
    fx_iz = K[0, 0] * iz
    fy_iz = K[1, 1] * iz
    zero = torch.zeros_like(x)
    A = torch.stack([torch.stack([fx_iz, zero, -fx_iz * x * iz], -1),
                     torch.stack([zero, fy_iz, -fy_iz * y * iz], -1)], -2)
    neg_hat = torch.stack([torch.stack([zero, z, -y], -1),
                           torch.stack([-z, zero, x], -1),
                           torch.stack([y, -x, zero], -1)], -2)
    Jw = A @ neg_hat
    Jc = torch.cat([Jw, A], -1)
    Jp = A @ R
    return Jc, Jp


def backproject(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalized camera rays (..., 3) with z = 1."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y, torch.ones_like(x)], -1)


def _solve3_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve A x = b via the adjugate: A (..., 3, 3), b (..., 3)."""
    a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = a22 * a33 - a23 * a32
    c12 = a13 * a32 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c21 = a23 * a31 - a21 * a33
    c22 = a11 * a33 - a13 * a31
    c23 = a13 * a21 - a11 * a23
    c31 = a21 * a32 - a22 * a31
    c32 = a12 * a31 - a11 * a32
    c33 = a11 * a22 - a12 * a21
    det = a11 * c11 + a12 * c21 + a13 * c31
    det = torch.where(det.abs() > 1e-20, det, 1e-20)
    x0 = c11 * b[..., 0] + c12 * b[..., 1] + c13 * b[..., 2]
    x1 = c21 * b[..., 0] + c22 * b[..., 1] + c23 * b[..., 2]
    x2 = c31 * b[..., 0] + c32 * b[..., 1] + c33 * b[..., 2]
    return torch.stack([x0, x1, x2], -1) / det[..., None]


def triangulate_two_view(K1, R1, t1, K2, R2, t2, uv1, uv2):
    """Linear triangulation of correspondences (N, 2) + (N, 2) -> (N, 3),
    by the closed-form 3x3 normal equations of the four DLT rows; also the
    depths in both cameras for cheirality tests."""
    P1 = K1 @ torch.cat([R1, t1[:, None]], 1)
    P2 = K2 @ torch.cat([R2, t2[:, None]], 1)
    rows = torch.stack([uv1[:, 0, None] * P1[2] - P1[0],
                        uv1[:, 1, None] * P1[2] - P1[1],
                        uv2[:, 0, None] * P2[2] - P2[0],
                        uv2[:, 1, None] * P2[2] - P2[1]], 1)     # (N, 4, 4)
    B = rows[:, :, :3]
    b = -rows[:, :, 3]
    BtB = torch.einsum("nij,nik->njk", B, B) + 1e-12 * _eye3(B)
    Btb = torch.einsum("nij,ni->nj", B, b)
    X = _solve3_batched(BtB, Btb)
    _, z1 = project(K1, R1, t1, X)
    _, z2 = project(K2, R2, t2, X)
    return X, z1, z2


def _normalize_points(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalization with weights w (0/1 mask); returns (pts_n, T).

    pts (N, 2) and w (..., N): one normalization per weight row, pts_n
    (..., N, 2) and T (..., 3, 3)."""
    wsum = torch.clamp(w.sum(-1), min=1.0)
    mean = (pts * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1) + 1e-12)
    sqrt2 = torch.full((), 2.0, dtype=pts.dtype, device=pts.device).sqrt()   # no host copy
    scale = sqrt2 / torch.clamp((d * w).sum(-1) / wsum, min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, zero, -scale * mean[..., 0]], -1),
                     torch.stack([zero, scale, -scale * mean[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    pn = (pts - mean[..., None, :]) * scale[..., None, None]
    return pn, T
