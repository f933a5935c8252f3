"""Multi-view geometry primitives.

Port of ``sift_pyocl_tpu/sfm/geometry.py``, with the same conventions:

* image points are (u, v) = (col, row) pixel coordinates;
* a pose (R, t) maps x_cam = R @ x_world + t (world to camera);
* K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]];
* se(3) tangents xi = (omega, upsilon) act on the left: exp(xi) * pose.

``hat``, ``so3_exp``, ``so3_log``, ``se3_exp``, ``pose_compose``,
``pose_inverse``, ``pose_retract`` and ``_normalize_points`` take any
leading batch dimensions (the JAX package maps them with ``vmap``); the
8-point, homography and error functions take a batch of weight rows or
models, as RANSAC calls them.  SVD and ``eigh`` signs differ between
libraries, so F, E and H agree with the JAX package's up to sign, and
``decompose_essential``'s candidates up to the order of the two rotations.
The eigen- and singular-value decompositions are ``ops.kernels.linalg``'s
``sym_eig_small`` (K12) and ``svd3`` (K13): on the card hand-written
kernels that read nothing back to the host (so a CUDA graph holds them),
on the CPU their plain versions (PyTorch's ``eigh`` and ``svd``).
Nothing here copies a constant from the host either.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.kernels.linalg import svd3, sym_eig_small


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) (..., 3, 3) -> so(3) (..., 3), smooth near the identity: the
    atan2 form, with a Taylor branch of theta / sin(theta) for small angles
    so that forward-mode derivatives at a converged residual stay finite."""
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sqrt((w * w).sum(-1) + 1e-32)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    safe = s > 1e-6
    theta = torch.atan2(s, c)
    scale = torch.where(safe, theta / torch.where(safe, s, 1.0),
                        1.0 + (1.0 - torch.clamp(c, max=1.0)) / 3.0)
    return w * scale[..., None]


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


def pose_inverse(R, t):
    """(R, t)^-1 = (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


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


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of 1-D `x`, as ``jnp.argmax`` (no sync)."""
    pos = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.max(), pos, x.shape[0]).min()


def _det3(A: torch.Tensor) -> torch.Tensor:
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def _smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """(..., 9, 9) symmetric -> (..., 3, 3): the eigenvector of the least
    eigenvalue, reshaped row-major."""
    _, V = sym_eig_small(A)
    return V[..., :, 0].reshape(tuple(A.shape[:-2]) + (3, 3))


def _eight_point_normal(uv1: torch.Tensor, uv2: torch.Tensor, w: torch.Tensor):
    """The (..., 9, 9) A^T A of the 8-point fit's rows on the Hartley-
    normalized points, each weighted by w (..., N), and the normalizations
    (T1, T2)."""
    p1, T1 = _normalize_points(uv1, w)
    p2, T2 = _normalize_points(uv2, w)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
                    -1)                                          # (..., N, 9)
    Aw = A * w[..., None]
    return Aw.transpose(-1, -2) @ Aw, T1, T2


def fit_fundamental_8pt(uv1: torch.Tensor, uv2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point fundamental/essential fit on (N, 2) correspondences,
    one per 0/1 weight row w (..., N): F (..., 3, 3) with ||F|| = 1, rank 2."""
    AtA, T1, T2 = _eight_point_normal(uv1, uv2, w)
    F = _smallest_eigvec(AtA)
    U, S, Vt = svd3(F)                                           # rank-2 projection
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = T2.transpose(-1, -2) @ ((U * S[..., None, :]) @ Vt) @ T1
    return F / torch.clamp(torch.linalg.matrix_norm(F), min=1e-12)[..., None, None]


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1 projected onto the essential manifold (singular values
    1, 1, 0)."""
    U, _, Vt = svd3(K2.T @ F @ K1)
    return torch.cat([U[..., :2], torch.zeros_like(U[..., 2:])], -1) @ Vt


def decompose_essential(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """E (3, 3) -> the 4 candidate poses: R (4, 3, 3), t (4, 3), |t| = 1."""
    U, _, Vt = svd3(E)
    U = U * torch.sign(_det3(U))                 # proper rotations
    Vt = Vt * torch.sign(_det3(Vt))
    # U @ W and U @ W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: columns
    # (u2, -u1, u3) and (-u2, u1, u3)
    u1, u2, u3 = U[:, 0], U[:, 1], U[:, 2]
    R1 = torch.stack([u2, -u1, u3], 1) @ Vt
    R2 = torch.stack([-u2, u1, u3], 1) @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def choose_pose(Rs, ts, K1, K2, uv1, uv2, w):
    """The (R, t) candidate with the most weighted points in front of both
    cameras (the first of equal scores); returns (R, t, score)."""
    eye, zero = _eye3(uv1), torch.zeros(3, dtype=uv1.dtype, device=uv1.device)
    scores = []
    for R, t in zip(Rs, ts):
        _, z1, z2 = triangulate_two_view(K1, eye, zero, K2, R, t, uv1, uv2)
        scores.append((((z1 > 0) & (z2 > 0)) * w).sum())
    scores = torch.stack(scores)
    best = _first_argmax(scores).view(1)
    return Rs.index_select(0, best)[0], ts.index_select(0, best)[0], scores.index_select(0, best)[0]


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[:, :1])], 1)


def sampson_error_F(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error of x2' F x1 per correspondence,
    for F (..., 3, 3): (..., N)."""
    x1, x2 = _homogeneous(uv1), _homogeneous(uv2)
    Fx1 = x1 @ F.transpose(-1, -2)            # F @ x1
    Ftx2 = x2 @ F                              # F^T @ x2
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _dlt_normal(uv1: torch.Tensor, uv2: torch.Tensor, w: torch.Tensor):
    """The (..., 9, 9) A^T A of the DLT's two rows a point on the Hartley-
    normalized points, each weighted by w (..., N), and the normalizations
    (T1, T2)."""
    p1, T1 = _normalize_points(uv1, w)
    p2, T2 = _normalize_points(uv2, w)
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)    # (..., 2N, 9)
    return A.transpose(-1, -2) @ A, T1, T2


def fit_homography(uv1: torch.Tensor, uv2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT homography uv2 ~ H uv1 on (N, 2), one per weight row w
    (..., N): H (..., 3, 3) with H[2, 2] = 1."""
    AtA, T1, T2 = _dlt_normal(uv1, uv2, w)
    H = _smallest_eigvec(AtA)
    H = torch.linalg.inv_ex(T2).inverse @ H @ T1
    h = H[..., 2, 2]
    return H / torch.where(h.abs() > 1e-12, h, 1e-12)[..., None, None]


def homography_error(H: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Forward transfer error |H x1 - x2|^2 per point, for H (..., 3, 3):
    (..., N)."""
    p = _homogeneous(uv1) @ H.transpose(-1, -2)
    d = p[..., 2:3]
    p = p[..., :2] / torch.where(d.abs() > 1e-12, d, 1e-12)
    return ((p - uv2) ** 2).sum(-1)
