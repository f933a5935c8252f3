"""Trajectory evaluation: ATE with Umeyama (sim(3)) alignment.

A NumPy copy of ``sift_pyocl_tpu/sfm/evaluate.py`` (importing the JAX
package imports jax); ``tests/test_torch_config.py`` holds it equal to the
original.
"""

from __future__ import annotations

import numpy as np


def camera_centers(Rs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """World-space camera centers from world-to-camera (R, t): c = -R^T t."""
    return -np.einsum("cij,ci->cj", np.asarray(Rs), np.asarray(ts))


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing ||s R src + t - dst||^2."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             with_scale: bool = True) -> float:
    """RMSE of aligned camera centers (the ATE metric)."""
    s, R, t = umeyama_align(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(axis=1).mean()))
