"""Static-shape batched RANSAC in PyTorch.

Port of ``sift_pyocl_tpu/sfm/ransac.py``: ``ransac`` and its affine,
homography and essential forms.  All hypotheses are drawn, fit and scored
at once: `n_hypo` minimal samples as (n_hypo, N) 0/1 weight rows, one
batched weighted fit, one (n_hypo, N) error matrix, and a refit of the
winner on its inlier set.  No shape depends on the data, and nothing is
read back to the host: the 8-point and homography fits' eigen- and
singular-value decompositions are K12 and K13 on the card
(``ops.kernels.linalg``), the affine fit's solves ``solve_ex``.  The rows'
noise is drawn on the host (``ransac_host_noise``) and their top-k taken
on the device (``sample_rows``), so a CUDA graph can take the noise as an
input (``ransac(noise=)``, as ``sfm.twoview`` passes it).

The JAX package draws its rows with ``jax.random.gumbel`` under a
``PRNGKey``; a ``torch.Generator`` draws other numbers, so ``ransac`` takes
the rows as an optional argument (``weights``), and the parity tests pass
the rows JAX drew.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops import as_tensor, device_of
from .geometry import (_first_argmax, _normalize_points, fit_fundamental_8pt, fit_homography,
                       homography_error, sampson_error_F)


class RansacResult(NamedTuple):
    model: torch.Tensor       # fitted model (refit on inliers)
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # () int32
    best_score: torch.Tensor  # () int32 inlier count of the winning hypothesis


def ransac_host_noise(seed: int, n_hypo: int, n: int) -> torch.Tensor:
    """The Gumbel noise -log(-log u) of `n_hypo` rows over `n` entries, u
    from a ``torch.Generator`` seeded with `seed` on the CPU: a CPU tensor
    (n_hypo, n) f32, the same on every device (not what JAX draws for the
    same seed)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    u = torch.rand((n_hypo, n), generator=gen, dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_rows(gumbel: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """(n_hypo, N) f32 0/1 weight rows on `valid`'s device, each selecting
    the k valid entries of largest noise (`gumbel` (n_hypo, N), moved
    there): the masked Gumbel top-k, as the JAX package's, with no host
    sync.  A row picks an entry that is not valid only where fewer than k
    are."""
    g = torch.where(valid.bool()[None, :], gumbel.to(valid.device), -torch.inf)
    idx = torch.topk(g, k, dim=1).indices
    w = torch.zeros(g.shape, dtype=torch.float32, device=valid.device)
    return w.scatter_(1, idx, 1.0)


def _sample_weights(seed: int, valid: torch.Tensor, n_hypo: int, k: int) -> torch.Tensor:
    """(n_hypo, N) f32 0/1 weight rows, each selecting k distinct valid
    indices: ``sample_rows`` of ``ransac_host_noise(seed, n_hypo, N)``, so
    the card and the CPU draw the same rows."""
    return sample_rows(ransac_host_noise(seed, n_hypo, valid.shape[0]), valid, k)


def ransac(seed: int, uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
           fit_fn: Callable, error_fn: Callable, min_samples: int, thresh: float,
           n_hypo: int = 256, weights: Optional[torch.Tensor] = None,
           noise: Optional[torch.Tensor] = None) -> RansacResult:
    """Generic batched RANSAC over (N, 2) x (N, 2) correspondences.

    ``fit_fn(uv1, uv2, w (B, N)) -> (B, ...)`` models and
    ``error_fn(models (B, ...), uv1, uv2) -> (B, N)`` squared errors are
    batched over weight rows (the JAX package's take one row under
    ``vmap``).  ``weights``: the (n_hypo, N) minimal-sample rows to use in
    place of drawing them from `seed` (``_sample_weights``); ``noise``: the
    host noise to draw them from in place of `seed`'s
    (``ransac_host_noise``; a CUDA graph takes it as an input)."""
    if weights is not None:
        w = weights.to(device=uv1.device, dtype=uv1.dtype)
    elif noise is not None:
        w = sample_rows(noise, valid, min_samples)
    else:
        w = _sample_weights(seed, valid, n_hypo, min_samples)
    valid = valid.bool()
    models = fit_fn(uv1, uv2, w)
    errs = error_fn(models, uv1, uv2)                       # (n_hypo, N)
    inl = (errs < thresh) & valid[None, :]
    scores = inl.sum(1, dtype=torch.int32)
    best = _first_argmax(scores).view(1)
    best_in = inl.index_select(0, best)[0]
    best_score = scores.index_select(0, best)[0]
    best_model = models.index_select(0, best)[0]
    # refit on the winning inlier set (guard: need >= min_samples)
    enough = best_score >= min_samples
    refit_w = torch.where(enough, best_in.to(uv1.dtype), w.index_select(0, best)[0])
    model = fit_fn(uv1, uv2, refit_w[None])[0]
    final_in = (error_fn(model[None], uv1, uv2)[0] < thresh) & valid
    # keep the better of refit vs raw winner (refit can rarely degrade)
    use_refit = final_in.sum(dtype=torch.int32) >= best_score
    model = torch.where(use_refit, model, best_model)
    inliers = torch.where(use_refit, final_in, best_in)
    return RansacResult(model, inliers, inliers.sum(dtype=torch.int32), best_score)


def _fit_affine_weighted(uv1: torch.Tensor, uv2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted lstsq affine uv2 ≈ M @ uv1 + t per weight row w (B, N),
    returned as (B, 2, 3) [M | t].

    Points are Hartley-normalized first, so the normal equations stay
    well-conditioned at any pixel scale and the 1e-6 ridge keeps degenerate
    (collinear) samples finite.  The 3x3 solves are ``solve_ex`` (LU with
    partial pivoting, as ``jnp.linalg.solve``), whose error check stays on
    the card."""
    p1, T1 = _normalize_points(uv1, w)
    p2, T2 = _normalize_points(uv2, w)
    x = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)      # (B, N, 3)
    xw = x * w[..., None]
    eye = torch.eye(3, dtype=uv1.dtype, device=uv1.device)
    ata = x.transpose(-1, -2) @ xw + 1e-6 * eye
    atb = xw.transpose(-1, -2) @ p2                              # (B, 3, 2)
    sol = torch.linalg.solve_ex(ata, atb).result                 # rows [M.T ; t], normalized
    an = torch.cat([sol.transpose(-1, -2), eye[2:].expand(sol.shape[0], 1, 3)], -2)
    # denormalize: [uv2; 1] = T2^-1 @ An @ T1 @ [uv1; 1]
    full = torch.linalg.solve_ex(T2, an @ T1).result
    return full[..., :2, :]


def _affine_error(model: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """(B, N) squared residuals of models (B, 2, 3)."""
    pred = uv1 @ model[..., :2].transpose(-1, -2) + model[..., None, :, 2]
    return ((pred - uv2) ** 2).sum(-1)


def _ransac_on(seed, uv1, uv2, valid, fit_fn, error_fn, min_samples, thresh, n_hypo,
              weights, device, noise=None) -> RansacResult:
    """``ransac`` on tensors or arrays (points as f32): on `device` where
    given, else on `uv1`'s device if it is a tensor, else on the CUDA card
    (raises without one)."""
    dev = device_of(uv1, device)
    uv1, uv2 = (as_tensor(p, dev, torch.float32) for p in (uv1, uv2))
    valid = as_tensor(valid, dev, torch.bool)
    if weights is not None:
        weights = as_tensor(weights, dev, torch.float32)
    return ransac(seed, uv1, uv2, valid, fit_fn, error_fn, min_samples=min_samples,
                  thresh=thresh, n_hypo=n_hypo, weights=weights, noise=noise)


def ransac_homography(seed: int, uv1, uv2, valid, thresh_px: float = 3.0, n_hypo: int = 256,
                      weights=None, device=None) -> RansacResult:
    """RANSAC homography uv2 ~ H uv1 (model: (3, 3), H[2, 2] = 1).  With no
    ``weights`` the rows are drawn from `seed` (``_sample_weights``)."""
    return _ransac_on(seed, uv1, uv2, valid, fit_homography, homography_error, 4,
                      thresh_px ** 2, n_hypo, weights, device)


def ransac_affine(seed: int, uv1, uv2, valid, thresh_px: float = 3.0, n_hypo: int = 256,
                  weights=None, device=None) -> RansacResult:
    """RANSAC 2-D affine fit uv2 ≈ M @ uv1 + t (model: (2, 3) [M | t]).

    Backs ``LinearAlign(orsa=True)``.  With no ``weights`` the rows are
    drawn from `seed` (``_sample_weights``: the same rows on the card and
    the CPU, not JAX's)."""
    return _ransac_on(seed, uv1, uv2, valid, _fit_affine_weighted, _affine_error, 3,
                      thresh_px ** 2, n_hypo, weights, device)


def ransac_essential_normalized(seed: int, xy1, xy2, valid, thresh=1e-4, n_hypo: int = 256,
                                weights=None, noise=None, device=None) -> RansacResult:
    """RANSAC essential matrix on K-normalized image coordinates (model:
    the rank-2 8-point fit, (3, 3)).  xy* are the rays' (x, y) at z = 1;
    `thresh` is the squared Sampson error in normalized units ((px_err /
    f)^2), a float or a 0-d tensor.  ``weights`` and ``noise`` as in
    ``ransac``."""
    return _ransac_on(seed, xy1, xy2, valid, fit_fundamental_8pt, sampson_error_F, 8,
                      thresh, n_hypo, weights, device, noise)
