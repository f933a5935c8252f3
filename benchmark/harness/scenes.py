"""Seeded scenes made on the device: the recipe of the port's
``utils/testimage.py::synthetic_scene`` (a bilinearly upsampled coarse
noise background times 30, plus Gaussian blobs of sigma 2-14 px and
amplitude +-60-160 at 10-90 % of each axis, normalized to [0, 255]), drawn
from a ``torch.Generator`` on the device, every blob of a batch of scenes
in one separable product, and truncated to uint8 as a camera gives it.
"""

from __future__ import annotations

import torch

SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from any whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)


def _upsample_weights(n_out: int, n_coarse: int, device):
    """(n_out, n_coarse) bilinear weights of synthetic_scene's linspace
    sampling of a coarse axis."""
    pos = torch.linspace(0, n_coarse - 1.001, n_out, dtype=torch.float64, device=device)
    i0 = pos.long()
    f = pos - i0
    w = torch.zeros(n_out, n_coarse, dtype=torch.float64, device=device)
    w[torch.arange(n_out, device=device), i0] = 1 - f
    w[torch.arange(n_out, device=device), i0 + 1] += f
    return w.float()


def scenes(count: int, shape, n_blobs: int, seed: int, device) -> torch.Tensor:
    """(count, H, W) uint8 scenes on `device`, the same bits for the same
    seed on the same device and software."""
    h, w = shape
    gen = generator(seed, device)
    ch, cw = h // 16 + 2, w // 16 + 2
    coarse = torch.randn((count, ch, cw), generator=gen, device=device)
    wy, wx = _upsample_weights(h, ch, device), _upsample_weights(w, cw, device)
    img = 30.0 * torch.einsum("yi,nij,xj->nyx", wy, coarse, wx)
    u = torch.rand((count, n_blobs, 5), generator=gen, device=device)
    cy = (0.1 + 0.8 * u[..., 0]) * h
    cx = (0.1 + 0.8 * u[..., 1]) * w
    sig = 2.0 + 12.0 * u[..., 2]
    amp = (60.0 + 100.0 * u[..., 3]) * torch.where(u[..., 4] < 0.5, -1.0, 1.0)
    rows = torch.arange(h, dtype=torch.float32, device=device)
    cols = torch.arange(w, dtype=torch.float32, device=device)
    gy = torch.exp(-((rows - cy[..., None]) ** 2) / (2 * sig[..., None] ** 2))
    gx = torch.exp(-((cols - cx[..., None]) ** 2) / (2 * sig[..., None] ** 2))
    img = img + torch.einsum("nky,nkx->nyx", amp[..., None] * gy, gx)
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    img = (img - lo) * (255.0 / torch.clamp(hi - lo, min=1e-9))
    return img.clamp(0, 255).to(torch.uint8)
