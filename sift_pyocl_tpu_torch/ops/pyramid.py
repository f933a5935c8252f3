"""Gaussian scale-space pyramid.

Port of ``sift_pyocl_tpu/ops/pyramid.py``: separable Gaussian blurs with
clamp-to-edge borders, the blur ladder of each octave, DoGs, and ceil-sized
octave downsampling.  ``conv_backend="pallas"`` or ``"auto"`` runs octave 0
through the ladder kernel K1 where the JAX package does (a pre-blur, and
taps its strip kernel holds: ``octave0_ladder_supported``), else level by
level through the blur kernel K9 (``SiftConfig(scales=2)``), and every
octave >= 1 through one call of K2 (``ops/kernels/``; on a CPU tensor their
plain versions); ``"xla"`` is the plain PyTorch path on any device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SiftConfig
from ..oracle import gaussian_kernel
from . import _build

Ladder = Tuple[torch.Tensor, torch.Tensor]

# The JAX package's strip-ladder margins (ops/pallas/ladder0.py:42-44): row
# margin and column margin, in pixels, each side.
MR = 16
SM = 128


def resolve_conv_backend(cfg: SiftConfig) -> str:
    """The pyramid path for `cfg`: "pallas" (the ladder kernels K1/K2, their
    plain versions on a CPU tensor) for "pallas" and "auto", "xla" (plain
    PyTorch on any device) for "xla"."""
    if cfg.conv_backend not in ("xla", "auto", "pallas"):
        raise ValueError(f"unknown conv_backend {cfg.conv_backend!r}")
    return "xla" if cfg.conv_backend == "xla" else "pallas"


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """f32 grayscale normalized to [0, 255] (oracle.normalize_image)."""
    if img.ndim == 3:
        lum = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                           device=img.device)
        img = img[..., :3].to(torch.float32) @ lum
    img = img.to(torch.float32)
    lo = img.min()
    hi = img.max()
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    return (img - lo) * scale


@lru_cache(maxsize=64)
def _taps(sigma: float, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(gaussian_kernel(sigma), device=device)


def conv1d_clamp(img: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """1-D correlation of an (H, W) plane along `axis`, clamp-to-edge borders."""
    half = (taps.numel() - 1) // 2
    x = img[None, None]
    if axis == 1:
        x = F.pad(x, (half, half, 0, 0), mode="replicate")
        k = taps.view(1, 1, 1, -1)
    else:
        x = F.pad(x, (0, 0, half, half), mode="replicate")
        k = taps.view(1, 1, -1, 1)
    return F.conv2d(x, k)[0, 0]


def separable_blur_ref(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Plain version of K9 (``ops.kernels.conv.separable_blur``): two
    replicate-padded ``conv2d`` passes, rows then columns."""
    return conv1d_clamp(conv1d_clamp(img, taps, axis=1), taps, axis=0)


def blur(img: torch.Tensor, sigma: float, backend: str = "auto") -> torch.Tensor:
    """Separable Gaussian blur with clamped borders (oracle.blur): K9 for
    backend "pallas" or "auto" (its plain version on a CPU tensor), the
    plain passes for "xla"."""
    if backend not in ("xla", "auto", "pallas"):
        raise ValueError(f"unknown blur backend {backend!r}")
    taps = _taps(float(sigma), img.device)
    _build.hold_for_graph(taps)
    if backend == "xla":
        return separable_blur_ref(img, taps)
    from .kernels.conv import separable_blur   # the kernel module imports this one

    return separable_blur(img, taps)


def upscale2(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upscale (oracle.upscale2): even rows/cols copy the input,
    odd ones average it with its clamped next neighbour."""

    def up(x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim]
        nxt = torch.clamp(torch.arange(n, device=x.device) + 1, max=n - 1)
        mid = 0.5 * x + 0.5 * x.index_select(dim, nxt)
        return torch.stack([x, mid], dim=dim + 1).flatten(dim, dim + 1)

    return up(up(img, 0), 1)


def normalized_input(img: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """The normalized image, doubled for ``double_im_size``: octave 0's
    input before the pre-blur."""
    data = normalize_image(img)
    return upscale2(data) if cfg.double_im_size else data


def pre_blur_sigma(cfg: SiftConfig) -> Optional[float]:
    """The blur that takes the input from ``orig_sigma`` (doubled with the
    image) to ``init_sigma``, or None when it is already there."""
    cur = cfg.orig_sigma * (2.0 if cfg.double_im_size else 1.0)
    return float(np.sqrt(cfg.init_sigma**2 - cur**2)) if cfg.init_sigma > cur else None


def prepare_input(img: torch.Tensor, cfg: SiftConfig, backend: str = "auto") -> torch.Tensor:
    """Normalize, optionally double, pre-blur to init_sigma through
    ``blur(backend=...)`` (oracle.prepare_input): octave 0's level 0."""
    data = normalized_input(img, cfg)
    pre = pre_blur_sigma(cfg)
    return data if pre is None else blur(data, pre, backend)


def build_octave(base: torch.Tensor, increments: Sequence[float],
                 backend: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """One octave's blur stack (len(increments)+1, H, W), level l+1 being
    level l blurred by ``increments[l]`` through ``blur(backend=...)``, and
    its DoG stack."""
    blurs = [base]
    for inc in increments:
        blurs.append(blur(blurs[-1], inc, backend))
    stack = torch.stack(blurs)
    return stack, stack[1:] - stack[:-1]


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Every other pixel, ceil-sized ((h+1)//2 rows) for odd dimensions."""
    return img[::2, ::2].contiguous()


def downsample2_bin(img: torch.Tensor) -> torch.Tensor:
    """2x2 mean (oracle.bin2), ceil-sized: on an odd edge the last row/col
    is its own pair, which 0.5*x + 0.5*x reproduces exactly."""

    def pair(x: torch.Tensor, dim: int) -> torch.Tensor:
        if x.shape[dim] % 2:
            x = torch.cat([x, x.narrow(dim, x.shape[dim] - 1, 1)], dim=dim)
        x = x.movedim(dim, 0)
        return (0.5 * x[0::2] + 0.5 * x[1::2]).movedim(0, dim)

    return pair(pair(img, 0), 1).contiguous()


def downsample_octave(img: torch.Tensor, mode: str) -> torch.Tensor:
    """Octave downsample (``downsample_mode``: "shrink" | "bin")."""
    return downsample2_bin(img) if mode == "bin" else downsample2(img)


def octave0_ladder_ref(img: torch.Tensor, pre_sigma: float,
                       increments: Sequence[float]) -> Ladder:
    """Plain version of K1 (``ops.kernels.ladder.octave0_ladder``): octave
    0 from the normalized image, pre-blurred by `pre_sigma`."""
    return build_octave(blur(img, pre_sigma, "xla"), increments)


def small_octaves_ladder_ref(base1: torch.Tensor, increments: Sequence[float], n_oct: int,
                             scales: int, ds_mode: str = "shrink") -> List[Ladder]:
    """Plain version of K2 (``ops.kernels.ladder.small_octaves_ladder``):
    `n_oct` octaves from the first small octave's base, each next base being
    level `scales` downsampled."""
    out, base = [], base1
    for _ in range(n_oct):
        out.append(build_octave(base, increments))
        base = downsample_octave(out[-1][0][scales], ds_mode)
    return out


def octave0_ladder_supported(pre_sigma: float, increments: Sequence[float]) -> bool:
    """True iff the TPU's strip ladder covers these sigmas: every tap
    half-width within the row margin, their sum within the column margin.
    A carried copy of ``sift_pyocl_tpu/ops/pallas/ladder0.py``'s (held equal
    by ``tests/test_torch_config.py``): the port's K1 takes any sigma, but
    octave 0 takes the same kernels as in the JAX package."""
    halves = [(len(gaussian_kernel(s)) - 1) // 2 for s in [pre_sigma, *increments]]
    return max(halves) <= MR and sum(halves) <= SM


def build_scale_space(img: torch.Tensor, cfg: SiftConfig,
                      plain: bool = False) -> List[Ladder]:
    """All octaves as a list of (blurs (S+3, H, W), dogs (S+2, H, W)).
    Octave 0 through K1 where ``octave0_ladder_supported`` holds for a
    pre-blurred input, else level by level through K9; the other octaves
    through one call of K2; or their plain versions for
    ``conv_backend="xla"`` or ``plain=True``."""
    return build_scale_space_and_masks(img, cfg, plain)[0]


def build_scale_space_and_masks(img: torch.Tensor, cfg: SiftConfig, plain: bool = False
                                ) -> Tuple[List[Ladder], Optional[List[Optional[torch.Tensor]]]]:
    """``build_scale_space``'s octaves and, for ``mask_backend="fused"``
    where the ladder kernels run, their in-ladder extrema masks (port of
    ``build_scale_space_and_masks_jax``).  Returns (octaves, masks): masks
    is None unless the masks were fused, else one border-stripped (S,
    H-2bd, W-2bd) bool mask per octave from K1m / K2m, equal to the
    stencil's; octave 0's entry is None where it went level by level
    through K9 (the caller takes the stencil there)."""
    backend = "xla" if plain else resolve_conv_backend(cfg)
    fuse = cfg.mask_backend == "fused" and backend == "pallas"
    n_oct = cfg.n_octaves(tuple(img.shape[:2]))
    pre = pre_blur_sigma(cfg)
    incs = cfg.sigma_increments()
    bd = cfg.border_dist
    if backend == "pallas":
        # imported here, as the JAX package imports its Pallas ladders: the
        # kernel modules take their plain versions from this one
        from .kernels.ladder import octave0_ladder, small_octaves_ladder as k2
        from .kernels.maskk import octave_edge_thresh
    else:
        k2 = small_octaves_ladder_ref
    masks: List[Optional[torch.Tensor]] = [None]
    if backend == "pallas" and pre is not None and octave0_ladder_supported(pre, incs):
        if fuse:
            blurs, dogs, mask = octave0_ladder(
                normalized_input(img, cfg), pre, incs,
                mask_cfg=(cfg.peak_thresh, octave_edge_thresh(cfg, 0), bd))
            octaves, masks = [(blurs, dogs)], [mask]
        else:
            octaves = [octave0_ladder(normalized_input(img, cfg), pre, incs)]
    else:
        octaves = [build_octave(prepare_input(img, cfg, backend), incs, backend)]
    if n_oct > 1:
        base = downsample_octave(octaves[0][0][cfg.scales], cfg.downsample_mode)
        if fuse:
            eths = tuple(octave_edge_thresh(cfg, o) for o in range(1, n_oct))
            for blurs, dogs, mask in k2(base, incs, n_oct - 1, cfg.scales, cfg.downsample_mode,
                                        mask_cfg=(cfg.peak_thresh, eths, bd)):
                octaves.append((blurs, dogs))
                masks.append(mask)
        else:
            octaves += k2(base, incs, n_oct - 1, cfg.scales, cfg.downsample_mode)
    return octaves, (masks if fuse else None)
