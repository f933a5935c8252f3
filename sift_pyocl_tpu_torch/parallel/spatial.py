"""One frame's scale space cut into row shards over the devices of a 1-D
mesh (port of ``sift_pyocl_tpu/parallel/spatial.py``).

The JAX package row-shards the image with ``shard_map``; each Gaussian
level takes ``half``-row halos from its neighbours with ``lax.ppermute``
(the end shards replicate their own edge row, which is the global
clamp-to-edge border), and the normalisation's min and max ride
``lax.pmin`` / ``lax.pmax``.  Here the mesh is ``parallel.video``'s tuple
of devices (which may repeat): shard i lives on device i, a halo is a copy
of the neighbour's rows to that device (without blocking), and the min
and max are taken over the shards' on the first device.  The blurs are
plain PyTorch convolutions (the JAX package's are plain XLA, at HIGHEST
precision; TF32 stays off, ``sift_pyocl_tpu_torch/__init__.py``).  DoGs
are local, and the stride-2 downsample stays aligned because every shard
keeps an even row count.

For a single frame that must go faster than one device's frontend (very
large stills); for video, frame parallelism (``parallel/video.py``) needs
no halos.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SiftConfig
from ..ops.pyramid import _taps, conv1d_clamp
from .video import FramesMesh

Shards = Tuple[torch.Tensor, ...]


def _halo_exchange(xs: Sequence[torch.Tensor], half: int) -> List[torch.Tensor]:
    """Each shard with `half` rows of halo above and below: its neighbours'
    edge rows, copied to its device, or its own edge row repeated at the
    ends of the frame."""
    n = len(xs)
    out = []
    for i, x in enumerate(xs):
        if half > x.shape[0]:
            raise ValueError(f"halo of {half} rows exceeds a shard of {x.shape[0]} rows")
        nb = x.device.type == "cuda"     # no host wait for a copy to a card
        top = xs[i - 1][-half:].to(x.device, non_blocking=nb) if i > 0 \
            else x[:1].expand(half, -1)
        bot = xs[i + 1][:half].to(x.device, non_blocking=nb) if i < n - 1 \
            else x[-1:].expand(half, -1)
        out.append(torch.cat([top, x, bot]))
    return out


def _blur_sharded(xs: Sequence[torch.Tensor], sigma: float) -> List[torch.Tensor]:
    """oracle.blur of the whole frame, shard by shard: columns with the
    local clamp (each shard holds full rows), then rows over the halos."""
    taps = [_taps(float(sigma), x.device) for x in xs]
    half = (taps[0].numel() - 1) // 2
    ys = [conv1d_clamp(x, t, axis=1) for x, t in zip(xs, taps)]
    return [F.conv2d(y[None, None], t.view(1, 1, -1, 1))[0, 0]
            for y, t in zip(_halo_exchange(ys, half), taps)]


def _normalize_sharded(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """oracle.normalize_image over the frame: the shards' min and max met
    on the first device."""
    xs = [x.to(torch.float32) for x in xs]
    d0 = xs[0].device
    lo = torch.stack([x.min().to(d0) for x in xs]).min()
    hi = torch.stack([x.max().to(d0) for x in xs]).max()
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    return [(x - lo.to(x.device)) * scale.to(x.device) for x in xs]


def sharded_scale_space(img, cfg: SiftConfig, mesh: FramesMesh, axis: str = "rows",
                        n_oct: int = None) -> List[Tuple[Shards, Shards]]:
    """Row-sharded Gaussian scale space of one (H, W) frame (a tensor or an
    array).

    Returns, for each octave, (blurs, dogs): tuples of the mesh's size,
    shard i being rows [i H_o / n, (i + 1) H_o / n) of the octave's (S+3,
    H_o, W_o) blur stack or (S+2, H_o, W_o) DoG stack, on
    ``mesh.devices[i]`` (``join_rows`` puts a tuple back together).  H must
    be divisible by n * 2**(n_oct - 1), so that every shard keeps even rows
    in every octave; without `n_oct`, the most octaves (up to
    ``cfg.n_octaves``) for which it is and each shard keeps at least 16
    rows.  ``double_im_size`` is the caller's to apply beforehand."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")
    if cfg.double_im_size:
        raise ValueError("apply upscale2 before sharding")
    if not torch.is_tensor(img):
        img = torch.from_numpy(np.asarray(img))
    h, w = img.shape
    n = mesh.size
    if n_oct is None:
        n_oct = cfg.n_octaves((h, w))
        while n_oct > 1 and (h % (n * 2 ** (n_oct - 1)) or
                             (h // n) // 2 ** (n_oct - 1) < 16):
            n_oct -= 1
    if h % (n * 2 ** max(n_oct - 1, 0)):
        raise ValueError(f"H={h} not shardable over {n} devices x {n_oct} octaves")
    rows = h // n
    base = [img[i * rows:(i + 1) * rows].to(d, non_blocking=d.type == "cuda")
            for i, d in enumerate(mesh.devices)]
    base = _normalize_sharded(base)
    if cfg.init_sigma > cfg.orig_sigma:
        base = _blur_sharded(base, float(np.sqrt(cfg.init_sigma**2 - cfg.orig_sigma**2)))
    outs = []
    for _ in range(n_oct):
        levels = [base]
        for inc in cfg.sigma_increments():
            levels.append(_blur_sharded(levels[-1], inc))
        stacks = tuple(torch.stack(shard) for shard in zip(*levels))
        outs.append((stacks, tuple(s[1:] - s[:-1] for s in stacks)))
        base = [x[::2, ::2] for x in levels[cfg.scales]]
    return outs


def join_rows(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row shards (..., H_i, W) joined into one tensor on the first
    shard's device."""
    d0 = shards[0].device
    return torch.cat([s.to(d0, non_blocking=d0.type == "cuda") for s in shards], dim=-2)
