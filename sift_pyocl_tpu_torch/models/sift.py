"""End-to-end SIFT frontend and the ``SiftPlan`` public API, in PyTorch.

Port of ``sift_pyocl_tpu/models/sift.py`` on its multi-launch keypoint path
(``_describe_octaves_pallas``): the plain PyTorch pyramid and extrema mask,
then one launch each of the four CUDA kernels over all octaves -- K3
compaction, K4 refinement, K5 gradient atlas, K6 orientation+descriptor --
and ``quantize_descriptors``.  On a CPU device every kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from functools import lru_cache, partial
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SiftConfig
from ..oracle import KP_DTYPE
from ..ops import resolve_device
from ..ops.detect import detect_all_octaves
from ..ops.kernels.gradpad import grad_atlas, grad_atlas_ref
from ..ops.kernels.window import orient_desc_fused, orient_desc_fused_ref, slot_octave_geometry
from ..ops.orient_desc import _desc_window_size, quantize_descriptors
from ..ops.pyramid import build_scale_space, resolve_conv_backend

logger = logging.getLogger(__name__)


class KeypointBuffer(NamedTuple):
    """Fixed-capacity keypoint output with a validity mask."""

    x: torch.Tensor        # (cap,) f32 column in input-image coords
    y: torch.Tensor        # (cap,) f32 row in input-image coords
    scale: torch.Tensor    # (cap,) f32 absolute sigma in input-image coords
    angle: torch.Tensor    # (cap,) f32 in (-pi, pi]
    desc: torch.Tensor     # (cap, 128) uint8
    valid: torch.Tensor    # (cap,) bool
    counts: torch.Tensor   # (n_octaves, 2) int32 true (extrema, oriented) counts


def octave_capacities(shape: Tuple[int, int], cfg: SiftConfig) -> List[Tuple[int, int]]:
    """(candidate_cap, descriptor_cap) per octave: kp_per_octave_cap bounds
    octave 0 and halves per octave (floor 128)."""
    h, w = shape
    if cfg.double_im_size:
        h, w = 2 * h, 2 * w
    caps = []
    cap_bound = cfg.kp_per_octave_cap
    for _ in range(cfg.n_octaves(shape)):
        cap = int(min(cap_bound, max(h * w // cfg.pix_per_kp, 64)))
        cap = (cap + 63) // 64 * 64
        caps.append((cap, cap + cap // 2))
        h, w = h // 2, w // 2
        cap_bound = max(cap_bound // 2, 128)
    return caps


def _check_kp_path(cfg: SiftConfig) -> None:
    """Raise for keypoint-stage settings that are not ported yet."""
    if cfg.kp_backend not in ("pallas", "auto"):
        raise NotImplementedError(
            f"kp_backend={cfg.kp_backend!r}: only the kernel path "
            "('pallas' or 'auto') is ported (ROADMAP.md, Queue 1: the "
            "kp_backend='xla' path is still to come)")
    if not cfg.kp_multi_launch:
        raise NotImplementedError(
            "kp_multi_launch=False (per-octave launches, K10a/K10b) is not "
            "ported yet (ROADMAP.md, Queue 2)")
    if cfg.desc_buckets != 1:
        raise NotImplementedError(
            "desc_buckets != 1 is not ported yet (ROADMAP.md, Queue 1)")
    if cfg.grad_backend not in ("pallas", "xla"):
        raise ValueError(f"unknown grad_backend {cfg.grad_backend!r}")


def detect_and_describe(img: torch.Tensor, cfg: SiftConfig, plain: bool = False) -> KeypointBuffer:
    """The full forward pass on the device of `img`.  ``plain=True`` runs
    each kernel's plain PyTorch version instead (parity runs on the card)."""
    octaves = build_scale_space(img, cfg)
    return describe_octaves(octaves, tuple(img.shape[:2]), cfg, plain=plain)


def describe_octaves(octaves, shape: Tuple[int, int], cfg: SiftConfig,
                     plain: bool = False) -> KeypointBuffer:
    """Detection + orientation + descriptors over a prebuilt scale space:
    one compaction, one refinement, one gradient atlas and one fused
    orientation+descriptor launch over every octave.  Duplicate orientation
    slots are keypoint-major (slot i*max_ori + o)."""
    _check_kp_path(cfg)
    max_ori = cfg.max_ori
    caps = [c for c, _ in octave_capacities(shape, cfg)]
    blurs = [b for b, _ in octaves]
    detected = detect_all_octaves([d for _, d in octaves], cfg, caps, plain=plain)
    atlas = grad_atlas_ref if (plain or cfg.grad_backend == "xla") else grad_atlas
    mag_a, ori_a, row_starts = atlas(blurs, cfg.scales)

    kps_l = [k for k, _ in detected]
    s_cat, fs_cat, fr_cat, fc_cat, _, valid_cat = (torch.cat(f) for f in zip(*kps_l))
    sigma_cat = cfg.init_sigma * 2.0 ** (fs_cat / cfg.scales)
    fused = orient_desc_fused_ref if plain else orient_desc_fused
    ang, ok, raw = fused(mag_a, ori_a, s_cat, fr_cat, fc_cat, sigma_cat, valid_cat,
                         _desc_window_size(cfg), max_ori,
                         *slot_octave_geometry(caps, row_starts, blurs))
    desc = quantize_descriptors(raw.reshape(-1, 128))

    base = 0.5 if cfg.double_im_size else 1.0
    octsize_cat = torch.cat([torch.full((cap,), base * 2.0 ** o, device=fs_cat.device)
                             for o, cap in enumerate(caps)])
    counts = []
    off = 0
    for kps, cap in zip(kps_l, caps):
        counts.append(torch.stack([kps.valid.sum().to(torch.int32),
                                   ok[off : off + cap].sum().to(torch.int32)]))
        off += cap

    def rep(x):
        return torch.repeat_interleave(x, max_ori, dim=0)

    return KeypointBuffer(
        x=rep(fc_cat * octsize_cat),
        y=rep(fr_cat * octsize_cat),
        scale=rep(sigma_cat * octsize_cat),
        angle=ang.reshape(-1),
        desc=desc,
        valid=ok.reshape(-1),
        counts=torch.stack(counts),
    )


def to_keypoint_records(buf: KeypointBuffer) -> np.ndarray:
    """The valid slots of a KeypointBuffer as a host KP_DTYPE array."""
    x, y, scale, angle, desc, valid = (t.cpu().numpy() for t in buf[:6])
    out = np.zeros(int(valid.sum()), dtype=KP_DTYPE)
    out["x"] = x[valid]
    out["y"] = y[valid]
    out["scale"] = scale[valid]
    out["angle"] = angle[valid]
    out["desc"] = desc[valid]
    return out


@lru_cache(maxsize=32)
def _detector(cfg: SiftConfig):
    """The forward pass of one config, validated once and shared by every
    plan with that config (the counterpart of the JAX package's per-config
    jitted detector; PyTorch runs eagerly, so there is nothing to trace)."""
    _check_kp_path(cfg)
    resolve_conv_backend(cfg)
    return partial(detect_and_describe, cfg=cfg)


def _host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class SiftPlan:
    """SIFT plan (API parity with sift-src/plan.py::SiftPlan).

    >>> plan = SiftPlan(shape=(512, 512), dtype="float32")
    >>> kp = plan.keypoints(img)     # structured array, KP_DTYPE records

    ``device`` (default: the first CUDA card if there is one, else the CPU)
    is where the frontend runs; on a CUDA device the keypoint stage runs on
    the hand-written kernels.  ``devicetype`` is accepted for signature
    parity and ignored.
    """

    def __init__(
        self,
        shape: Optional[Tuple[int, int]] = None,
        dtype="float32",
        template: Optional[np.ndarray] = None,
        config: Optional[SiftConfig] = None,
        devicetype: str = "GPU",
        PIX_PER_KP: Optional[int] = None,
        init_sigma: Optional[float] = None,
        device: Optional[Union[str, torch.device]] = None,
        **_ignored,
    ):
        if template is not None:
            shape = template.shape[:2]
            dtype = template.dtype
        if shape is None:
            raise ValueError("provide shape=(h, w) or template=image")
        cfg = config or SiftConfig()
        overrides = {}
        if PIX_PER_KP is not None:
            overrides["pix_per_kp"] = PIX_PER_KP
        if init_sigma is not None:
            overrides["init_sigma"] = init_sigma
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.cfg = cfg
        self.device = resolve_device(device)
        self._check_memory()
        self._fn = _detector(cfg)
        logger.info(
            "SiftPlan %s %s on %s: %d octaves, caps %s, est. device memory %.1f MiB",
            self.shape, self.dtype, self.device, cfg.n_octaves(self.shape),
            octave_capacities(self.shape, cfg), self.calc_memory() / 2**20,
        )

    def calc_memory(self) -> int:
        """Estimated peak device bytes of this plan's arrays: input and base,
        blur/DoG stacks, the gradient atlas and the keypoint buffers, f32."""
        cfg = self.cfg
        h, w = self.shape
        if cfg.double_im_size:
            h, w = 2 * h, 2 * w
        total = h * w * 4 * 2
        for cap, dcap in octave_capacities(self.shape, cfg):
            blur_dog = (cfg.n_scale_imgs + cfg.n_dogs) * h * w * 4
            grads = 2 * cfg.scales * h * w * 4
            kp_bufs = (cap * 8 + dcap * (8 + 128)) * 4
            total += blur_dog + grads + kp_bufs
            h, w = (h + 1) // 2, (w + 1) // 2
        return total

    def _check_memory(self, limit_bytes: Optional[int] = None):
        """Raise MemoryError before allocating a plan that cannot fit: the
        limit is the CUDA card's memory, or the host's for a CPU plan."""
        need = self.calc_memory()
        if limit_bytes is None:
            if self.device.type == "cuda":
                limit_bytes = torch.cuda.mem_get_info(self.device)[1]
            else:
                limit_bytes = _host_memory_bytes()
        if need > limit_bytes:
            raise MemoryError(
                f"SiftPlan{self.shape}: estimated {need / 2**30:.2f} GiB of "
                f"device arrays exceeds the {limit_bytes / 2**30:.2f} GiB "
                "limit (reference parity: plan.py::_calc_memory pre-check)"
            )

    def keypoints_raw(self, image) -> KeypointBuffer:
        """Device-resident fixed-capacity result (for fused downstream use)."""
        img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
        if tuple(img.shape[:2]) != self.shape:
            raise ValueError(f"image shape {tuple(img.shape[:2])} != plan shape {self.shape}")
        return self._fn(img.to(self.device))

    def keypoints(self, image) -> np.ndarray:
        """Host-side structured keypoint array (reference output format)."""
        return to_keypoint_records(self.keypoints_raw(image))

    __call__ = keypoints
