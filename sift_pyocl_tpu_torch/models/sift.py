"""End-to-end SIFT frontend and the ``SiftPlan`` public API, in PyTorch.

Port of ``sift_pyocl_tpu/models/sift.py``.  The pyramid (``ops/pyramid.py``:
the blur kernels K1/K2, or K9 level by level where the JAX package takes its
per-level route, or plain PyTorch with ``conv_backend="xla"``), then by
``kp_backend``:

* ``"pallas"`` / ``"auto"``, the kernel path, by ``kp_multi_launch``:
  ``True`` (``_describe_octaves_multi``, the JAX package's
  ``_describe_octaves_pallas``): the extrema masks (plain stencil, K8
  with ``mask_backend="pallas"``, or with ``"fused"`` those of the ladder
  kernels' mask forms K1m/K2m) and one launch each over all octaves of
  K3 compaction, K4 refinement, K5 gradient atlas and K6 orientation +
  descriptor (two K6 launches split by sigma with ``desc_buckets >= 2``);
  ``False`` (``_describe_octaves_per_octave``): per octave, the plain
  stencil, K10a, K10b, the plain gradient planes and one K6 launch;
* ``"xla"`` (``_describe_octaves_xla``): the JAX package's plain XLA path,
  per octave the plain gradients, ``detect_octave``,
  ``assign_orientations`` and ``compute_descriptors``, all plain PyTorch;

then ``quantize_descriptors``.  ``detect_and_describe_batched`` (BASELINE
config 3) runs the multi-launch path once over every octave of B frames,
each entry with its own octave number (``oct_ids``).  The JAX package
sends configurations whose window exceeds 128 (e.g. ``init_sigma=1.8,
scales=2``) from its kernel path to the XLA path, since its window kernels
hold at most 128 lanes; the port does not, since K6 takes any window.  On
a CPU device every kernel wrapper runs its plain PyTorch version.

``SiftPlan`` on a CUDA device replays one CUDA graph per (device, image
shape and dtype, ``SiftConfig``) (``DETECT_GRAPHS``, process-wide, as the
JAX package's ``_jitted_detector`` is one program per config shared by
every plan); ``detect_and_describe`` itself, like its JAX counterpart, runs
eagerly.
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
from ..ops.detect import detect_all_slots, detect_octave, detect_octave_pallas
from ..ops.kernels.gradpad import grad_atlas, grad_atlas_ref
from ..ops.kernels.window import orient_desc_fused, orient_desc_fused_ref, slot_octave_geometry
from ..ops.orient_desc import (_desc_window_for_sigma, _desc_window_size,
                               assign_orientations, compute_descriptors, gradient_planes,
                               orient_and_describe_fused, quantize_descriptors)
from ..ops.pyramid import build_scale_space_and_masks, resolve_conv_backend
from ..utils import graphs

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
    """Raise for keypoint-stage settings that are unknown."""
    if cfg.kp_backend not in ("pallas", "auto", "xla"):
        raise ValueError(f"unknown kp_backend {cfg.kp_backend!r}")
    if cfg.grad_backend not in ("pallas", "xla"):
        raise ValueError(f"unknown grad_backend {cfg.grad_backend!r}")
    if cfg.mask_backend not in ("xla", "pallas", "fused"):
        raise ValueError(f"unknown mask_backend {cfg.mask_backend!r}")


def detect_and_describe(img: torch.Tensor, cfg: SiftConfig, plain: bool = False) -> KeypointBuffer:
    """The full forward pass on the device of `img`.  ``plain=True`` runs
    each kernel's plain PyTorch version instead (parity runs on the card)."""
    octaves, masks = build_scale_space_and_masks(img, cfg, plain=plain)
    return describe_octaves(octaves, tuple(img.shape[:2]), cfg, plain=plain, masks=masks)


def describe_octaves(octaves, shape: Tuple[int, int], cfg: SiftConfig,
                     plain: bool = False, masks=None) -> KeypointBuffer:
    """Detection + orientation + descriptors over a prebuilt scale space,
    by ``cfg.kp_backend`` and ``cfg.kp_multi_launch``.  On the kernel paths
    duplicate orientation slots are keypoint-major (slot i*max_ori + o),
    octave after octave; on the XLA path each octave's oriented keypoints
    are compacted to its descriptor capacity.  `masks`: the fused in-ladder
    extrema masks (``build_scale_space_and_masks``), which only the
    multi-launch kernel path takes, as in the JAX package."""
    _check_kp_path(cfg)
    if cfg.kp_backend == "xla":
        return _describe_octaves_xla(octaves, octave_capacities(shape, cfg), cfg)
    caps = [c for c, _ in octave_capacities(shape, cfg)]
    if cfg.kp_multi_launch:
        return _describe_octaves_multi(octaves, caps, cfg, plain, masks)
    return _describe_octaves_per_octave(octaves, caps, cfg, plain)


def _desc_buckets(cfg: SiftConfig):
    """(small window, sigma split) of the two K6 launches of
    ``desc_buckets >= 2``, or None where one launch is used: the fused
    kernel's work grows with its window, sized for sigma_max, while fs is
    roughly uniform over [0.5, scales + 0.5], so keypoints below the middle
    sigma fit a smaller window.  If the floor ``desc_window`` dominates,
    a second launch would buy nothing."""
    if cfg.desc_buckets < 2:
        return None
    fs_split = 0.5 * (cfg.scales + 1.0)
    sig_split = cfg.init_sigma * 2.0 ** (fs_split / cfg.scales)
    win_s = _desc_window_for_sigma(cfg, sig_split)
    return (win_s, sig_split) if win_s < _desc_window_size(cfg) else None


def _describe_octaves_multi(octaves, caps: List[int], cfg: SiftConfig,
                            plain: bool, masks=None, oct_ids=None) -> KeypointBuffer:
    """One compaction, one refinement, one gradient atlas and one fused
    orientation+descriptor launch (two with ``desc_buckets``) over every
    entry; the extrema masks are `masks` where given (fused).  An entry is
    one octave of one frame, `oct_ids` its octave number (0..n-1 where
    None): a batch lists every frame's octaves (``detect_and_describe_batched``)."""
    max_ori = cfg.max_ori
    blurs = [b for b, _ in octaves]
    if oct_ids is None:
        oct_ids = list(range(len(octaves)))
    (s_cat, fs_cat, fr_cat, fc_cat, _, valid_cat), _ = detect_all_slots(
        [d for _, d in octaves], cfg, caps, plain=plain, masks=masks, oct_ids=oct_ids)
    atlas = grad_atlas_ref if (plain or cfg.grad_backend == "xla") else grad_atlas
    mag_a, ori_a, row_starts = atlas(blurs, cfg.scales)

    sigma_cat = cfg.init_sigma * 2.0 ** (fs_cat / cfg.scales)
    fused = orient_desc_fused_ref if plain else orient_desc_fused
    geom = slot_octave_geometry(caps, row_starts, blurs)

    def launch(valid, win):
        return fused(mag_a, ori_a, s_cat, fr_cat, fc_cat, sigma_cat, valid, win, max_ori,
                     *geom)

    buckets = _desc_buckets(cfg)
    if buckets is None:
        ang, ok, raw = launch(valid_cat, _desc_window_size(cfg))
    else:
        # two launches over the same slots, each skipping the other bucket
        # through the valid mask, merged by bucket
        win_s, sig_split = buckets
        small = sigma_cat <= sig_split
        ang_s, ok_s, raw_s = launch(valid_cat & small, win_s)
        ang_l, ok_l, raw_l = launch(valid_cat & ~small, _desc_window_size(cfg))
        ang = torch.where(small[:, None], ang_s, ang_l)
        ok = torch.where(small[:, None], ok_s, ok_l)
        raw = torch.where(small[:, None, None], raw_s, raw_l)
    desc = quantize_descriptors(raw.reshape(-1, 128))

    base = 0.5 if cfg.double_im_size else 1.0
    octsize_cat = torch.cat([torch.full((cap,), base * 2.0 ** o, device=fs_cat.device)
                             for o, cap in zip(oct_ids, caps)])
    counts = []
    off = 0
    for cap in caps:
        counts.append(torch.stack([valid_cat[off : off + cap].sum().to(torch.int32),
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


def detect_and_describe_batched(imgs: torch.Tensor, cfg: SiftConfig,
                                plain: bool = False) -> KeypointBuffer:
    """Batched frontend on the device of `imgs` (B, H, W): B frames through
    ONE set of keypoint launches (BASELINE config 3, the video frontend).
    Each frame's pyramid is built on its own (K1/K2, or K1m/K2m with
    ``mask_backend="fused"``); then every frame's octaves form one entry
    list (entry f * n_oct + o is frame f's octave o, ``oct_ids`` its octave
    number), and the extrema masks (K8 with ``"pallas"``), ONE compaction
    (K3), ONE refinement (K4), ONE gradient atlas (K5) and ONE fused
    orientation + descriptor launch (K6; two with ``desc_buckets``) cover
    the whole batch (each multi-octave kernel splits a list longer than
    ``ops._build.MAX_ENTRIES`` into launches of that many).  Every kernel
    works in entry-local coordinates, so each frame's result is, bit for
    bit, that of ``detect_and_describe`` on the frame.  Where there are no
    cross-octave launches to share (``kp_backend="xla"`` or
    ``kp_multi_launch=False``) it runs ``detect_and_describe`` frame by
    frame, as the JAX package does.  ``plain=True`` runs each kernel's
    plain PyTorch version instead.

    Returns a KeypointBuffer whose fields carry a leading batch axis:
    x/y/scale/angle/valid (B, N), desc (B, N, 128), counts (B, n_oct, 2)."""
    _check_kp_path(cfg)
    if imgs.ndim != 3:
        raise ValueError(f"imgs must be (B, H, W), got {tuple(imgs.shape)}")
    B = imgs.shape[0]
    caps1 = [c for c, _ in octave_capacities(tuple(imgs.shape[1:]), cfg)]
    n_oct = len(caps1)
    if cfg.kp_backend == "xla" or not cfg.kp_multi_launch:
        bufs = [detect_and_describe(imgs[f], cfg, plain=plain) for f in range(B)]
        return KeypointBuffer(*[torch.stack([getattr(b, fld) for b in bufs])
                                for fld in KeypointBuffer._fields])
    octs, masks = [], []
    for f in range(B):
        o_f, m_f = build_scale_space_and_masks(imgs[f], cfg, plain=plain)
        octs.extend(o_f)
        masks.extend(m_f if m_f is not None else [None] * len(o_f))
    buf = _describe_octaves_multi(octs, caps1 * B, cfg, plain,
                                  None if all(m is None for m in masks) else masks,
                                  oct_ids=list(range(n_oct)) * B)
    n = buf.x.shape[0] // B
    return KeypointBuffer(
        x=buf.x.reshape(B, n),
        y=buf.y.reshape(B, n),
        scale=buf.scale.reshape(B, n),
        angle=buf.angle.reshape(B, n),
        desc=buf.desc.reshape(B, n, 128),
        valid=buf.valid.reshape(B, n),
        counts=buf.counts.reshape(B, n_oct, 2),
    )


def _per_octave_buffer(octaves, cfg: SiftConfig, describe) -> KeypointBuffer:
    """Octave after octave, ``describe(o, blurs, dogs)`` -> (RefinedKeypoints,
    OrientedKeypoints, u8 descriptors), laid out in input-image coordinates."""
    fields = {f: [] for f in ("x", "y", "scale", "angle", "desc", "valid", "counts")}
    octsize = 0.5 if cfg.double_im_size else 1.0
    for o, (blurs, dogs) in enumerate(octaves):
        kps, okps, desc = describe(o, blurs, dogs)
        sigma = cfg.init_sigma * 2.0 ** (okps.fs / cfg.scales)
        fields["x"].append(okps.fc * octsize)
        fields["y"].append(okps.fr * octsize)
        fields["scale"].append(sigma * octsize)
        fields["angle"].append(okps.angle)
        fields["desc"].append(desc)
        fields["valid"].append(okps.valid)
        fields["counts"].append(torch.stack([kps.valid.sum().to(torch.int32), okps.count]))
        octsize *= 2.0
    return KeypointBuffer(
        **{f: (torch.stack(v) if f == "counts" else torch.cat(v)) for f, v in fields.items()})


def _describe_octaves_per_octave(octaves, caps: List[int], cfg: SiftConfig,
                                 plain: bool) -> KeypointBuffer:
    """Per-octave launches (``kp_multi_launch=False``): per octave one
    detection (plain stencil, K10a, K10b) and one fused
    orientation+descriptor launch (K6) over the octave's plain gradient
    planes, as the JAX package's per-octave path, which takes neither
    ``mask_backend``, ``grad_backend`` nor ``desc_buckets``."""

    def describe(o, blurs, dogs):
        kps, _ = detect_octave_pallas(dogs, cfg, o, caps[o], plain=plain)
        mag, ori, _ = grad_atlas_ref([blurs], cfg.scales)
        return (kps, *orient_and_describe_fused(mag, ori, kps, cfg, cfg.max_ori, plain=plain))

    return _per_octave_buffer(octaves, cfg, describe)


def _describe_octaves_xla(octaves, caps: List[Tuple[int, int]],
                          cfg: SiftConfig) -> KeypointBuffer:
    """The plain path (``kp_backend="xla"``, the JAX package's XLA branch):
    per octave the gradient planes, ``detect_octave``,
    ``assign_orientations`` compacted to the octave's descriptor capacity
    and ``compute_descriptors``; it takes neither ``mask_backend``,
    ``grad_backend``, ``kp_multi_launch`` nor ``desc_buckets``."""

    def describe(o, blurs, dogs):
        cap, dcap = caps[o]
        mags, oris = gradient_planes(blurs, cfg)
        kps = detect_octave(dogs, cfg, o, cap)
        okps = assign_orientations(mags, oris, kps, cfg, dcap, max_ori=cfg.max_ori)
        return kps, okps, compute_descriptors(mags, oris, okps, cfg)

    return _per_octave_buffer(octaves, cfg, describe)


def to_keypoint_records(buf: KeypointBuffer) -> np.ndarray:
    """The valid slots of a KeypointBuffer as a host KP_DTYPE array (a
    replay's buffer comes home in one copy, ``graphs.to_host``; the valid
    mask is applied on the host)."""
    x, y, scale, angle, desc, valid = (t.numpy() for t in graphs.to_host(buf[:6]))
    out = np.zeros(int(valid.sum()), dtype=KP_DTYPE)
    out["x"] = x[valid]
    out["y"] = y[valid]
    out["scale"] = scale[valid]
    out["angle"] = angle[valid]
    out["desc"] = desc[valid]
    return out


@lru_cache(maxsize=32)
def _detector(cfg: SiftConfig):
    """The eager forward pass of one config, validated once and shared by
    every plan with that config: what a CPU plan runs, and what
    ``DETECT_GRAPHS`` captures on a card."""
    _check_kp_path(cfg)
    resolve_conv_backend(cfg)
    return partial(detect_and_describe, cfg=cfg)


def _detect_flat(cfg: SiftConfig, img: torch.Tensor):
    """The eager forward pass as a graph body: the buffer's fields."""
    return tuple(_detector(cfg)(img))


# SiftPlan's detector on the card: one CUDA graph per (device, image shape
# and dtype, config), shared by every plan (IncrementalSfM and LinearAlign
# build a plan each), as the JAX package's ``_jitted_detector``
DETECT_GRAPHS = graphs.GraphCache(_detect_flat)


def _host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class SiftPlan:
    """SIFT plan (API parity with sift-src/plan.py::SiftPlan).

    >>> plan = SiftPlan(shape=(512, 512), dtype="float32")
    >>> kp = plan.keypoints(img)     # structured array, KP_DTYPE records

    ``device`` (default: the current CUDA card; raises without one, so
    pass ``device="cpu"`` for the CPU) is where the frontend runs; on a
    CUDA device it runs on the hand-written kernels, as one CUDA graph per
    (image shape and dtype, config) (``DETECT_GRAPHS``): the first frame
    of a key (or ``compile``) captures it, every frame replays it.  A
    capture or replay that fails raises.  ``devicetype`` is accepted for
    signature parity and ignored.
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

    def compile(self) -> "SiftPlan":
        """Build ahead of the first frame (the reference does this in
        __init__): one ``keypoints_raw`` on a zero float32 image of the
        plan's shape builds the kernels and, on a card, captures the
        detector's graph for float32 frames (its warm-up makes each
        kernel's first-call state: K2's work list, K3's scratch)."""
        self.keypoints_raw(torch.zeros(self.shape, dtype=torch.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def log_profile(self) -> dict:
        """Parity shim for the reference's event-profiling report
        (reference: plan.py::log_profile): host-clock ms of each stage
        (``utils.profiling.stage_times``) for this plan's shape, config and
        device, on uniform noise from seed 0 (the JAX package's image)."""
        from ..utils.profiling import stage_times

        image = np.random.default_rng(0).uniform(0, 255, self.shape).astype(np.float32)
        return stage_times(image, self.cfg, self.device, frames=1)

    def keypoints_raw(self, image) -> KeypointBuffer:
        """Device-resident fixed-capacity result (for fused downstream use);
        on a card the detector graph's replay (a host image is copied in
        by the replay's input copy)."""
        img = image if torch.is_tensor(image) else torch.from_numpy(np.asarray(image))
        if tuple(img.shape[:2]) != self.shape:
            raise ValueError(f"image shape {tuple(img.shape[:2])} != plan shape {self.shape}")
        if self.device.type != "cuda":
            return self._fn(img.to(self.device))
        return KeypointBuffer(*DETECT_GRAPHS(self.device, self.cfg, (img,)))

    def keypoints(self, image) -> np.ndarray:
        """Host-side structured keypoint array (reference output format):
        the buffer comes home in one copy."""
        return to_keypoint_records(self.keypoints_raw(image))

    __call__ = keypoints
