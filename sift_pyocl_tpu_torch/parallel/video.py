"""Frame-parallel (data-parallel) SIFT frontend over a list of devices.

Port of ``sift_pyocl_tpu/parallel/video.py`` (BASELINE.json config 3, the
video frontend).  The JAX package splits a frame batch over a ``frames``
mesh axis with ``shard_map``, one program a device on its local frames.
Here the mesh is a tuple of ``torch.device``s: the batch is cut into equal
shards, each shard is copied to its device without blocking and runs there
frame after frame, and the buffers are gathered on the first device.  The
JAX package jits the sharded ``lax.map``; here a CUDA device's share
replays, frame after frame, the single-frame detector graph that
``SiftPlan`` replays (``models.sift.DETECT_GRAPHS``, one graph per (device,
frame shape and dtype, ``SiftConfig``), ``_device_share``), and a CPU
device's runs ``batched_sift`` eagerly.  A graph of the whole share would
be captured once for each local batch and hold that many frames' memory in
its pool; the per-frame graph is shared by every batch size and by
``SiftPlan``, and ``lax.map`` too runs the one-frame program frame after
frame.  PyTorch launches asynchronously and the frontend makes no
host synchronisation, so the devices work at once while the host enqueues;
the caller's first read of the result is the first wait.  No collective is
needed: SIFT is frame-parallel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import SiftConfig
from ..models.sift import DETECT_GRAPHS, KeypointBuffer, detect_and_describe
from ..ops import resolve_device


class FramesMesh(NamedTuple):
    """A 1-D mesh: the devices of the frame axis, in order, and its name."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_frames_mesh(n_devices: Optional[int] = None, axis: str = "frames",
                     devices: Optional[Sequence[Union[str, torch.device]]] = None) -> FramesMesh:
    """1-D mesh over `devices`, or over every visible CUDA device (raises
    where there is none); the first `n_devices` of them where given.  Pass
    ``devices=[torch.device("cpu")] * n`` for n stand-ins on the CPU (the
    JAX package's virtual CPU mesh)."""
    if devices is None:
        resolve_device(None)            # raises without a CUDA card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a frames mesh needs at least one device")
    return FramesMesh(devs, (axis,))


def _stack(bufs: Sequence[KeypointBuffer]) -> KeypointBuffer:
    return KeypointBuffer(*[torch.stack([getattr(b, f) for b in bufs])
                            for f in KeypointBuffer._fields])


def batched_sift(frames: torch.Tensor, cfg: SiftConfig) -> KeypointBuffer:
    """detect+describe over a (B, H, W) frame batch on its device, frame
    after frame (the JAX package's ``lax.map``); fields with a leading batch
    axis.  ``models.sift.detect_and_describe_batched`` is the single-device
    mode that shares the keypoint launches across the batch."""
    return _stack([detect_and_describe(frames[i], cfg) for i in range(frames.shape[0])])


def _device_share(frames: torch.Tensor, cfg: SiftConfig) -> KeypointBuffer:
    """One device's frames: on a card each frame the replay of the
    detector's graph (``DETECT_GRAPHS``), elsewhere ``batched_sift``."""
    if frames.device.type != "cuda":
        return batched_sift(frames, cfg)
    return _stack([KeypointBuffer(*DETECT_GRAPHS(frames.device, cfg, (frames[i],)))
                   for i in range(frames.shape[0])])


def sharded_sift_fn(mesh: FramesMesh, cfg: SiftConfig,
                    axis: str = "frames") -> Callable[[torch.Tensor], KeypointBuffer]:
    """(B, H, W) frames -> KeypointBuffer batch on ``mesh.devices[0]``.

    B must be divisible by the mesh size; device i takes frames
    [i B/n, (i+1) B/n), copied there without blocking, and runs them
    (``_device_share``: on a card the detector graph's replay a frame).
    The shards' buffers are copied back without blocking, so no host
    synchronisation is made until the caller reads the result."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")
    devs = mesh.devices

    def fn(frames: torch.Tensor) -> KeypointBuffer:
        if frames.shape[0] % len(devs):
            raise ValueError(f"batch {frames.shape[0]} not divisible by mesh size {len(devs)}")
        k = frames.shape[0] // len(devs)
        outs = [_device_share(frames[i * k:(i + 1) * k].to(d, non_blocking=True), cfg)
                for i, d in enumerate(devs)]
        return KeypointBuffer(*[
            torch.cat([getattr(o, f).to(devs[0], non_blocking=True) for o in outs])
            for f in KeypointBuffer._fields])

    return fn


class VideoSiftFrontend:
    """Streaming video SIFT over a frames mesh: fixed (batch, shape), then
    feed frame batches (BASELINE.json config 3; the frame-parallel form of
    calling ``SiftPlan.keypoints`` in a loop).

    >>> fe = VideoSiftFrontend((1080, 1920), batch=4)
    >>> buf = fe(frames)          # (4, 1080, 1920) -> fields (4, N), ...
    """

    def __init__(self, frame_shape: Tuple[int, int], batch: int,
                 cfg: Optional[SiftConfig] = None, mesh: Optional[FramesMesh] = None):
        self.cfg = cfg or SiftConfig()
        self.mesh = mesh or make_frames_mesh()
        axis = self.mesh.axis_names[0]
        if batch % self.mesh.size:
            raise ValueError(f"batch {batch} not divisible by mesh size {self.mesh.size}")
        self.batch = batch
        self.frame_shape = tuple(frame_shape)
        self._fn = sharded_sift_fn(self.mesh, self.cfg, axis)

    def __call__(self, frames) -> KeypointBuffer:
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.asarray(frames, dtype=np.float32))
        frames = frames.to(torch.float32)
        if tuple(frames.shape) != (self.batch,) + self.frame_shape:
            raise ValueError(f"expected {(self.batch,) + self.frame_shape}, "
                             f"got {tuple(frames.shape)}")
        return self._fn(frames)
