"""Pipeline parallelism: the pyramid and detect/describe stages on two devices.

Port of ``sift_pyocl_tpu/parallel/pipeline_octaves.py``.  Stage 0 builds a
frame's scale space (``ops.pyramid.build_scale_space``: K1/K2) on the first
device, the octaves cross to the second with non-blocking copies, and stage
1 runs detection, orientation and descriptors there
(``models.sift.describe_octaves``: K3-K6).  PyTorch launches asynchronously
and neither stage synchronises with the host, so the host enqueues frame
i's stage 0 while frame i-1's stage 1 still runs, and with two cards the
steady-state rate approaches 1 / max(stage time).  With one card both
stages run on it, in order, on its current stream (the JAX package doubles
a single device the same way).

The JAX package jits each stage.  On a CUDA device each stage here replays
a CUDA graph: stage 0 one per (device, frame shape, ``SiftConfig``)
(``STAGE0_GRAPHS``: K1/K2, or K1m/K2m with ``mask_backend="fused"``, whose
masks stage 1 does not take, as in the JAX package), stage 1 one per
(device, octave shapes, frame shape, ``SiftConfig``) (``STAGE1_GRAPHS``:
K3-K6, K8 with ``"pallas"``); the replays' outputs are fresh buffers, so
the octave stacks cross between them by non-blocking copies.  On the CPU
the stages run eagerly (``_stage0_eager``, ``_stage1_eager``).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import SiftConfig
from ..models.sift import KeypointBuffer, describe_octaves
from ..ops import resolve_device
from ..ops.pyramid import build_scale_space
from ..utils import graphs


def _stage0_flat(cfg: SiftConfig, img: torch.Tensor):
    """Stage 0 (a graph body): the scale space of f32 `img`, flat (blurs 0,
    dogs 0, blurs 1, ...)."""
    return tuple(t for ladder in build_scale_space(img, cfg) for t in ladder)


def _stage1_flat(static, *flat):
    """Stage 1 (a graph body): the keypoint buffer's fields from the flat
    octave stacks."""
    shape, cfg = static
    return tuple(describe_octaves(list(zip(flat[0::2], flat[1::2])), shape, cfg))


# the two stages on the card (the JAX package's two jitted stage programs)
STAGE0_GRAPHS = graphs.GraphCache(_stage0_flat)
STAGE1_GRAPHS = graphs.GraphCache(_stage1_flat)


def stage0(img: torch.Tensor, cfg: SiftConfig, device: torch.device):
    """Stage 0 of f32 `img` (host or device) on `device`, flat: on a card
    the replay of ``STAGE0_GRAPHS``' graph, elsewhere the eager call."""
    if device.type != "cuda":
        return _stage0_eager(img, cfg, device)
    return STAGE0_GRAPHS(device, cfg, (img,))


def _stage0_eager(img: torch.Tensor, cfg: SiftConfig, device: torch.device):
    return _stage0_flat(cfg, img.to(device, non_blocking=True))


def stage1(flat, shape: Tuple[int, int], cfg: SiftConfig) -> KeypointBuffer:
    """Stage 1 on the device of the flat octave stacks: on a card the
    replay of ``STAGE1_GRAPHS``' graph, elsewhere the eager call."""
    if flat[0].device.type != "cuda":
        return _stage1_eager(flat, shape, cfg)
    return KeypointBuffer(*STAGE1_GRAPHS(flat[0].device, (tuple(shape), cfg), flat))


def _stage1_eager(flat, shape: Tuple[int, int], cfg: SiftConfig) -> KeypointBuffer:
    return KeypointBuffer(*_stage1_flat((tuple(shape), cfg), *flat))


class TwoStagePipeline:
    """Pipelined SIFT frontend over a frame stream.

    >>> pipe = TwoStagePipeline((1080, 1920), cfg)
    >>> for buf in pipe.process(frames):
    ...     ...                     # KeypointBuffer per frame, in order

    `devices`: the two stages' devices (default: the first two CUDA cards,
    or the one card twice; raises without a card).  Pass
    ``[torch.device("cpu")] * 2`` to run on the CPU."""

    def __init__(self, shape: Tuple[int, int], cfg: SiftConfig,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        if devices is None:
            resolve_device(None)            # raises without a CUDA card
            devices = [torch.device("cuda", i) for i in range(min(torch.cuda.device_count(), 2))]
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("TwoStagePipeline needs at least one device")
        if len(devs) < 2:
            devs = devs * 2   # one device runs both stages
        self.d0, self.d1 = devs[0], devs[1]
        self.shape = tuple(shape)
        self.cfg = cfg

    def process(self, frames: Iterable) -> Iterator[KeypointBuffer]:
        """Yield per-frame keypoint buffers (on the second device), in order,
        one frame behind: frame i's stage 0 is enqueued before frame i-1's
        buffer is handed out, and the loop never waits for the devices."""
        pending = None
        for f in frames:
            img = f if torch.is_tensor(f) else torch.from_numpy(np.asarray(f, dtype=np.float32))
            flat = [t.to(self.d1, non_blocking=True)
                    for t in stage0(img.to(torch.float32), self.cfg, self.d0)]
            if pending is not None:
                yield pending
            pending = stage1(flat, self.shape, self.cfg)
        if pending is not None:
            yield pending
