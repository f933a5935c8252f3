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
a single device the same way); each stage's first call makes the
per-stream state of its kernels (K2's work list, K3's scratch) there.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import SiftConfig
from ..models.sift import KeypointBuffer, describe_octaves
from ..ops import resolve_device
from ..ops.pyramid import build_scale_space


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

    def _stage0(self, frame) -> list:
        img = frame if torch.is_tensor(frame) else torch.from_numpy(
            np.asarray(frame, dtype=np.float32))
        return build_scale_space(img.to(self.d0, torch.float32, non_blocking=True), self.cfg)

    def process(self, frames: Iterable) -> Iterator[KeypointBuffer]:
        """Yield per-frame keypoint buffers (on the second device), in order,
        one frame behind: frame i's stage 0 is enqueued before frame i-1's
        buffer is handed out, and the loop never waits for the devices."""
        pending = None
        for f in frames:
            octaves = [(b.to(self.d1, non_blocking=True), d.to(self.d1, non_blocking=True))
                       for b, d in self._stage0(f)]
            if pending is not None:
                yield pending
            pending = describe_octaves(octaves, self.shape, self.cfg)
        if pending is not None:
            yield pending
