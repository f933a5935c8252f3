"""Device helpers (the counterpart of the JAX package's ``on_tpu``).

Kernel wrappers dispatch on the device of the tensor they are given: a CPU
tensor goes to the plain PyTorch version, a CUDA tensor to the hand-written
kernel.  There is no global device; callers pass one.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA card,
    and raises when there is none (the CPU is only ever asked for)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device (torch.cuda.is_available() is False); '
                               'pass device="cpu" to run on the CPU')
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def nonzero_first(flags: torch.Tensor, size: int):
    """The first `size` set positions of 1-D `flags`, in order, as
    ``jnp.nonzero(flags, size=size)`` gives them, with no host
    synchronisation.  Returns (idx (size,) int64, zeros past the count;
    valid (size,) bool; count () int32, the number set, which may exceed
    `size`)."""
    f = flags.bool()
    rank = torch.cumsum(f, 0) - 1
    slot = torch.where(f & (rank < size), rank, size)   # the rest go to a spare slot
    idx = torch.zeros(size + 1, dtype=torch.long, device=f.device)
    idx.scatter_(0, slot, torch.arange(f.numel(), device=f.device))
    count = f.sum()
    return idx[:size], torch.arange(size, device=f.device) < count, count.to(torch.int32)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
