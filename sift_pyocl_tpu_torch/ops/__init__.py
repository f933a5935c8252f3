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


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")
