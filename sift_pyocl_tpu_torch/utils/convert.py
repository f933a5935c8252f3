"""Carry arrays between the JAX package and this one.

SIFT has no weights: the config (``config.from_jax_config``) and the arrays
a stage consumes -- DoG stacks, masks, candidate arrays, gradient planes --
are all the state that crosses.  Any object with ``__array__`` (numpy, or a
JAX array) converts without importing jax here.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch


def to_torch(x: Any, device: Optional[Union[str, torch.device]] = None) -> Any:
    """Array -> tensor (dtype kept, bool stays bool); lists, tuples and
    NamedTuples are converted element by element; Python scalars pass."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_torch(v, device) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_torch(v, device) for v in x)
    if isinstance(x, (int, float, bool)):
        return x
    if torch.is_tensor(x):
        return x.to(device) if device is not None else x
    return torch.from_numpy(np.array(x)).to(device or "cpu")


def to_numpy(x: Any) -> Any:
    """Tensor -> numpy (via the CPU); containers element by element."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_numpy(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return x
