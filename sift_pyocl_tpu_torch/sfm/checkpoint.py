"""Checkpoint / resume for SfM and VO state.

Port of ``sift_pyocl_tpu/sfm/checkpoint.py``: plain ``.npz`` snapshots with
the same keys (``Rs``, ``ts``, ``X`` and any extra arrays for BA; one key
per ``VOState`` field for VO), so a file written by either package loads
in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..ops import resolve_device
from .ba import BAParams


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_ba(path: Union[str, Path], params: BAParams, **extra) -> None:
    """Snapshot BA parameters (and any named arrays, e.g. observation
    tables); tensors on any device or arrays."""
    np.savez_compressed(path, Rs=_np(params.Rs), ts=_np(params.ts), X=_np(params.X),
                        **{k: _np(v) for k, v in extra.items()})


def load_ba(path: Union[str, Path], device=None):
    """Returns (BAParams of tensors on `device`, dict of the extra arrays as
    NumPy).  `device` None means the CUDA card (raises without one)."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        params = BAParams(*(torch.from_numpy(z[k]).to(dev) for k in ("Rs", "ts", "X")))
        extra = {k: z[k] for k in z.files if k not in ("Rs", "ts", "X")}
    return params, extra


def save_vo(path: Union[str, Path], state) -> None:
    """Snapshot a ``models.vo.VOState`` (every field is a tensor)."""
    np.savez_compressed(path, **{k: _np(v) for k, v in state._asdict().items()})


def load_vo(path: Union[str, Path], device=None):
    """Restore a ``models.vo.VOState`` from a ``save_vo`` file, on `device`
    (None means the CUDA card; raises without one)."""
    from ..models.vo import VOState

    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        return VOState(**{k: torch.from_numpy(z[k]).to(dev) for k in z.files})
