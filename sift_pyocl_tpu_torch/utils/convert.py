"""Carry arrays between the JAX package and this one.

SIFT and VO have no weights: the configs (``config.from_jax_config``,
``vo_config_from_jax``), the arrays a stage consumes -- DoG stacks, masks,
candidate arrays, gradient planes -- and the VO state, keypoint buffers and
BA problems are all that crosses.  Any object with ``__array__`` (numpy, or
a JAX array) converts without importing jax here.
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


def _named_from_jax(cls, obj, device):
    """The port's NamedTuple `cls` from the JAX one `obj`, field by field
    (``np.asarray`` per field, dtypes kept)."""
    return cls(*(torch.from_numpy(np.array(np.asarray(getattr(obj, f)))).to(device)
                 for f in cls._fields))


def vo_state_from_jax(state, device: Union[str, torch.device] = "cpu"):
    """``models.vo.VOState`` from a ``sift_pyocl_tpu.models.vo.VOState``."""
    from ..models.vo import VOState

    return _named_from_jax(VOState, state, device)


def vo_config_from_jax(vo):
    """``models.vo.VOConfig`` from the JAX package's ``VOConfig``."""
    from ..models.vo import VOConfig

    return VOConfig(**vo._asdict())


def keypoint_buffer_from_jax(buf, device: Union[str, torch.device] = "cpu"):
    """``models.sift.KeypointBuffer`` from the JAX package's."""
    from ..models.sift import KeypointBuffer

    return _named_from_jax(KeypointBuffer, buf, device)


def refined_keypoints_from_jax(kps, device: Union[str, torch.device] = "cpu"):
    """``ops.detect.RefinedKeypoints`` from the JAX package's."""
    from ..ops.detect import RefinedKeypoints

    return _named_from_jax(RefinedKeypoints, kps, device)


def oriented_keypoints_from_jax(okps, device: Union[str, torch.device] = "cpu"):
    """``ops.orient_desc.OrientedKeypoints`` from the JAX package's."""
    from ..ops.orient_desc import OrientedKeypoints

    return _named_from_jax(OrientedKeypoints, okps, device)


def ba_params_from_jax(params, device: Union[str, torch.device] = "cpu"):
    """``sfm.ba.BAParams`` from the JAX package's."""
    from ..sfm.ba import BAParams

    return _named_from_jax(BAParams, params, device)


def ba_obs_from_jax(obs, device: Union[str, torch.device] = "cpu"):
    """``sfm.ba.BAObs`` from the JAX package's."""
    from ..sfm.ba import BAObs

    return _named_from_jax(BAObs, obs, device)
