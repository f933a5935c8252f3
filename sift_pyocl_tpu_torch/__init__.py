"""sift_pyocl_tpu_torch -- the SIFT frontend and the VO step in PyTorch,
with hand-written CUDA kernels for Hopper (sm_90a).

A port of ``sift_pyocl_tpu`` (the JAX/Pallas package beside it, which stays
the reference).  Public API as there:
    SiftPlan, MatchPlan, LinearAlign, fit_affine, par, config_from_par,
    SiftConfig, KP_DTYPE, detect_and_describe, detect_and_describe_batched,
    KeypointBuffer,
    match_descriptors_jax, MatchResult, affine_warp (alias affine_warp_jax),
    ransac_affine, VOConfig, VOState, vo_init, vo_step,
    match_descriptors_dense
plus SLICE_CONFIG (the frontend with the plain pyramid, as run by the first
slice).  Entry points run on the CUDA card unless given ``device="cpu"``.
"""

import torch as _torch

# Full float32 in matmuls and convolutions: TF32 keeps ~3 decimal digits,
# and cuDNN's TF32 convolutions move the pyramid's DoGs by more than the
# extrema threshold's scale (the JAX package sets
# jax_default_matmul_precision="highest" for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import (SLICE_CONFIG, SiftConfig, config_from_par, from_jax_config,  # noqa: E402,F401
                     par)
from .oracle import KP_DTYPE  # noqa: E402,F401
from .models.sift import (KeypointBuffer, SiftPlan, detect_and_describe,  # noqa: E402,F401
                          detect_and_describe_batched)
from .models.match_align import LinearAlign, MatchPlan, fit_affine  # noqa: E402,F401
from .models.vo import VOConfig, VOState, vo_init, vo_step  # noqa: E402,F401
from .ops.match import MatchResult, match_descriptors_dense, match_descriptors_jax  # noqa: E402,F401
from .ops.transform import affine_warp, affine_warp_jax  # noqa: E402,F401
from .sfm.ransac import ransac_affine  # noqa: E402,F401

__version__ = "0.1.0"
