"""sift_pyocl_tpu_torch -- the SIFT frontend in PyTorch, with hand-written
CUDA kernels for Hopper (sm_90a).

A port of ``sift_pyocl_tpu`` (the JAX/Pallas package beside it, which stays
the reference).  Public API as there:
    SiftPlan, SiftConfig, KP_DTYPE, detect_and_describe, KeypointBuffer
plus SLICE_CONFIG, the configuration that runs end to end on the card.
"""

import torch as _torch

# Full float32 in matmuls and convolutions: TF32 keeps ~3 decimal digits,
# and cuDNN's TF32 convolutions move the pyramid's DoGs by more than the
# extrema threshold's scale (the JAX package sets
# jax_default_matmul_precision="highest" for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import SLICE_CONFIG, SiftConfig, from_jax_config  # noqa: E402,F401
from .oracle import KP_DTYPE  # noqa: E402,F401
from .models.sift import KeypointBuffer, SiftPlan, detect_and_describe  # noqa: E402,F401

__version__ = "0.1.0"
