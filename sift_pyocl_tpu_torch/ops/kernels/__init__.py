"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

Every wrapper takes a CPU tensor to its plain PyTorch version (same module,
``*_ref``) and a CUDA tensor to its kernel, and counts its kernel launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Dict

from .compact import compact_masks_multi
from .gradpad import grad_atlas
from .refine import refine_multi
from .window import orient_desc_fused

KERNEL_WRAPPERS = (compact_masks_multi, refine_multi, grad_atlas, orient_desc_fused)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
