"""Wrappers of the hand-written CUDA kernels, each beside its plain version.

Every wrapper takes a CPU tensor to its plain PyTorch version (same module,
``*_ref``) and a CUDA tensor to its kernel, and counts its kernel launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Dict

from .compact import compact_mask, compact_masks_multi
from .conv import separable_blur
from .gradpad import grad_atlas
from .ladder import (octave0_ladder, octave0_ladder_mask, small_octaves_ladder,
                     small_octaves_ladder_mask)
from .linalg import svd3, sym_eig_small
from .maskk import extrema_masks
from .matchk import best2_l2, best2_l2_f32
from .refine import refine_multi, refine_octave
from .window import descriptor_hist, orient_desc_fused, orientation_hist

KERNEL_WRAPPERS = (octave0_ladder, small_octaves_ladder, compact_masks_multi, refine_multi,
                   grad_atlas, orient_desc_fused, best2_l2, extrema_masks, separable_blur,
                   compact_mask, refine_octave, orientation_hist, descriptor_hist,
                   octave0_ladder_mask, small_octaves_ladder_mask, best2_l2_f32,
                   sym_eig_small, svd3)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
