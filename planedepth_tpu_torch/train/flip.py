"""flip_right batch doubling on device tensors (``planedepth_tpu/train/flip.py``
and ``train/distill.py:flip_w/flip_grid``, reference trainer.py:252-276).

Concatenates the horizontally flipped, L/R-swapped stereo pair onto the
batch: the flipped right image becomes a new left sample whose stereo
partner is the flipped left image.  The augmentation grid gets x negated and
mirrored; intrinsics and stereo extrinsics are repeated.  Tensors are NCHW.
"""
from __future__ import annotations

from typing import Dict

import torch


def flip_w(x: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of an NCHW tensor."""
    return x.flip(-1)


def flip_grid(grid: torch.Tensor) -> torch.Tensor:
    """Flip the ``(B, 2, H, W)`` augmentation grid: negate x, mirror W."""
    return torch.cat([-grid[:, :1], grid[:, 1:]], dim=1).flip(-1)


def add_flip_right_inputs(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The doubled stereo batch.  Temporal neighbours are not ported yet
    (ROADMAP A10)."""
    new: Dict[str, torch.Tensor] = {}
    for prefix in ("color", "color_aug", "depth_gt"):
        if f"{prefix}_l" not in inputs:
            continue
        left, right = inputs[f"{prefix}_l"], inputs[f"{prefix}_r"]
        new[f"{prefix}_l"] = torch.cat([left, flip_w(right)])
        new[f"{prefix}_r"] = torch.cat([right, flip_w(left)])
    new["grid"] = torch.cat([inputs["grid"], flip_grid(inputs["grid"])])
    for k in ("K", "inv_K", "Rt_l", "Rt_r"):
        new[k] = torch.cat([inputs[k], inputs[k]])
    return new
