"""flip_right batch doubling on device tensors (``planedepth_tpu/train/flip.py``
and ``train/distill.py:flip_w/flip_grid``, reference trainer.py:252-276).

Concatenates the horizontally flipped, L/R-swapped stereo pair onto the
batch: the flipped right image becomes a new left sample whose stereo
partner is the flipped left image.  The augmentation grid gets x negated and
mirrored; intrinsics and stereo extrinsics are repeated; temporal neighbours
are flipped in place, and their COLMAP poses repeated.  Tensors are NCHW.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def flip_w(x: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of an NCHW tensor."""
    return x.flip(-1)


def flip_grid(grid: torch.Tensor) -> torch.Tensor:
    """Flip the ``(B, 2, H, W)`` augmentation grid: negate x, mirror W."""
    return torch.cat([-grid[:, :1], grid[:, 1:]], dim=1).flip(-1)


def add_flip_right_inputs(inputs: Dict[str, torch.Tensor],
                          novel_frame_ids: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """The doubled batch, with the temporal frames ``novel_frame_ids``."""
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
    for f in novel_frame_ids:
        for prefix in ("color", "color_aug"):
            frame = inputs[f"{prefix}_{f}"]
            new[f"{prefix}_{f}"] = torch.cat([frame, flip_w(frame)])
        # COLMAP poses, repeated as the JAX package repairs the reference's
        # dropped keys (planedepth_tpu/train/flip.py:45-54)
        if f"Rt_{f}" in inputs:
            new[f"Rt_{f}"] = torch.cat([inputs[f"Rt_{f}"], inputs[f"Rt_{f}"]])
    return new
