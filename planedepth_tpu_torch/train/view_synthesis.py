"""The self-reconstruction of ``alpha_self`` (``planedepth_tpu/train/view_synthesis.py:pred_self_images``).

The left view is rebuilt from the right image at the expected disparity
(reference trainer.py:605-633): the disparity becomes a depth, is
backprojected and projected into the right camera, and the right image is
sampled there bilinearly with border padding, in the align_corners=True
convention.  That is one ``F.grid_sample`` of a 3-channel image, the
function the JAX package computes with an XLA gather
(``ops/sampling.py:grid_sample``); the gradient reaches the disparity
through the coordinates.  The oracle's per-plane view synthesis
(``pred_novel_images``) is not ported (ROADMAP A4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from planedepth_tpu_torch.geometry.camera import backproject_depth, disp_to_depth, project_3d


def pred_self_images(disp: torch.Tensor, target_rgb: torch.Tensor, Rt_r: torch.Tensor,
                     K: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """disp ``(B, 1, H, W)`` expected disparity, target_rgb ``(B, 3, H, W)``
    the right image, ``Rt_r``, ``K``, ``inv_K`` ``(B, 4, 4)`` -> the
    reconstruction of the left view ``(B, 3, H, W)``."""
    B, _, H, W = disp.shape
    cam_points = backproject_depth(disp_to_depth(disp[:, 0], W), inv_K)
    coords = project_3d(cam_points, K, Rt_r, H, W)                   # (B, H, W, 2)
    return F.grid_sample(target_rgb, coords, mode="bilinear", padding_mode="border",
                         align_corners=True)
