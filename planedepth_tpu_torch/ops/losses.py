"""Loss primitives, NCHW (``planedepth_tpu/ops/losses.py``): edge-aware
smoothness and the weighted depth errors (reference layers.py:243-256,
356-374)."""
from __future__ import annotations

from typing import Dict, Optional

import torch


def smooth_loss_disp(disp: torch.Tensor, img: torch.Tensor,
                     gamma: float = 1.0) -> torch.Tensor:
    """Edge-aware first-order smoothness of disp ``(B, 1, H, W)`` weighted by
    the gradients of img ``(B, 3, H, W)``."""
    dx = (disp[..., :-1] - disp[..., 1:]).abs()
    dy = (disp[..., :-1, :] - disp[..., 1:, :]).abs()
    ix = (img[..., :-1] - img[..., 1:]).abs().mean(1, keepdim=True)
    iy = (img[..., :-1, :] - img[..., 1:, :]).abs().mean(1, keepdim=True)
    return (dx * torch.exp(-gamma * ix)).mean() + (dy * torch.exp(-gamma * iy)).mean()


def compute_depth_errors(gt: torch.Tensor, pred: torch.Tensor,
                         weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The seven depth metrics as weighted means over 0/1 ``weights``."""
    if weights is None:
        weights = torch.ones_like(gt)
    wsum = weights.sum().clamp_min(1.0)
    live = weights > 0

    def wmean(x):
        return (x * weights).sum() / wsum

    thresh = torch.maximum(gt / pred, pred / gt)
    safe_gt = torch.where(live, gt, torch.ones_like(gt))
    safe_pred = torch.where(live, pred, torch.ones_like(pred))
    return {
        "de/abs_rel": wmean((gt - pred).abs() / safe_gt),
        "de/sq_rel": wmean((gt - pred) ** 2 / safe_gt),
        "de/rms": torch.sqrt(wmean((gt - pred) ** 2)),
        "de/log_rms": torch.sqrt(wmean((torch.log(safe_gt) - torch.log(safe_pred)) ** 2)),
        "da/a1": wmean((thresh < 1.25).to(gt.dtype)),
        "da/a2": wmean((thresh < 1.25 ** 2).to(gt.dtype)),
        "da/a3": wmean((thresh < 1.25 ** 3).to(gt.dtype)),
    }
