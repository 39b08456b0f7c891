"""Training losses, NCHW (``planedepth_tpu/train/losses.py``): the
self-reconstruction's reprojection loss, the perceptual loss and the
train-time depth metrics (reference trainer.py:672-699, 775-810)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from planedepth_tpu_torch.ops.losses import compute_depth_errors
from planedepth_tpu_torch.ops.ssim import ssim


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor,
                      use_ssim: bool) -> torch.Tensor:
    """L1, or ``0.85 * SSIM + 0.15 * L1``, per pixel: ``(B, 3, H, W)`` ->
    ``(B, 1, H, W)`` (reference trainer.py:687-699)."""
    l1 = (target - pred).abs().mean(1, keepdim=True)
    if use_ssim:
        return 0.85 * ssim(pred, target).mean(1, keepdim=True) + 0.15 * l1
    return l1


def perceptual_loss(pc: Callable, pred: torch.Tensor, target: torch.Tensor,
                    source: Optional[torch.Tensor] = None,
                    remat: bool = True) -> torch.Tensor:
    """Feature MSE over the 3 slices of the frozen net ``pc``, with the
    automask minimum against ``source`` when given.

    Only ``pred`` carries a cotangent: its extraction is checkpointed when
    ``remat`` (one more forward in the backward, the same numbers); target
    and source are extracted without a graph.
    """
    pred_f = checkpoint(pc, pred, use_reentrant=False) if remat else pc(pred)
    with torch.no_grad():
        target_f = pc(target)
        source_f = pc(source) if source is not None else None
    loss = 0.0
    for i in range(3):
        l_p = ((pred_f[i] - target_f[i]) ** 2).mean(1, keepdim=True)
        if source_f is not None:
            l_auto = ((source_f[i] - target_f[i]) ** 2).mean(1, keepdim=True)
            l_p = torch.minimum(l_p, l_auto)
        loss = loss + l_p.mean()
    return loss


@torch.no_grad()
def compute_depth_metrics(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                          grid: torch.Tensor,
                          stereo_scale: bool = True) -> Dict[str, torch.Tensor]:
    """Train-time depth metrics on ``(B, 1, H, W)`` depths and the
    ``(B, 2, H, W)`` grid: rescale by the crop-width ratio, clamp to
    [1e-3, 80], Garg crop on valid GT, then x5.4 (stereo) or the GT/pred
    median ratio (mono)."""
    width_span = grid[:, 0:1, 0:1, -1:] - grid[:, 0:1, 0:1, 0:1]
    depth_pred = (depth_pred * 2.0 / width_span).clamp(1e-3, 80.0)
    _, _, H, W = depth_gt.shape
    ys = torch.arange(H, device=depth_gt.device)[:, None]
    xs = torch.arange(W, device=depth_gt.device)[None, :]
    crop = ((ys >= int(0.40810811 * H)) & (ys < int(0.99189189 * H))
            & (xs >= int(0.03594771 * W)) & (xs < int(0.96405229 * W)))
    weights = ((depth_gt > 0) & crop).to(depth_gt.dtype)
    gt = depth_gt.clamp(1e-3, 80.0)
    if stereo_scale:
        pred = depth_pred * 5.4
    else:
        live = weights > 0
        ratio = torch.quantile(gt[live], 0.5) / torch.quantile(depth_pred[live], 0.5)
        pred = depth_pred * ratio
    return compute_depth_errors(gt, pred, weights=weights)
