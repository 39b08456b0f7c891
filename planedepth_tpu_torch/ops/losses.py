"""Loss primitives, NCHW (``planedepth_tpu/ops/losses.py``): the mixture NLL,
edge-aware smoothness of a disparity or of a probability volume, and the
weighted depth errors (reference layers.py:243-273, 356-374, 451-466).  The
plane axis is dim 1."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def gaussian_pdf(error: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(reference layers.py:451-452)"""
    return torch.exp(-0.5 * error ** 2 / sigma ** 2) / sigma / math.sqrt(2.0 * math.pi)


def laplacian_pdf(error: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(reference layers.py:454-455)"""
    return 0.5 * torch.exp(-error.abs() / b) / b


def multimodal_nll(error: torch.Tensor, sigma: torch.Tensor, pi: torch.Tensor,
                   dist: str = "lap", dim: int = 1) -> torch.Tensor:
    """``-log(sum_n pi_n p(error_n; sigma_n) + 1e-7)`` over the plane axis
    ``dim``, kept with size 1 (reference layers.py:465-466).  The mixture is
    clamped at 0 first, as the JAX package does: under render_probability
    with ground planes the composited weights leave [0, 1] and the
    reference takes the log of a negative mixture."""
    pdf = gaussian_pdf if dist == "gaussian" else laplacian_pdf
    mix = (pi * pdf(error, sigma)).sum(dim, keepdim=True)
    return -torch.log(mix.clamp_min(0.0) + 1e-7)


def smooth_loss_disp(disp: torch.Tensor, img: torch.Tensor,
                     gamma: float = 1.0) -> torch.Tensor:
    """Edge-aware first-order smoothness of disp ``(B, 1, H, W)`` weighted by
    the gradients of img ``(B, 3, H, W)``."""
    dx = (disp[..., :-1] - disp[..., 1:]).abs()
    dy = (disp[..., :-1, :] - disp[..., 1:, :]).abs()
    ix = (img[..., :-1] - img[..., 1:]).abs().mean(1, keepdim=True)
    iy = (img[..., :-1, :] - img[..., 1:, :]).abs().mean(1, keepdim=True)
    return (dx * torch.exp(-gamma * ix)).mean() + (dy * torch.exp(-gamma * iy)).mean()


def smooth_loss_probability(probability: torch.Tensor, disp_layered: torch.Tensor,
                            img: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Smoothness of the probability volume ``(B, N, H, W)``, each plane's
    change weighted by the mean disparity ``disp_layered`` ``(B, N, H, W_b)``
    of the two pixels and by the gradients of img ``(B, 3, H, W)``
    (reference layers.py:258-273)."""
    d = disp_layered.expand_as(probability)
    dpx = ((probability[..., :-1] - probability[..., 1:]).abs()
           * (d[..., :-1] + d[..., 1:]) / 2.0).sum(1, keepdim=True)
    dpy = ((probability[..., :-1, :] - probability[..., 1:, :]).abs()
           * (d[..., :-1, :] + d[..., 1:, :]) / 2.0).sum(1, keepdim=True)
    ix = (img[..., :-1] - img[..., 1:]).abs().mean(1, keepdim=True)
    iy = (img[..., :-1, :] - img[..., 1:, :]).abs().mean(1, keepdim=True)
    return (dpx * torch.exp(-gamma * ix)).mean() + (dpy * torch.exp(-gamma * iy)).mean()


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
