"""Training losses, NCHW (``planedepth_tpu/train/losses.py``): the
self-reconstruction's reprojection loss, the perceptual loss, the loss
assembly of the oracle view synthesis and the train-time depth metrics
(reference trainer.py:672-810)."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from planedepth_tpu_torch.config import LossConfig
from planedepth_tpu_torch.models.layers import upcast
from planedepth_tpu_torch.ops.losses import (
    compute_depth_errors,
    multimodal_nll,
    smooth_loss_disp,
)
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
    and source are extracted without a graph.  The feature differences are
    float32 whatever the net's dtype (``planedepth_tpu/train/losses.py:74-81``).
    """
    pred_f = checkpoint(pc, pred, use_reentrant=False) if remat else pc(pred)
    with torch.no_grad():
        target_f = pc(target)
        source_f = pc(source) if source is not None else None
    loss = 0.0
    for i in range(3):
        t = upcast(target_f[i])
        l_p = ((upcast(pred_f[i]) - t) ** 2).mean(1, keepdim=True)
        if source_f is not None:
            l_auto = ((upcast(source_f[i]) - t) ** 2).mean(1, keepdim=True)
            l_p = torch.minimum(l_p, l_auto)
        loss = loss + l_p.mean()
    return loss


def compute_losses(cfg: LossConfig, target_sides: Sequence,
                   inputs: Dict[str, torch.Tensor], outputs: Dict[str, torch.Tensor],
                   rec: Dict, pc: Optional[Callable], use_mixture_loss: bool,
                   pc_remat: bool = True) -> Dict[str, torch.Tensor]:
    """The loss dict of the oracle view synthesis (reference
    trainer.py:701-773), ``rec`` from ``pred_novel_images`` (with
    ``("self_rec", "r")`` under ``alpha_self``).

    As the reference does in effect, the side losses are summed, not
    averaged (its per-side division rebinds a local), and the distillation
    term is added once per side.  Per side: the composite blended with the
    target by ``mask_novel``; with the mixture the Laplacian mixture NLL of
    the per-plane errors, its automask minimum against the NLL of the
    identity error ``mean_c |source - target|`` at the same pi and sigma held
    constant, times ``mask_novel``; without it the L1 with the automask
    minimum; the perceptual loss; on side 'r' the self-reconstruction
    loss.  Then the edge-aware smoothness of ``disp`` on the right 80% of
    the columns.
    """
    color = "color_aug" if cfg.match_aug else "color"
    zero = torch.zeros((), dtype=outputs["disp"].dtype, device=outputs["disp"].device)
    losses = {"loss/ph_loss": zero, "loss/pc_loss": zero, "loss/total_loss": zero}
    if cfg.alpha_self > 0:
        losses["loss/self_loss"] = zero
    mask = outputs.get("mask_novel")                                  # (B, 1, H, W)
    source = inputs[f"{color}_l"]
    for side in target_sides:
        pred = rec[("rgb_rec", side)]
        target = inputs[f"{color}_{side}"]
        if mask is not None:
            pred = pred * mask + target * (1.0 - mask)
        if use_mixture_loss:
            err = (rec[("rgb_rec_layered", side)] - target[:, None]).abs().mean(2)
            sigma_rec, pi_rec = rec[("sigma_rec", side)], rec[("pi_rec", side)]
            ph = multimodal_nll(err, sigma_rec, pi_rec)                 # (B, 1, H, W)
            if cfg.automask:
                err_auto = (source - target).abs().mean(1, keepdim=True)
                ph = torch.minimum(ph, multimodal_nll(err_auto, sigma_rec.detach(),
                                                      pi_rec.detach()))
            if mask is not None:
                ph = ph * mask
        else:
            ph = (pred - target).abs().mean(1, keepdim=True)
            if cfg.automask:
                ph = torch.minimum(ph, (source - target).abs().mean(1, keepdim=True))
        ph_loss = ph.mean()
        losses["loss/ph_loss"] = losses["loss/ph_loss"] + ph_loss
        total = ph_loss
        if pc is not None:
            pc_loss = perceptual_loss(pc, pred, target, source if cfg.automask else None,
                                      remat=pc_remat)
            losses["loss/pc_loss"] = losses["loss/pc_loss"] + pc_loss
            total = total + cfg.alpha_pc * pc_loss
        if cfg.alpha_self > 0 and side == "r":
            # stereo only: the right image resampled at the expected
            # disparity (reference trainer.py:605-633)
            self_loss = reprojection_loss(rec[("self_rec", side)], source, cfg.use_ssim).mean()
            losses["loss/self_loss"] = losses["loss/self_loss"] + self_loss
            total = total + cfg.alpha_self * self_loss
        if cfg.self_distillation > 0:
            disp_loss = (outputs["disp"] - outputs["disp_pp"]).abs().mean()
            losses["loss/disp_loss"] = disp_loss
            total = total + cfg.self_distillation * disp_loss
        losses["loss/total_loss"] = losses["loss/total_loss"] + total

    x0 = int(0.2 * outputs["disp"].shape[-1])
    smooth = smooth_loss_disp(outputs["disp"][..., x0:], inputs["color_l"][..., x0:],
                              gamma=cfg.gamma_smooth)
    losses["loss/smooth_loss"] = smooth
    losses["loss/total_loss"] = losses["loss/total_loss"] + cfg.alpha_smooth * smooth
    return losses


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
