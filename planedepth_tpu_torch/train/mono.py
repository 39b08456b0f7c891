"""The 2-D warp losses of the monocular and mixed recipes (``planedepth_tpu/train/mono.py``).

The reference trains mono through per-plane homographies or depth warps
(trainer.py:533-538,556-560) and assembles the same mixture losses as the
stereo path (trainer.py:701-773).  Here each target side's planes are warped
by ``ops/warp2d.py`` (the CUDA kernels on the card, the plain version on the
CPU) and the losses are assembled plane-first ``(B, N, H, W)``, the twin of
the JAX package's ``fused_warp2d_losses``: the sum over sides, the automask
minimum with pi and sigma held constant, ``mask_novel``, the perceptual loss
per side, and the distillation term added once per side.  Without the
mixture (``use_mixture_loss=False``) the warp takes the logits alone, the
composite weights are the softmax of the warped logits, and the photometric
term is the L1 of the composite with the ``mask_novel`` blend and the
automask minimum.  The warp samples exactly, so the TPU's tap plan
(``warp2d_plan``) has no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.geometry.warp import depth_warp_coords, homography_warp_coords
from planedepth_tpu_torch.ops.losses import smooth_loss_disp
from planedepth_tpu_torch.ops.warp2d import warp2d
from planedepth_tpu_torch.train.losses import perceptual_loss


def fused_warp2d_ok(cfg: TrainConfig) -> bool:
    """True when training routes every side through the 2-D warp: the
    homography and depth warps, all target sides, without ``use_mom`` (the
    JAX package sends that to its oracle).  The JAX package's rescue of
    ``render_probability`` and yz planes under ``disp_warp`` is not ported
    (ROADMAP A3, A10)."""
    return (cfg.fused_sweep and cfg.warp_type in ("homography_warp", "depth_warp")
            and not cfg.loss.use_mom)


def _coords_to_disp(coords: torch.Tensor, H: int, W: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised align_corners coordinates ``(..., H, W, 2)`` -> pixel
    displacements ``(dx, dy)``."""
    xs = (coords[..., 0] * 0.5 + 0.5) * (W - 1)
    ys = (coords[..., 1] * 0.5 + 0.5) * (H - 1)
    x = torch.arange(W, dtype=coords.dtype, device=coords.device)
    y = torch.arange(H, dtype=coords.dtype, device=coords.device)[:, None]
    return xs - x, ys - y


def _side_coords(cfg: TrainConfig, outputs: Dict[str, torch.Tensor], side,
                 poses: Dict, K: torch.Tensor, inv_K: torch.Tensor, H: int, W: int):
    """(dx, dy, mask) ``(B, N, H, W)`` of one target side: the homography
    under ``homography_warp``, else the depth warp (``depth_warp``, and the
    temporal sides of the mixed ``disp_warp`` recipe)."""
    if cfg.warp_type == "homography_warp":
        coords, mask = homography_warp_coords(outputs["distance"], outputs["norm"],
                                              poses[side], K, inv_K, H, W)
    else:
        coords = depth_warp_coords(outputs["disp_layered"], poses[side], K, inv_K, W)
        mask = outputs["padding_mask"].expand(coords.shape[:-1])
    dx, dy = _coords_to_disp(coords, H, W)
    return dx, dy, mask


def _laplace_nll(err: torch.Tensor, pi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """``-log(sum_n pi_n Laplace(err_n; sigma_n) + 1e-7)`` over dim 1."""
    M = (pi * 0.5 * torch.exp(-err / sigma) / sigma).sum(1)
    return -torch.log(torch.clamp_min(M, 0.0) + 1e-7)


def fused_warp2d_losses(bundle, outputs: Dict[str, torch.Tensor],
                        batch: Dict[str, torch.Tensor], poses: Dict,
                        sides: Optional[Sequence] = None,
                        include_smooth: bool = True) -> Dict[str, torch.Tensor]:
    """Loss dict of the 2-D warped target sides.

    ``sides`` and ``include_smooth`` serve the mixed ``disp_warp`` recipe:
    side 'r' rides the plane sweep, the temporal sides come here, and the
    smoothness term is left to the stereo part (the reference computes it
    once, outside its side loop, trainer.py:768-771).
    """
    cfg = bundle.cfg
    sides = cfg.target_sides if sides is None else sides
    color = "color_aug" if cfg.loss.match_aug else "color"
    source = batch[f"{color}_l"]                                     # (B, 3, H, W)
    B, _, H, W = source.shape
    mix = cfg.model.use_mixture_loss
    logits = outputs["logits"]                                       # (B, N, H, W)
    sigma = outputs["sigma"] if mix else None
    mask_novel = outputs.get("mask_novel")                           # (B, 1, H, W)

    zero = torch.zeros((), dtype=source.dtype, device=source.device)
    losses = {"loss/ph_loss": zero, "loss/pc_loss": zero, "loss/total_loss": zero}
    for side in sides:
        target = batch[f"{color}_{side}"]
        dx, dy, pmask = _side_coords(cfg, outputs, side, poses, batch["K"],
                                     batch["inv_K"], H, W)
        warped = warp2d(source, logits, sigma, dx, dy, pmask)
        rgb_l, logit_rec = warped[:2]
        pi = torch.softmax(logit_rec, dim=1)
        if mix:
            sigma_rec = torch.clamp(warped[2], 0.01, 1.0)
            u = pi / sigma_rec
            U = u.sum(1, keepdim=True)
            weights = u * torch.where(U > 1e-7, 1.0 / torch.clamp_min(U, 1e-7),
                                      torch.zeros_like(U))
        else:
            weights = pi
        rgb_rec = (rgb_l * weights[:, :, None]).sum(1)               # (B, 3, H, W)

        if mix:
            err = (rgb_l - target[:, None]).abs().mean(2)            # (B, N, H, W)
            ph = _laplace_nll(err, pi, sigma_rec)                    # (B, H, W)
            if cfg.loss.automask:
                err_a = (source - target).abs().mean(1, keepdim=True)   # (B, 1, H, W)
                ph = torch.minimum(ph, _laplace_nll(err_a, pi.detach(),
                                                    sigma_rec.detach()))
            if mask_novel is not None:
                ph = ph * mask_novel[:, 0]
        else:
            pred = rgb_rec
            if mask_novel is not None:
                pred = pred * mask_novel + target * (1.0 - mask_novel)
            ph = (pred - target).abs().mean(1)                       # (B, H, W)
            if cfg.loss.automask:
                ph = torch.minimum(ph, (source - target).abs().mean(1))
        ph_loss = ph.mean()
        losses["loss/ph_loss"] = losses["loss/ph_loss"] + ph_loss
        total = ph_loss

        if bundle.pc is not None:
            pred = rgb_rec
            if mask_novel is not None:
                pred = pred * mask_novel + target * (1.0 - mask_novel)
            pc = perceptual_loss(bundle.pc, pred, target,
                                 source if cfg.loss.automask else None, remat=cfg.pc_remat)
            losses["loss/pc_loss"] = losses["loss/pc_loss"] + pc
            total = total + cfg.loss.alpha_pc * pc

        if cfg.loss.self_distillation > 0 and "disp_pp" in outputs:
            # added once per side, as the reference's side loop does
            disp_loss = (outputs["disp"] - outputs["disp_pp"]).abs().mean()
            losses["loss/disp_loss"] = disp_loss
            total = total + cfg.loss.self_distillation * disp_loss
        losses["loss/total_loss"] = losses["loss/total_loss"] + total

    if include_smooth:
        x0 = int(0.2 * W)
        smooth = smooth_loss_disp(outputs["disp"][..., x0:], batch["color_l"][..., x0:],
                                  gamma=cfg.loss.gamma_smooth)
        losses["loss/smooth_loss"] = smooth
        losses["loss/total_loss"] = losses["loss/total_loss"] + cfg.loss.alpha_smooth * smooth
    return losses
