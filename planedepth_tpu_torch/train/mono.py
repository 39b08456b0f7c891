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

The stereo ``disp_warp`` recipes that the plane sweep cannot take come here
too (the JAX package's rescue): ``render_probability``, whose loss needs the
per-plane warped logits, and yz side planes, whose disparity varies along
the row.  A stereo side is the ``dx = -/+disp, dy = 0`` case of the warp,
and under ``render_probability`` the composite weights are the NeRF
compositing of the warped densities over the source view's ``dists``.
Under ``alpha_self`` side 'r' adds the self-reconstruction loss.
Under ``cfg.bf16`` or ``cfg.warp_sample_bf16`` the source image and the
plane heads enter the warp in bf16 and its stacks come back bf16, upcast
before any loss arithmetic (``planedepth_tpu/train/mono.py:276-285``).

On row shards (a spatial mesh axis) the warp runs on the whole image, as
the JAX package's ``shard_kernel`` gathers its operands over the
``spatial`` axis (``planedepth_tpu/train/mono.py:302-307``): every rank of
the spatial group gathers the source image, the logits and sigma, and the
plane maps the coordinates read (``parallel/halo.py:gather_rows``, whose
backward returns each row's cotangent to its owner); computes each side's
coordinates, ``(dx, dy, mask)``, on the whole image after the gather, from
those maps and the poses, which every rank holds whole; warps the whole
image with the unchanged kernels; and keeps its own rows of the warped
stacks (``own_rows``).  The losses are its rows' shares
(``parallel/halo.py:shard_mean``); the automask minimum is per pixel.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.geometry.warp import (
    depth_warp_coords,
    disp_warp_shift,
    homography_warp_coords,
)
from planedepth_tpu_torch.models.depth_decoder import render_probability_from_logits
from planedepth_tpu_torch.models.layers import to_dtype, upcast
from planedepth_tpu_torch.ops.losses import multimodal_nll, smooth_loss_disp
from planedepth_tpu_torch.ops.warp2d import warp2d
from planedepth_tpu_torch.parallel.halo import gather_rows, own_rows, shard_mean
from planedepth_tpu_torch.train.losses import perceptual_loss, reprojection_loss
from planedepth_tpu_torch.train.view_synthesis import pred_self_images


def fused_warp2d_ok(cfg: TrainConfig) -> bool:
    """True when training routes every side through the 2-D warp: the
    homography and depth warps, and the ``disp_warp`` recipes with
    ``render_probability`` or yz side planes (the rescue), all target
    sides, without ``use_mom``: its mirror occlusion mask reads the oracle
    view synthesis's right-view probability, so those recipes train
    through the oracle (``train/step.py:oracle_losses``), as in the JAX
    package."""
    rescue = cfg.warp_type == "disp_warp" and (
        cfg.model.render_probability or cfg.model.planes.yz_levels > 0)
    return (cfg.fused_sweep
            and (cfg.warp_type in ("homography_warp", "depth_warp") or rescue)
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


def _side_coords(cfg: TrainConfig, planes: Dict[str, torch.Tensor], side,
                 poses: Dict, K: torch.Tensor, inv_K: torch.Tensor, H: int, W: int):
    """(dx, dy, mask) ``(B, N, H, W)`` of one target side of an image of
    ``H`` rows, from its ``planes`` (``disp_layered`` and ``padding_mask``
    of those rows; ``distance`` and ``norm``): the stereo shift of a
    stereo side under ``disp_warp``, the homography under
    ``homography_warp``, else the depth warp (``depth_warp``, and the
    temporal sides of the mixed ``disp_warp`` recipe)."""
    if cfg.warp_type == "disp_warp" and side in ("l", "r"):
        d = planes["disp_layered"]
        shape = d.shape[:3] + (W,)
        dx = disp_warp_shift(d, side).expand(shape).contiguous()
        return dx, torch.zeros_like(dx), planes["padding_mask"].expand(shape).contiguous()
    if cfg.warp_type == "homography_warp":
        coords, mask = homography_warp_coords(planes["distance"], planes["norm"],
                                              poses[side], K, inv_K, H, W)
    else:
        coords = depth_warp_coords(planes["disp_layered"], poses[side], K, inv_K, W)
        mask = planes["padding_mask"].expand(coords.shape[:-1])
    dx, dy = _coords_to_disp(coords, H, W)
    return dx, dy, mask


def self_reconstruction_loss(cfg: TrainConfig, disp: torch.Tensor,
                             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``alpha_self``'s term (reference trainer.py:605-633): the mean
    reprojection loss of the left view rebuilt from the right image at
    ``disp`` ``(B, 1, H, W)``."""
    color = "color_aug" if cfg.loss.match_aug else "color"
    rec = pred_self_images(disp, batch[f"{color}_r"], batch["Rt_r"], batch["K"],
                           batch["inv_K"])
    return shard_mean(reprojection_loss(rec, batch[f"{color}_l"], cfg.loss.use_ssim))


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
    W = source.shape[-1]
    mix = cfg.model.use_mixture_loss
    render = cfg.model.render_probability
    in_dtype = torch.bfloat16 if (cfg.bf16 or cfg.warp_sample_bf16) else None
    logits = outputs["logits"]                                       # (B, N, H, W)
    N = logits.shape[1]
    # the warp's operands on the whole image (row shards: gathered)
    sigma = gather_rows(to_dtype(outputs["sigma"], in_dtype)) if mix else None
    src_in, logits_in = (gather_rows(to_dtype(t, in_dtype)) for t in (source, logits))
    H_img = src_in.shape[-2]
    planes = ({k: outputs[k] for k in ("distance", "norm")}
              if cfg.warp_type == "homography_warp" else
              {k: gather_rows(outputs[k]) for k in ("disp_layered", "padding_mask")})
    mask_novel = outputs.get("mask_novel")                           # (B, 1, H, W)

    zero = torch.zeros((), dtype=source.dtype, device=source.device)
    losses = {"loss/ph_loss": zero, "loss/pc_loss": zero, "loss/total_loss": zero}
    for side in sides:
        target = batch[f"{color}_{side}"]
        dx, dy, pmask = _side_coords(cfg, planes, side, poses, batch["K"],
                                     batch["inv_K"], H_img, W)
        warped = [upcast(own_rows(t))
                  for t in warp2d(src_in, logits_in, sigma, dx, dy, pmask)]
        rgb_l, logit_rec = warped[:2]
        if render:
            # the source view's dists: the stereo pair shares the layered
            # depths (reference trainer.py:584-591)
            pi = render_probability_from_logits(logit_rec[:, :N - 1], outputs["dists"])
        else:
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
            ph = multimodal_nll(err, sigma_rec, pi)[:, 0]            # (B, H, W)
            if cfg.loss.automask:
                err_a = (source - target).abs().mean(1, keepdim=True)   # (B, 1, H, W)
                ph = torch.minimum(ph, multimodal_nll(err_a, sigma_rec.detach(),
                                                      pi.detach())[:, 0])
            if mask_novel is not None:
                ph = ph * mask_novel[:, 0]
        else:
            pred = rgb_rec
            if mask_novel is not None:
                pred = pred * mask_novel + target * (1.0 - mask_novel)
            ph = (pred - target).abs().mean(1)                       # (B, H, W)
            if cfg.loss.automask:
                ph = torch.minimum(ph, (source - target).abs().mean(1))
        ph_loss = shard_mean(ph)
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

        if side == "r" and cfg.loss.alpha_self > 0:
            self_loss = self_reconstruction_loss(cfg, outputs["disp"], batch)
            losses["loss/self_loss"] = self_loss
            total = total + cfg.loss.alpha_self * self_loss

        if cfg.loss.self_distillation > 0 and "disp_pp" in outputs:
            # added once per side, as the reference's side loop does
            disp_loss = shard_mean((outputs["disp"] - outputs["disp_pp"]).abs())
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
