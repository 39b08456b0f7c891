"""Self-distillation teacher pass and mirror occlusion masks (``planedepth_tpu/train/distill.py``).

``generate_post_process_disp`` (reference trainer.py:404-466): the frozen
teacher runs on ``[x, flip(x)]``; occlusion coverages from the cross-warped
plane volumes blend the two disparities into ``disp_pp``, the distillation
target, and the warped probability volume gives ``mask_novel``.

``mirror_occlusion_mask`` (reference trainer.py:636-669, with the JAX
package's repair of its undefined warp grids) and ``fused_mom_mask_novel``:
``mask_novel`` under ``use_mom`` from the student's plane heads on the fused
path.

Every warp is a per-plane horizontal shift by a row-constant disparity, so
each goes through :func:`ops.row_shift.row_shift` (the CUDA kernel on the
card, its plain twin on the CPU).  Tensors are NCHW and plane-first: maps
``(B, N, H, W)``, row shifts ``(B, H, N)`` (the decoder's ``disp_rows``).
Nothing here carries a gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from planedepth_tpu_torch.models.depth_decoder import mixture_reweight
from planedepth_tpu_torch.ops.row_shift import row_shift
from planedepth_tpu_torch.train.flip import flip_grid, flip_w


def _coverage(maps: torch.Tensor, shift: torch.Tensor, pad: int) -> torch.Tensor:
    """Plane sum of the shifted maps ``(B, 1, H, W)``."""
    return row_shift(maps, shift, pad).sum(1, keepdim=True)


@torch.no_grad()
def generate_post_process_disp(teacher: Callable, color_aug_l: torch.Tensor,
                               grid: torch.Tensor, pad: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher post-processed disparity (reference trainer.py:404-466).

    ``teacher(image, grid)`` is the frozen eval-mode forward; ``color_aug_l``
    ``(B, 3, H, W)``, ``grid`` ``(B, 2, H, W)``.  Returns ``(disp_pp,
    mask_novel)``, both ``(B, 1, H, W)``.
    """
    images = torch.cat([color_aug_l, flip_w(color_aug_l)])
    grids = torch.cat([grid, flip_grid(grid)])
    out = teacher(images, grids)
    prob, rows, logits, disp = (out[k] for k in
                                ("probability", "disp_rows", "logits", "disp"))
    B = prob.shape[0] // 2
    shift_r = rows[:B]                     # sample at x + d (to the right view)
    shift_l = -rows[B:]                    # sample at x - d of the flipped half

    # o_l: left-view occlusion coverage (trainer.py:443-449)
    plr = torch.softmax(row_shift(logits[:B], shift_r, pad), dim=1)
    o_l = _coverage(plr, shift_l, pad).clamp(max=1.0)
    # o_fr: flipped-right coverage (trainer.py:451-456)
    pfrl = torch.softmax(row_shift(flip_w(logits[B:]), shift_l, pad), dim=1)
    o_fr = _coverage(pfrl, shift_r, pad).clamp(max=1.0)

    disp_fl = flip_w(disp[B:])
    disp_pp = (disp[:B] * 0.5 + disp_fl * 0.5) * o_fr + disp[:B] * (1.0 - o_fr)
    disp_pp = disp_pp * o_l + disp_fl * (1.0 - o_l)
    mask_novel = _coverage(prob[:B], shift_r, pad).clamp(max=1.0)
    return disp_pp, mask_novel


@torch.no_grad()
def mirror_occlusion_mask(probability: torch.Tensor, prob_rec: torch.Tensor,
                          disp_rows: torch.Tensor, pad: int) -> torch.Tensor:
    """Mirror occlusion mask of a flip-doubled batch (reference
    trainer.py:636-669): ``probability`` and ``prob_rec`` (the right-view
    volume) ``(2B, N, H, W)``, ``disp_rows`` ``(2B, H, N)``.  Returns
    ``mask_novel`` ``(2B, 1, H, W)``."""
    B = probability.shape[0] // 2
    shift_r, shift_l = disp_rows[:B], -disp_rows[:B]
    o_r = (_coverage(probability[:B], shift_r, pad)
           * _coverage(flip_w(prob_rec[B:]), shift_r, pad)).clamp(max=1.0)
    o_l = (_coverage(flip_w(probability[B:]), shift_l, pad)
           * _coverage(prob_rec[:B], shift_l, pad)).clamp(max=1.0)
    return torch.cat([o_r, flip_w(o_l)])


@torch.no_grad()
def fused_mom_mask_novel(outputs: Dict[str, torch.Tensor], use_mixture_loss: bool,
                         pad: int) -> torch.Tensor:
    """``mask_novel`` under ``use_mom`` on the fused path (the JAX package's
    non-s2d branch).

    The fused sweep never builds the ``probability`` and ``probability_rec``
    volumes that the mirror occlusion mask reads, so both are rebuilt here
    from the plane heads: the source-view probability as the decoder's
    non-fused head builds it, the right-view one as the view synthesis does
    (warp by +disparity, mask, softmax, mixture reweight without the mask).
    """
    rows = outputs["disp_rows"].detach()
    pmask = outputs["padding_mask"].detach()                  # (2B, N, H, 1)
    logits = outputs["logits"].detach().float()
    sigma = outputs.get("sigma") if use_mixture_loss else None

    probability = torch.softmax(logits, dim=1)
    pi_rec = torch.softmax(row_shift(logits, rows, pad) * pmask, dim=1)
    if sigma is None:
        prob_rec = pi_rec
    else:
        sigma = sigma.detach().float()
        probability = mixture_reweight(probability, sigma, pmask)
        sigma_rec = (row_shift(sigma, rows, pad) * pmask).clamp(0.01, 1.0)
        prob_rec = mixture_reweight(pi_rec, sigma_rec, 1.0)
    return mirror_occlusion_mask(probability, prob_rec, rows, pad)
