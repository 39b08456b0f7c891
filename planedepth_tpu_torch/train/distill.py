"""Self-distillation teacher pass and mirror occlusion masks (``planedepth_tpu/train/distill.py``).

``generate_post_process_disp`` (reference trainer.py:404-466): the frozen
teacher runs on ``[x, flip(x)]``; occlusion coverages from the cross-warped
plane volumes blend the two disparities into ``disp_pp``, the distillation
target, and the warped probability volume gives ``mask_novel``.

``mirror_occlusion_mask`` (reference trainer.py:636-669, with the JAX
package's repair of its undefined warp grids): ``mask_novel`` under
``use_mom``, from the oracle view synthesis's right-view probability or,
on the fused path (``fused_mom_mask_novel``), from the student's plane
heads.

Every warp is a per-plane horizontal shift.  With a row-constant disparity
each goes through :func:`ops.row_shift.row_shift` (the CUDA kernel on the
card, its plain twin on the CPU); with yz side planes, whose disparity
varies along the row, the teacher's shifts are the per-pixel linear
interpolation the JAX package runs in XLA there (``ops/sampling.py:
shift_sample_x``, zero padding, no clip), plain tensor code here too
(``ops/sampling.py:shift_sample_planes``).
Tensors are NCHW and plane-first: maps ``(B, N, H, W)``, row shifts ``(B,
H, N)`` (the decoder's ``disp_rows``), per-pixel shifts ``(B, N, H, W)``.
Nothing here carries a gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from planedepth_tpu_torch.models.depth_decoder import mixture_reweight
from planedepth_tpu_torch.models.layers import upcast
from planedepth_tpu_torch.ops.row_shift import row_shift
from planedepth_tpu_torch.ops.sampling import shift_sample_planes
from planedepth_tpu_torch.train.flip import flip_grid, flip_w


def _shift(maps: torch.Tensor, shift: torch.Tensor, pad: int) -> torch.Tensor:
    """``row_shift`` for row shifts ``(B, H, N)``, else
    :func:`ops.sampling.shift_sample_planes`."""
    if shift.shape == maps.shape:
        return shift_sample_planes(maps, shift)
    return row_shift(maps, shift, pad)


def _coverage(maps: torch.Tensor, shift: torch.Tensor, pad: int) -> torch.Tensor:
    """Plane sum of the shifted maps ``(B, 1, H, W)``."""
    return _shift(maps, shift, pad).sum(1, keepdim=True)


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
    prob, logits, disp = (out[k] for k in ("probability", "logits", "disp"))
    # row shifts without yz planes; else the full volume, whose flipped half
    # shifts the flipped logits unflipped, as the JAX package does
    shifts = out["disp_rows"] if "disp_rows" in out else out["disp_layered"]
    B = prob.shape[0] // 2
    shift_r = shifts[:B]                   # sample at x + d (to the right view)
    shift_l = -shifts[B:]                  # sample at x - d of the flipped half

    # o_l: left-view occlusion coverage (trainer.py:443-449)
    plr = torch.softmax(_shift(logits[:B], shift_r, pad), dim=1)
    o_l = _coverage(plr, shift_l, pad).clamp(max=1.0)
    # o_fr: flipped-right coverage (trainer.py:451-456)
    pfrl = torch.softmax(_shift(flip_w(logits[B:]), shift_l, pad), dim=1)
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
def head_probability(outputs: Dict[str, torch.Tensor],
                     use_mixture_loss: bool) -> torch.Tensor:
    """The source-view probability volume ``(B, N, H, W)`` as the ResNet
    decoder's non-fused head builds it from the plane heads: softmax, then
    with the mixture the reweight by sigma and the padding mask (the decoder
    itself skips it in training under the disp head)."""
    probability = torch.softmax(upcast(outputs["logits"].detach()), dim=1)
    if not use_mixture_loss:
        return probability
    return mixture_reweight(probability, upcast(outputs["sigma"].detach()),
                            outputs["padding_mask"].detach())


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
    bf16 heads (fused bf16 training) are upcast first, as the JAX package's
    are (``distill.py:211-217``): the row shift takes float32 maps.
    """
    rows = outputs["disp_rows"].detach()
    pmask = outputs["padding_mask"].detach()                  # (2B, N, H, 1)
    logits = upcast(outputs["logits"].detach())
    pi_rec = torch.softmax(row_shift(logits, rows, pad) * pmask, dim=1)
    prob_rec = pi_rec
    if use_mixture_loss:
        sigma = upcast(outputs["sigma"].detach())
        sigma_rec = (row_shift(sigma, rows, pad) * pmask).clamp(0.01, 1.0)
        prob_rec = mixture_reweight(pi_rec, sigma_rec, 1.0)
    return mirror_occlusion_mask(head_probability(outputs, use_mixture_loss), prob_rec,
                                 rows, pad)
