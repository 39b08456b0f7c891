"""View synthesis, plane-first (``planedepth_tpu/train/view_synthesis.py``).

``pred_novel_images`` is the oracle view synthesis of the reference's
training step (trainer.py:523-603), which the JAX package trains through
when ``fused_sweep`` is off (its CLI's default) and for every recipe the
fused kernels do not take (``use_mom`` outside the stereo sweep): for each
target side every plane warps the source image, its logit and its sigma;
the warped stack is composited with the warped, renormalised plane
probabilities.  The samples are plain tensor code (``ops/sampling.py``), as
the JAX package's are XLA gathers: the stereo ``disp_warp`` sides shift
along W only, the other sides sample a 2-D grid (the depth warp, the
temporal sides of ``disp_warp``, and the homography with its own mask).

``pred_self_images`` rebuilds the left view from the right image at the
expected disparity (reference trainer.py:605-633, border padding): one
``F.grid_sample`` of a 3-channel image.

Layouts: images ``(B, 3, H, W)``; plane volumes ``(B, N, H, W)``; the
layered reconstruction ``rgb_rec_layered`` ``(B, N, 3, H, W)``.

On row shards (a spatial mesh axis) the stereo shift stays on the shard's
rows (it moves columns only), while a 2-D sample may read any row: the
source image, the logits and sigma are gathered whole
(``parallel/halo.py:gather_rows``, whose backward returns each row's
cotangent to its owner), the coordinates are computed on the whole image
from the gathered plane maps (or, for the homography, from the poses and
planes that every rank holds whole), and each rank samples at its own
rows' coordinates; so does the self-reconstruction, from the gathered
right image and disparity.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from planedepth_tpu_torch.geometry.camera import backproject_depth, disp_to_depth, project_3d
from planedepth_tpu_torch.geometry.warp import (
    depth_warp_coords,
    disp_warp_shift,
    homography_warp_coords,
)
from planedepth_tpu_torch.models.layers import to_dtype, upcast
from planedepth_tpu_torch.models.depth_decoder import (
    mixture_reweight,
    render_probability_from_logits,
)
from planedepth_tpu_torch.ops.sampling import (
    grid_sample,
    grid_sample_per_plane,
    grid_sample_planes,
    shift_sample_planes,
    shift_sample_x,
)
from planedepth_tpu_torch.parallel.halo import gather_rows, global_height, own_rows, shard_rows

Stack = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _sample_plane_stack_shift(rgb: torch.Tensor, logits: torch.Tensor,
                              sigma: Optional[torch.Tensor], shift: torch.Tensor) -> Stack:
    """The ``disp_warp`` sample of the source image ``(B, 3, H, W)`` and of
    each plane's logit and sigma ``(B, N, H, W)`` at ``x + shift`` ``(B, N,
    H, W)``: (rgb ``(B, N, 3, H, W)``, logit, sigma or None)."""
    return (shift_sample_x(rgb, shift), shift_sample_planes(logits, shift),
            None if sigma is None else shift_sample_planes(sigma, shift))


def _sample_plane_stack_coords(rgb: torch.Tensor, logits: torch.Tensor,
                               sigma: Optional[torch.Tensor], coords: torch.Tensor) -> Stack:
    """The 2-D sample of the same at per-plane grids ``(B, N, H, W, 2)``."""
    heads = logits[:, :, None] if sigma is None else torch.stack([logits, sigma], dim=2)
    heads = grid_sample_per_plane(heads, coords)
    return (grid_sample_planes(rgb, coords), heads[:, :, 0],
            None if sigma is None else heads[:, :, 1])


def pred_novel_images(outputs: Dict[str, torch.Tensor], source_rgb: torch.Tensor,
                      target_sides: Sequence, poses: Dict, K: torch.Tensor,
                      inv_K: torch.Tensor, warp_type: str = "disp_warp",
                      use_mixture_loss: bool = True, render_probability: bool = False,
                      rowshift: bool = False, sample_dtype=None) -> Dict:
    """Synthesise every target side from the decoder's ``outputs`` and the
    source (left) image ``(B, 3, H, W)``; ``poses`` maps a side to its
    ``(B, 4, 4)`` relative pose, ``K``, ``inv_K`` ``(B, 4, 4)``.

    Returns ``{(name, side): tensor}``: ``rgb_rec`` ``(B, 3, H, W)``,
    ``rgb_rec_layered`` ``(B, N, 3, H, W)``, ``logit_rec`` and
    ``probability_rec`` ``(B, N, H, W)``, with the mixture ``sigma_rec``
    (clipped to [0.01, 1]) and ``pi_rec`` (the probability before the
    mixture reweight).  ``sample_dtype`` (``warp_sample_bf16``: bf16) samples
    the source image and the plane heads in that dtype: the layered stack
    stays in it, the logits, sigma and the composite are float32 from the
    samples on.  ``rowshift`` (the JAX package's row-constant custom-VJP
    warp, slower there than its gathers) is not ported.
    """
    if rowshift:
        raise NotImplementedError("pred_novel_images: the row-shift warp is left out of the "
                                  "port on purpose (ROADMAP, 'Left out': an opt-in that "
                                  "measured slower than the gathers on the TPU)")
    disp_layered = outputs["disp_layered"]                 # (B, N, H, W_b)
    logits = to_dtype(outputs["logits"], sample_dtype)
    B, N, H, W = logits.shape
    sigma = to_dtype(outputs["sigma"], sample_dtype) if use_mixture_loss else None
    source_rgb = to_dtype(source_rgb, sample_dtype)

    rec: Dict = {}
    rows, whole = shard_rows(H), None          # whole: the 2-D samples' operands
    for side in target_sides:
        if warp_type == "disp_warp" and side in ("l", "r"):
            shift = disp_warp_shift(disp_layered, side).expand(B, N, H, W)
            rgb_l, logit_s, sigma_s = _sample_plane_stack_shift(source_rgb, logits, sigma,
                                                                shift)
            pmask = outputs["padding_mask"]
        else:
            if warp_type == "depth_warp" or warp_type == "disp_warp":
                coords = depth_warp_coords(gather_rows(disp_layered), poses[side], K, inv_K,
                                           W)
                pmask = outputs["padding_mask"]
            elif warp_type == "homography_warp":
                coords, pmask = homography_warp_coords(outputs["distance"], outputs["norm"],
                                                       poses[side], K, inv_K,
                                                       global_height(H), W)
                pmask = own_rows(pmask)
            else:
                raise ValueError(f"unknown warp_type {warp_type}")
            if whole is None:
                whole = (gather_rows(source_rgb), gather_rows(logits),
                         None if sigma is None else gather_rows(sigma))
            rgb_l, logit_s, sigma_s = _sample_plane_stack_coords(*whole, coords[:, :, rows])

        pmask = pmask.to(rgb_l.dtype)
        rgb_layered = rgb_l * pmask[:, :, None]
        logit_rec = upcast(logit_s * pmask)
        if render_probability:
            # the stereo pair shares the layered depths: the source view's
            # dists (reference trainer.py:584-591)
            prob_rec = render_probability_from_logits(logit_rec[:, :N - 1], outputs["dists"])
        else:
            prob_rec = torch.softmax(logit_rec, dim=1)
        out = {"rgb_rec_layered": rgb_layered, "logit_rec": logit_rec}
        if use_mixture_loss:
            sigma_rec = upcast(sigma_s * pmask).clamp(0.01, 1.0)
            out["sigma_rec"] = sigma_rec
            out["pi_rec"] = prob_rec
            prob_rec = mixture_reweight(prob_rec, sigma_rec, 1.0)
        out["probability_rec"] = prob_rec
        # composite: sum_n p_n rgb_n (reference trainer.py:603)
        out["rgb_rec"] = (upcast(rgb_layered) * prob_rec[:, :, None]).sum(1)
        for k, v in out.items():
            rec[(k, side)] = v
    return rec


def pred_self_images(disp: torch.Tensor, target_rgb: torch.Tensor, Rt_r: torch.Tensor,
                     K: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """disp ``(B, 1, H, W)`` expected disparity, target_rgb ``(B, 3, H, W)``
    the right image, ``Rt_r``, ``K``, ``inv_K`` ``(B, 4, 4)`` -> the
    reconstruction of the left view ``(B, 3, H, W)``; on row shards the
    rank's rows of the whole image's."""
    rows = shard_rows(disp.shape[-2])
    disp, target_rgb = gather_rows(disp), gather_rows(target_rgb)
    B, _, H, W = disp.shape
    cam_points = backproject_depth(disp_to_depth(disp[:, 0], W), inv_K)
    coords = project_3d(cam_points, K, Rt_r, H, W)                   # (B, H, W, 2)
    return grid_sample(target_rgb, coords[:, rows], padding_mode="border")
