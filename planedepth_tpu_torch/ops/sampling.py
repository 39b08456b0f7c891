"""Bilinear sampling, NCHW (``planedepth_tpu/ops/sampling.py``).

The reference warps every plane with ``F.grid_sample(..., align_corners=True)``,
zero padding on the training path and border padding for the
self-reconstruction (reference trainer.py:573-577, 624-628).  The JAX
package computes these with XLA gathers, outside any Pallas kernel; here they
are plain tensor code: ``F.grid_sample`` for the 2-D samples, whose corner
rules (a corner outside the image weighs 0 under zero padding; border
padding clamps) are the JAX package's, and two gathers along W for the 1-D
stereo shift.  Coordinates are normalised, x then y, -1 at pixel 0 and +1
at pixel W - 1.  The plane axis is dim 1: a shared image ``(B, C, H, W)``
sampled at per-plane grids gives ``(B, N, C, H, W)``.  A bf16 image or map
keeps its samples bf16: the 2-D samples compute in float32 and round once;
the 1-D shift does its index and weight math in float32 and its value math
in the image's dtype (``planedepth_tpu/ops/sampling.py:129-135``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, coords: torch.Tensor,
                padding_mode: str = "zeros") -> torch.Tensor:
    """``image`` ``(B, C, H, W)`` at ``coords`` ``(B, Ho, Wo, 2)`` ->
    ``(B, C, Ho, Wo)``; ``padding_mode`` "zeros" or "border"."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    # a bf16 image is sampled in float32 and rounded once, as the JAX
    # package's grid_sample computes in its promoted dtype
    img = image.float() if image.dtype == torch.bfloat16 else image
    return F.grid_sample(img, coords.to(img.dtype), mode="bilinear",
                         padding_mode=padding_mode, align_corners=True).to(image.dtype)


def grid_sample_planes(image: torch.Tensor, coords: torch.Tensor,
                       padding_mode: str = "zeros") -> torch.Tensor:
    """A shared image ``(B, C, H, W)`` at per-plane grids ``(B, N, Ho, Wo,
    2)`` -> ``(B, N, C, Ho, Wo)``: one sample over the planes' rows stacked,
    without copying the image per plane."""
    B, N, Ho, Wo, _ = coords.shape
    out = grid_sample(image, coords.reshape(B, N * Ho, Wo, 2), padding_mode)
    return out.view(B, -1, N, Ho, Wo).transpose(1, 2)


def grid_sample_per_plane(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Each plane's own maps ``(B, N, C, H, W)`` at its grid ``(B, N, Ho, Wo,
    2)``, zero padding -> ``(B, N, C, Ho, Wo)``."""
    B, N, C, H, W = maps.shape
    Ho, Wo = coords.shape[2:4]
    out = grid_sample(maps.reshape(B * N, C, H, W), coords.reshape(B * N, Ho, Wo, 2))
    return out.view(B, N, C, Ho, Wo)


def _lerp_x(maps: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``maps`` at the positions ``xs`` along its last axis (W), linear
    between the two neighbours, 0 outside [0, W); ``xs`` broadcasts to
    ``maps`` on every axis but the last, where it has the output's width."""
    W = maps.shape[-1]
    x0 = torch.floor(xs)
    w1 = xs - x0
    shape = maps.shape[:-1] + xs.shape[-1:]
    out = 0.0
    for cx, wgt in ((x0, 1.0 - w1), (x0 + 1.0, w1)):
        valid = (cx >= 0) & (cx <= W - 1)
        ix = cx.clamp(0, W - 1).long().expand(shape)
        wgt = torch.where(valid, wgt, torch.zeros_like(wgt)).to(maps.dtype)
        out = out + torch.gather(maps, -1, ix) * wgt
    return out


def _positions(shift: torch.Tensor) -> torch.Tensor:
    W = shift.shape[-1]
    return torch.arange(W, dtype=shift.dtype, device=shift.device) + shift


def shift_sample_x(image: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The stereo ``disp_warp`` sample (reference trainer.py:540-554): a
    shared image ``(B, C, H, W)`` at ``x + shift`` along W, y unchanged,
    ``shift`` ``(B, N, H, W)`` in pixels, zero outside [0, W) ->
    ``(B, N, C, H, W)``."""
    B, C, H, W = image.shape
    N = shift.shape[1]
    return _lerp_x(image[:, None].expand(B, N, C, H, W), _positions(shift)[:, :, None])


def shift_sample_planes(maps: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Each plane's own map ``(B, N, H, W)`` at ``x + shift`` ``(B, N, H,
    W)``, zero outside [0, W), no clip -> ``(B, N, H, W)``."""
    return _lerp_x(maps, _positions(shift))
