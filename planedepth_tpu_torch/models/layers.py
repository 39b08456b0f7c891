"""Decoder building blocks, NCHW (``planedepth_tpu/models/layers.py`` and ``ops/resize.py``).

Module attribute names follow the reference torch code, so a reference
``state_dict`` loads as it is: ``Conv3x3.conv``, ``ConvBlock.conv.conv``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample, ``(B, C, H, W) -> (B, C, 2H, 2W)``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear_align_corners(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize to ``size=(Ho, Wo)`` with ``align_corners=True``."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


class Conv3x3(nn.Module):
    """Reflection pad, then a VALID 3x3 conv (reference layers.py:110-125)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (reference layers.py:95-107)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv3x3(in_ch, out_ch)

    def forward(self, x):
        return F.elu(self.conv(x))


def ep_conv(num_ep: int) -> nn.Sequential:
    """Neural positional encoding: 1x1 2->16 ELU -> 1x1 16->num_ep ELU
    (reference depth_decoder.py:66-71; parameters at ``0.*`` and ``2.*``)."""
    return nn.Sequential(nn.Conv2d(2, 16, 1), nn.ELU(),
                         nn.Conv2d(16, num_ep, 1), nn.ELU())


def frequency_embed(grid: torch.Tensor, num_ep: int) -> torch.Tensor:
    """NeRF-style frequency embedding of the 2-channel ``(B, 2, H, W)`` grid:
    ``[grid, sin/cos(grid * 2^k) for k < (num_ep//2 - 1)//2]`` on channels."""
    multires = (num_ep // 2 - 1) // 2
    outs = [grid]
    for k in range(multires):
        freq = 2.0 ** k
        outs.append(torch.sin(grid * freq))
        outs.append(torch.cos(grid * freq))
    return torch.cat(outs, dim=1)


def inject_grid(x: torch.Tensor, grid_ep: Optional[torch.Tensor]) -> torch.Tensor:
    """Resize the positional-encoding feature to x's size and concatenate it
    on channels (reference depth_decoder.py:128-139)."""
    if grid_ep is None:
        return x
    g = resize_bilinear_align_corners(grid_ep, x.shape[-2:])
    return torch.cat([x, g.to(x.dtype)], dim=1)
