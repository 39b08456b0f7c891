"""Network building blocks, NCHW (``planedepth_tpu/models/layers.py`` and ``ops/resize.py``).

The ResNet decoder's blocks name their modules after the reference torch
code, so a reference ``state_dict`` loads as it is: ``Conv3x3.conv``,
``ConvBlock.conv.conv``.  The PladeNet/FalNet blocks (``ConvELU``,
``ResidualBlock``, ``Deconv``) name theirs after the JAX modules
(``conv``, ``conv1``, ``conv2``), the names ``utils/weights.py`` maps.
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


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest resize to ``size=(Ho, Wo)``: source index ``floor(dst * in /
    out)`` on each axis, torch's ``mode="nearest"`` rule, at any ratio (a
    stride-2 stage maps 5 columns to 3, its deconv 3 back to 5)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")


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


class ConvELU(nn.Module):
    """Conv with bias, then ELU: the PladeNet/FalNet stage conv (reference
    plade_net.py:33-46).  ``ModelConfig`` never turns its BatchNorm on, and
    the port does not build one."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 pad: int = 1, batch_norm: bool = False):
        super().__init__()
        if batch_norm:
            raise NotImplementedError("ConvELU with BatchNorm: no ModelConfig builds it")
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=pad)

    def forward(self, x):
        return F.elu(self.conv(x))


class ResidualBlock(nn.Module):
    """Two bias-free 3x3 convs, ``elu(conv2(elu(conv1(x))) + x)`` (reference
    plade_net.py:61-72)."""

    def __init__(self, ch: int, kernel_size: int = 3):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.conv1 = nn.Conv2d(ch, ch, kernel_size, padding=p, bias=False)
        self.conv2 = nn.Conv2d(ch, ch, kernel_size, padding=p, bias=False)

    def forward(self, x):
        return F.elu(self.conv2(F.elu(self.conv1(x))) + x)


class Deconv(nn.Module):
    """Nearest resize to a reference size, a bias-free 3x3 conv, ELU
    (reference plade_net.py:49-58)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)

    def forward(self, x, size: Sequence[int]):
        return F.elu(self.conv1(resize_nearest(x, size)))
