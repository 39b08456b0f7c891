"""PladeNet: a FalNet-style backbone with the plane head
(``planedepth_tpu/models/plade_net.py``, reference networks/plade_net.py:75-343), NCHW.

Encoder: a full- and a half-resolution stem and six strided conv + residual
stages, with the positional-encoding branch (``conv_ep1``/``conv_ep2`` on the
augmentation grid, bilinearly resized into every stage) when ``num_ep > 0``;
decoder: the deconv/iconv ladder back to full resolution.  The plane head
builds the vertical + ground plane volume of the ResNet decoder (no yz
planes), keeps the logits unmasked, and reweights the mixture WITHOUT the
padding-mask factor (``plade_net.py:224-234``, unlike the ResNet decoder).
Under ``render_probability`` the head has N - 1 density planes, composited
as the ResNet decoder composites them, but unmasked here too (the JAX
module's ``plade_net.py:213-220``).
Module names follow the JAX modules (``backbone.conv_ep1.conv``,
``conv_residual``, ``conv_sigma``), which ``utils/weights.py`` maps from a
JAX ``{"plade": ...}`` tree.  ``dtype`` is the backbone's and heads'
compute dtype (``models/layers.py``); the heads leave it in float32, as the
JAX module's do.  On row shards (a spatial mesh axis, ``H % 64 S == 0``:
six stride-2 stages) the convs and resizes take their rows through
``models/layers.py``, the nearest resizes of ``Deconv`` double the
shard's rows, and the residual head's mean is the image's
(``parallel/halo.py:image_mean``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from planedepth_tpu_torch.config import PlaneConfig
from planedepth_tpu_torch.geometry.camera import disp_to_depth
from planedepth_tpu_torch.geometry.planes import build_plane_volume
from planedepth_tpu_torch.models.depth_decoder import (
    plane_dists,
    render_probability_from_logits,
)
from planedepth_tpu_torch.models.fal_net import subtract_fal_mean
from planedepth_tpu_torch.models.layers import (
    Conv2d,
    ConvELU,
    Deconv,
    ResidualBlock,
    resize_bilinear_align_corners,
    to_dtype,
    upcast,
)
from planedepth_tpu_torch.parallel.halo import image_mean


class PladeBackBone(nn.Module):
    """(reference plade_net.py:75-196); returns the head's input ``dlog`` and
    the full-resolution features the residual and sigma heads read."""

    # (deconv out, iconv out) per level 6..2; deconv1 to 64 channels after
    LADDER = ((128, 256), (128, 256), (128, 256), (128, 256), (128, 128))
    SKIPS = (64, 128, 256, 256, 256, 256)        # out0 .. out5 channels

    def __init__(self, no_out: int, num_ep: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_ep = num_ep
        self.dtype = dtype
        ep, dt = num_ep, dtype
        self.conv0 = ConvELU(3, 64, 3, dtype=dt)
        self.conv0_1 = ResidualBlock(64, dtype=dt)
        if num_ep > 0:
            self.conv_ep1 = ConvELU(2, 16, 1, pad=0, dtype=dt)
            self.conv_ep2 = ConvELU(16, num_ep, 1, pad=0, dtype=dt)
        self.conv1 = ConvELU(64 + ep, 128, stride=2, dtype=dt)
        self.conv1_1 = ResidualBlock(128, dtype=dt)
        self.conv0l = ConvELU(3, 64, 3, dtype=dt)
        self.conv0l_1 = ResidualBlock(64, dtype=dt)
        cin = 128 + 64 + ep
        for i in range(2, 7):
            self.add_module(f"conv{i}", ConvELU(cin, 256, stride=2, dtype=dt))
            self.add_module(f"conv{i}_1", ResidualBlock(256, dtype=dt))
            cin = 256 + ep
        cin = 256
        for level, (dch, ich) in zip(range(6, 1, -1), self.LADDER):
            self.add_module(f"deconv{level}", Deconv(cin, dch, dt))
            self.add_module(f"iconv{level}", ConvELU(dch + self.SKIPS[level - 1], ich,
                                                     dtype=dt))
            cin = ich
        self.deconv1 = Deconv(cin, 64, dt)
        self.iconv1 = Conv2d(64 + 64, no_out, 3, padding=1, bias=False, dtype=dt)

    def forward(self, x: torch.Tensor, grid: torch.Tensor):
        x = to_dtype(x, self.dtype)
        g = None
        if self.num_ep > 0:
            g = self.conv_ep2(self.conv_ep1(grid))

        def with_pe(*parts):
            ref = parts[0]
            if g is not None:
                parts = parts + (resize_bilinear_align_corners(g, ref.shape[-2:]),)
            return torch.cat(parts, 1) if len(parts) > 1 else ref

        out0 = self.conv0_1(self.conv0(x))
        # the first stride-2 stage takes the grid feature at full resolution
        out1 = self.conv1_1(self.conv1(out0 if g is None else torch.cat([out0, g], 1)))
        half = resize_bilinear_align_corners(x, out1.shape[-2:])
        out0l = self.conv0l_1(self.conv0l(half))
        outs = [out0, out1, self.conv2_1(self.conv2(with_pe(out1, out0l)))]
        for i in range(3, 7):
            outs.append(getattr(self, f"conv{i}_1")(getattr(self, f"conv{i}")(
                with_pe(outs[-1]))))

        h = outs[6]
        for level in range(6, 1, -1):
            skip = outs[level - 1]
            h = getattr(self, f"deconv{level}")(h, skip.shape[-2:])
            h = getattr(self, f"iconv{level}")(torch.cat([h, skip], 1))
        features = torch.cat([self.deconv1(h, out0.shape[-2:]), out0], 1)
        return self.iconv1(features), features


class PladeNet(nn.Module):
    """(reference plade_net.py:199-343).  yz side planes are not built (the
    JAX module asserts ``yz_levels == 0``)."""

    def __init__(self, planes: PlaneConfig, num_ep: int = 8, use_mixture_loss: bool = False,
                 render_probability: bool = False, plane_residual: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if planes.yz_levels > 0:
            raise NotImplementedError(
                "PladeNet with yz side planes is left out on purpose: the JAX module "
                "asserts yz_levels == 0 (planedepth_tpu/models/plade_net.py:173)")
        n = planes.disp_levels + planes.xz_levels
        no_out = n - 1 if render_probability else n
        self.planes = planes
        self.use_mixture_loss = use_mixture_loss
        self.render_probability = render_probability
        self.backbone = PladeBackBone(no_out, num_ep, dtype)
        self.conv0 = Conv2d(no_out, no_out, 1, dtype=dtype)
        self.conv_residual = (Conv2d(128, n, 3, padding=1, bias=False, dtype=dtype)
                              if plane_residual else None)
        self.conv_sigma = (Conv2d(128, n, 3, padding=1, bias=False, dtype=dtype)
                           if use_mixture_loss else None)

    def forward(self, image: torch.Tensor, grid: torch.Tensor) -> Dict[str, torch.Tensor]:
        dlog, features = self.backbone(subtract_fal_mean(image), grid)
        H, W = dlog.shape[-2:]
        residual_levels: Optional[torch.Tensor] = None
        if self.conv_residual is not None:
            # per image: the mean of the full-resolution residual map
            residual_levels = torch.sigmoid(
                image_mean(upcast(self.conv_residual(features)))) - 0.5
        vol = build_plane_volume(grid, self.planes, W, residual_levels)
        logits = upcast(self.conv0(dlog))                 # not masked
        out = {"disp_layered": vol.disp_layered, "padding_mask": vol.padding_mask,
               "distance": vol.distance, "norm": vol.normal,
               "disp_rows": vol.disp_layered[..., 0].transpose(1, 2).contiguous()}
        if self.render_probability:
            out["dists"] = plane_dists(vol.disp_layered, W, H)
            probability = render_probability_from_logits(logits, out["dists"])
            logits = torch.cat([logits, torch.ones_like(logits[:, :1])], dim=1)
        else:
            probability = torch.softmax(logits, dim=1)
        out["logits"] = logits
        if self.conv_sigma is not None:
            sigma = torch.clamp(torch.sigmoid(upcast(self.conv_sigma(features))), 0.01, 1.0)
            out["sigma"], out["pi"] = sigma, probability
            w = probability / sigma
            probability = w / w.sum(dim=1, keepdim=True)  # no padding-mask factor
        out["probability"] = probability
        out["disp"] = (probability * vol.disp_layered).sum(dim=1, keepdim=True)
        out["depth"] = disp_to_depth(out["disp"], W)
        return out
