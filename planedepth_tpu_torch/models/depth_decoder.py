"""Plane-probability depth decoder, NCHW (``planedepth_tpu/models/depth_decoder.py``).

U-Net decoder over the 5 encoder features with positional-encoding grid
injection at every scale, optional DenseASPP at the deepest stage, and the
heads ``dispconv`` (plane logits), ``sigmaconv`` (mixture scales) and
``residualconv`` (per-image plane offsets).  The modules sit in one
``decoder`` ModuleList in the reference's insertion order
(``utils/torch_convert.py:convert_depth_decoder``): [epconv] + upconv
(4,0)..(0,1) + [denseaspp] + dispconv + [sigmaconv] + [residualconv], so a
reference ``depth.pth`` loads as it is.  The JAX package's space-to-depth
tail and its merged ``ls`` training head are TPU layout work and have no
counterpart here.

With ``fused_sweep_loss`` in training mode the decoder stops at the plane
heads, as the JAX decoder does (``depth_decoder.py:380-386``): the fused
plane sweep computes ``disp`` from its own centre samples, and nothing reads
the probability volume, whose passes eager PyTorch would not drop.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from planedepth_tpu_torch.config import PlaneConfig
from planedepth_tpu_torch.geometry.camera import disp_to_depth
from planedepth_tpu_torch.geometry.planes import build_plane_volume
from planedepth_tpu_torch.models.denseaspp import DenseAspp
from planedepth_tpu_torch.models.layers import (
    Conv3x3,
    ConvBlock,
    ep_conv,
    frequency_embed,
    inject_grid,
    upsample2x_nearest,
)
from planedepth_tpu_torch.ops.disp_head import disp_head

NUM_CH_DEC = (16, 32, 64, 128, 256)


def mixture_reweight(probability: torch.Tensor, sigma: torch.Tensor,
                     padding_mask: torch.Tensor) -> torch.Tensor:
    """``pi / sigma * mask`` renormalised over the plane axis (dim 1), with
    the JAX package's guarded reciprocal (0 where the sum is <= 1e-7)."""
    w = probability / sigma * padding_mask
    s = w.sum(dim=1, keepdim=True)
    inv = torch.where(s > 1e-7, 1.0 / torch.clamp_min(s, 1e-7), torch.zeros_like(s))
    return w * inv


class DepthDecoder(nn.Module):
    """Primary plane-probability head (reference depth_decoder.py:18-293)."""

    def __init__(self, num_ch_enc: Sequence[int], planes: PlaneConfig = PlaneConfig(),
                 num_ep: int = 8, pe_type: str = "neural",
                 use_denseaspp: bool = True, use_mixture_loss: bool = True,
                 render_probability: bool = False, plane_residual: bool = True,
                 fused_sweep_loss: bool = False):
        super().__init__()
        if render_probability:
            raise NotImplementedError(
                "render_probability is not ported yet (ROADMAP A3)")
        self.planes = planes
        self.num_ep = num_ep
        self.pe_type = pe_type
        self.use_denseaspp = use_denseaspp
        self.use_mixture_loss = use_mixture_loss
        self.plane_residual = plane_residual
        self.fused_sweep_loss = fused_sweep_loss
        n_planes = planes.all_levels
        if num_ep == 0:
            n_pe = 0
        elif pe_type == "neural":
            n_pe = num_ep
        else:                                    # frequency_embed's channels
            n_pe = 2 + 4 * ((num_ep // 2 - 1) // 2)

        # a plain dict (not registered): the ModuleList alone owns the
        # parameters, so the state_dict has only the reference's keys
        self.convs: Dict[str, nn.Module] = {}
        if num_ep > 0 and pe_type == "neural":
            self.convs["epconv"] = ep_conv(num_ep)
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] + n_pe if i == 4 else NUM_CH_DEC[i + 1]
            self.convs[f"upconv_{i}_0"] = ConvBlock(cin, NUM_CH_DEC[i])
            cin = NUM_CH_DEC[i]
            if i > 0:
                cin += num_ch_enc[i - 1] + n_pe        # skip + PE
            self.convs[f"upconv_{i}_1"] = ConvBlock(cin, NUM_CH_DEC[i])
        if use_denseaspp:
            self.convs["denseaspp"] = DenseAspp(NUM_CH_DEC[4])
        self.convs["dispconv"] = Conv3x3(NUM_CH_DEC[0], n_planes)
        if use_mixture_loss:
            self.convs["sigmaconv"] = Conv3x3(NUM_CH_DEC[0], n_planes)
        if plane_residual:
            self.convs["residualconv"] = nn.Sequential(
                nn.Conv2d(NUM_CH_DEC[0], NUM_CH_DEC[0], 1),
                nn.AdaptiveAvgPool2d(1),
                nn.Conv2d(NUM_CH_DEC[0], n_planes, 1))
        self.decoder = nn.ModuleList(self.convs.values())

    def forward(self, input_features: Sequence[torch.Tensor], grid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``grid`` is the ``(B, 2, H, W)`` augmentation grid and ``generator``
        draws DenseASPP's dropout masks in training; every output is
        plane-first: logits, sigma, pi, probability ``(B, N, H, W)``, disp and
        depth ``(B, 1, H, W)``, disp_layered and padding_mask ``(B, N, H, 1)``
        without yz planes (``(B, N, H, W)`` with them), disp_rows ``(B, H, N)``
        without yz planes, distance ``(B, N)``, norm ``(B, N, 3)``."""
        cfg, c = self.planes, self.convs
        grid_ep = None
        if self.num_ep > 0:
            grid_ep = (c["epconv"](grid) if self.pe_type == "neural"
                       else frequency_embed(grid, self.num_ep))

        x = inject_grid(input_features[-1], grid_ep)
        for i in range(4, 0, -1):
            x = upsample2x_nearest(c[f"upconv_{i}_0"](x))
            x = torch.cat([x, input_features[i - 1]], dim=1)
            x = c[f"upconv_{i}_1"](inject_grid(x, grid_ep))
            if i == 4 and self.use_denseaspp:
                x = c["denseaspp"](x, generator)
        x = upsample2x_nearest(c["upconv_0_0"](x))
        x = c["upconv_0_1"](x)

        W = grid.shape[-1]
        residual_levels = None
        if self.plane_residual:
            r = c["residualconv"](x)                              # (B, N, 1, 1)
            residual_levels = torch.sigmoid(r.float())[:, :, 0, 0] - 0.5
        vol = build_plane_volume(grid.float(), cfg, W, residual_levels)
        out = {"disp_layered": vol.disp_layered, "padding_mask": vol.padding_mask,
               "distance": vol.distance, "norm": vol.normal}
        row_constant = cfg.yz_levels == 0
        if row_constant:
            out["disp_rows"] = vol.disp_layered[..., 0].transpose(1, 2).contiguous()

        logits = c["dispconv"](x).float() * vol.padding_mask
        out["logits"] = logits
        if self.use_mixture_loss:
            sigma = torch.clamp(torch.sigmoid(c["sigmaconv"](x).float()), 0.01, 1.0)
            out["sigma"] = sigma
        if self.fused_sweep_loss and self.training:
            return out
        probability = torch.softmax(logits, dim=1)
        if self.use_mixture_loss:
            out["pi"] = probability
            probability = mixture_reweight(probability, sigma, vol.padding_mask)
        out["probability"] = probability

        if self.use_mixture_loss and row_constant:
            mask_rows = vol.padding_mask[..., 0].transpose(1, 2).contiguous()
            out["disp"] = disp_head(logits, sigma, out["disp_rows"], mask_rows)
        else:
            out["disp"] = (probability * vol.disp_layered).sum(dim=1, keepdim=True)
        out["depth"] = disp_to_depth(out["disp"], W)
        return out
