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
counterpart here; the epilogue of the plane heads (the padding mask on the
logits, the sigma clip) runs in ``ops/head_epilogue.py``, the port of the
arithmetic of the TPU's relayout kernels.

With ``fused_sweep_loss`` in training mode the decoder stops at the plane
heads, as the JAX decoder does (``depth_decoder.py:380-386``): the fused
plane sweep computes ``disp`` from its own centre samples.  In other
training (the 2-D warp and mixed recipes) ``disp`` comes from the disp head
with its backward, and ``pi`` and the probability volume are not built: no
training loss reads them, and eager PyTorch, unlike XLA, would keep them
alive through the backward.

Under ``render_probability`` (reference depth_decoder.py:261-273) the
``dispconv`` head has N - 1 density planes, masked by the first N - 1 planes
of the padding mask in the head epilogue; the probability is the NeRF alpha
compositing of those densities over the plane distances along each ray
(``plane_dists``), in training too (``disp`` is its expectation: the disp
head's softmax is not this mode's probability), and a plane of ones is
appended to the logits for the warps that read them.

``dtype`` is the compute dtype of ``models/layers.py``, with the JAX
decoder's float32 points: the residual sigmoid, the plane volume, the
softmax and the sigma epilogue are float32.  The plane heads leave float32
(``head_epilogue`` runs on the upcast raw heads) unless the decoder trains
for the fused sweep in bf16: then they are rounded back to
``dtype``, the sweep's bf16 operands (the JAX decoder's ``head_f32`` rule,
``depth_decoder.py:284-286``; eval, validation, the teacher and the 2-D
warp recipes keep float32 heads).  Where the JAX v1 route does the
epilogue's own arithmetic in bf16, the port rounds its float32 result once.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from planedepth_tpu_torch.config import PlaneConfig
from planedepth_tpu_torch.geometry.camera import create_camera_plane, disp_to_depth
from planedepth_tpu_torch.geometry.planes import build_plane_volume
from planedepth_tpu_torch.models.denseaspp import DenseAspp
from planedepth_tpu_torch.models.layers import (
    Conv2d,
    Conv3x3,
    ConvBlock,
    GlobalAvgPool2d,
    ep_conv,
    frequency_embed,
    inject_grid,
    to_dtype,
    upcast,
    upsample2x_nearest,
)
from planedepth_tpu_torch.ops.disp_head import disp_head
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue
from planedepth_tpu_torch.parallel.halo import global_height, shard_rows

NUM_CH_DEC = (16, 32, 64, 128, 256)


def render_probability_from_logits(logits: torch.Tensor, dists: torch.Tensor
                                   ) -> torch.Tensor:
    """NeRF alpha compositing over the plane axis (dim 1): ``alpha = 1 -
    exp(-relu(logit) * dist)`` for the first N - 1 planes, alpha 1 for the
    last, the transmittance a cumulative product with the reference's
    +1e-10 guard.  logits, dists ``(B, N - 1, H, W)`` -> probability ``(B, N,
    H, W)``."""
    alpha = 1.0 - torch.exp(-torch.relu(logits) * dists)
    ones = torch.ones_like(alpha[:, :1])
    alpha = torch.cat([alpha, ones], dim=1)
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-10], dim=1), dim=1)[:, :-1]
    return alpha * trans


def plane_dists(disp_layered: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Adjacent-plane metric distances along each pixel's camera ray
    (reference depth_decoder.py:262-267): successive depth differences
    scaled by ``|K^-1 [x, y, 1]|``.  disp_layered ``(B, N, H, W_b)`` ->
    ``(B, N - 1, H, W)``.  On row shards ``height`` is the shard's: the rays
    are the image's (K at its height) at the shard's global rows."""
    depth = disp_to_depth(disp_layered, width)
    d = depth[:, 1:] - depth[:, :-1]
    rays = create_camera_plane(global_height(height), width, d.dtype,
                               d.device)[shard_rows(height)]
    return d * torch.sqrt((rays * rays).sum(-1))


def mixture_reweight(probability: torch.Tensor, sigma: torch.Tensor,
                     padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``pi / sigma`` (times the mask, where one is given) renormalised over
    the plane axis (dim 1), with the JAX package's guarded reciprocal (0
    where the sum is <= 1e-7)."""
    w = probability / sigma
    if padding_mask is not None:
        w = w * padding_mask
    s = w.sum(dim=1, keepdim=True)
    inv = torch.where(s > 1e-7, 1.0 / torch.clamp_min(s, 1e-7), torch.zeros_like(s))
    return w * inv


class _PlaneLadder(nn.Module):
    """The U-Net ladder that ``DepthDecoder`` and ``DepthDecoderContinuous``
    share (reference depth_decoder.py:18-293 and :296-453): the positional
    encoding of the grid (``epconv``, or the frequency embedding), the
    upconv pairs (4, 0) .. (0, 1) with the encoder's skips and the encoding
    injected at every scale but the finest, and DenseASPP after (4, 1).
    Its modules sit in the plain dict ``convs`` under the reference's
    names; a subclass adds its heads there and then lists every module in
    the ``decoder`` ModuleList, whose indices are the state_dict's keys."""

    def __init__(self, num_ch_enc: Sequence[int], num_ep: int, pe_type: str,
                 use_denseaspp: bool, use_skips: bool, dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype
        self.num_ep = num_ep
        self.pe_type = pe_type
        self.use_denseaspp = use_denseaspp
        self.use_skips = use_skips
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
            self.convs["epconv"] = ep_conv(num_ep, dtype)
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] + n_pe if i == 4 else NUM_CH_DEC[i + 1]
            self.convs[f"upconv_{i}_0"] = ConvBlock(cin, NUM_CH_DEC[i], dtype)
            cin = NUM_CH_DEC[i]
            if i > 0:
                cin += (num_ch_enc[i - 1] if use_skips else 0) + n_pe   # skip + PE
            self.convs[f"upconv_{i}_1"] = ConvBlock(cin, NUM_CH_DEC[i], dtype)
        if use_denseaspp:
            self.convs["denseaspp"] = DenseAspp(NUM_CH_DEC[4], dtype=dtype)

    def ladder(self, input_features: Sequence[torch.Tensor], grid: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        """The finest ``(B, 16, H, W)`` features; ``generator`` draws
        DenseASPP's dropout masks in training."""
        c, dt = self.convs, self.dtype
        grid_ep = None
        if self.num_ep > 0:
            grid_ep = (c["epconv"](grid) if self.pe_type == "neural"
                       else to_dtype(frequency_embed(grid, self.num_ep), dt))

        x = inject_grid(to_dtype(input_features[-1], dt), grid_ep)
        for i in range(4, 0, -1):
            x = upsample2x_nearest(c[f"upconv_{i}_0"](x))
            if self.use_skips:
                x = torch.cat([x, to_dtype(input_features[i - 1], dt)], dim=1)
            x = c[f"upconv_{i}_1"](inject_grid(x, grid_ep))
            if i == 4 and self.use_denseaspp:
                x = c["denseaspp"](x, generator)
        x = upsample2x_nearest(c["upconv_0_0"](x))
        return c["upconv_0_1"](x)


class DepthDecoder(_PlaneLadder):
    """Primary plane-probability head (reference depth_decoder.py:18-293)."""

    def __init__(self, num_ch_enc: Sequence[int], planes: PlaneConfig = PlaneConfig(),
                 num_ep: int = 8, pe_type: str = "neural",
                 use_denseaspp: bool = True, use_mixture_loss: bool = True,
                 render_probability: bool = False, plane_residual: bool = True,
                 fused_sweep_loss: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_ch_enc, num_ep, pe_type, use_denseaspp, True, dtype)
        self.planes = planes
        self.use_mixture_loss = use_mixture_loss
        self.render_probability = render_probability
        self.plane_residual = plane_residual
        self.fused_sweep_loss = fused_sweep_loss
        n_planes = planes.all_levels
        self.convs["dispconv"] = Conv3x3(NUM_CH_DEC[0],
                                         n_planes - 1 if render_probability else n_planes,
                                         dtype)
        if use_mixture_loss:
            self.convs["sigmaconv"] = Conv3x3(NUM_CH_DEC[0], n_planes, dtype)
        if plane_residual:
            self.convs["residualconv"] = nn.Sequential(
                Conv2d(NUM_CH_DEC[0], NUM_CH_DEC[0], 1, dtype=dtype),
                GlobalAvgPool2d(),
                Conv2d(NUM_CH_DEC[0], n_planes, 1, dtype=dtype))
        self.decoder = nn.ModuleList(self.convs.values())

    def forward(self, input_features: Sequence[torch.Tensor], grid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``grid`` is the ``(B, 2, H, W)`` augmentation grid and ``generator``
        draws DenseASPP's dropout masks in training; every output is
        plane-first: logits, sigma, pi, probability ``(B, N, H, W)``, disp and
        depth ``(B, 1, H, W)``, disp_layered and padding_mask ``(B, N, H, 1)``
        without yz planes (``(B, N, H, W)`` with them), disp_rows ``(B, H, N)``
        without yz planes, distance ``(B, N)``, norm ``(B, N, 3)``, and under
        ``render_probability`` dists ``(B, N - 1, H, W)``."""
        cfg, c, dt = self.planes, self.convs, self.dtype
        x = self.ladder(input_features, grid, generator)

        H, W = grid.shape[-2:]
        residual_levels = None
        if self.plane_residual:
            r = c["residualconv"](x)                              # (B, N, 1, 1)
            residual_levels = torch.sigmoid(upcast(r))[:, :, 0, 0] - 0.5
        vol = build_plane_volume(grid, cfg, W, residual_levels)
        out = {"disp_layered": vol.disp_layered, "padding_mask": vol.padding_mask,
               "distance": vol.distance, "norm": vol.normal}
        row_constant = cfg.yz_levels == 0
        if row_constant:
            out["disp_rows"] = vol.disp_layered[..., 0].transpose(1, 2).contiguous()

        logits, sigma = head_epilogue(
            upcast(c["dispconv"](x)),
            upcast(c["sigmaconv"](x)) if self.use_mixture_loss else None,
            vol.padding_mask)
        if dt is not None and self.fused_sweep_loss and self.training:
            # the fused sweep's bf16 operands (the JAX decoder's head_f32 rule)
            logits = logits.to(dt)
            sigma = None if sigma is None else sigma.to(dt)
        probability = None
        if self.render_probability:
            out["dists"] = plane_dists(vol.disp_layered, W, H)
            probability = render_probability_from_logits(logits, out["dists"])
            logits = torch.cat([logits, torch.ones_like(logits[:, :1])], dim=1)
        out["logits"] = logits
        if self.use_mixture_loss:
            out["sigma"] = sigma
        if self.fused_sweep_loss and self.training:
            return out
        use_head = self.use_mixture_loss and row_constant and not self.render_probability
        if not (use_head and self.training):
            # without render_probability no training loss reads pi or the
            # probability volume under the disp head
            if probability is None:
                probability = torch.softmax(logits, dim=1)
            if self.use_mixture_loss:
                out["pi"] = probability
                probability = mixture_reweight(probability, sigma, vol.padding_mask)
            out["probability"] = probability

        if use_head:
            mask_rows = vol.padding_mask[..., 0].transpose(1, 2).contiguous()
            out["disp"] = disp_head(logits, sigma, out["disp_rows"], mask_rows)
        else:
            out["disp"] = (probability * vol.disp_layered).sum(dim=1, keepdim=True)
        out["depth"] = disp_to_depth(out["disp"], W)
        return out


class DepthDecoderContinuous(_PlaneLadder):
    """Continuous-disparity variant (reference depth_decoder.py:296-453, JAX
    ``depth_decoder.py:DepthDecoderContinuous``), kept for API parity: the
    reference trainer never builds it.

    No plane volume: ``dispconv`` gives each pixel its own sigmoid levels,
    ``disp_layered = disp_max * (disp_min / disp_max) ** levels`` over the
    ``disp_levels + xz_levels`` planes of ``planes``; ``piconv`` gives the
    plane logits (N - 1 densities composited over the per-pixel
    ``plane_dists`` under ``render_probability``); with the mixture,
    ``sigmaconv``'s clipped sigmoid reweights the probability with no
    padding mask; disp is the probability-weighted sum of ``disp_layered``.
    The disparities vary along a row, so the row-constant disp-head kernel
    does not apply: the class runs no kernel, as the JAX module runs none.

    Names: the ladder it shares with :class:`DepthDecoder` takes
    ``DepthDecoder``'s (the ``decoder`` ModuleList, ``convs`` keys
    ``epconv``, ``upconv_{i}_{j}``, ``denseaspp``); the heads follow in the
    ``decoder`` list as ``dispconv``, ``piconv``, ``sigmaconv``, the JAX
    module names (``utils/weights.py:load_jax_continuous_params``).
    ``dtype`` is the compute dtype; the heads leave it in float32, as the
    JAX module's do.
    """

    def __init__(self, num_ch_enc: Sequence[int],
                 planes: PlaneConfig = PlaneConfig(xz_levels=0, yz_levels=0),
                 num_ep: int = 8, pe_type: str = "neural", use_skips: bool = True,
                 use_denseaspp: bool = True, use_mixture_loss: bool = True,
                 render_probability: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(num_ch_enc, num_ep, pe_type, use_denseaspp, use_skips, dtype)
        self.planes = planes
        self.use_mixture_loss = use_mixture_loss
        self.render_probability = render_probability
        n_levels = planes.disp_levels + planes.xz_levels
        self.convs["dispconv"] = Conv3x3(NUM_CH_DEC[0], n_levels, dtype)
        self.convs["piconv"] = Conv3x3(NUM_CH_DEC[0],
                                       n_levels - 1 if render_probability else n_levels, dtype)
        if use_mixture_loss:
            self.convs["sigmaconv"] = Conv3x3(NUM_CH_DEC[0], n_levels, dtype)
        self.decoder = nn.ModuleList(self.convs.values())

    def forward(self, input_features: Sequence[torch.Tensor], grid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """As :meth:`DepthDecoder.forward`; every output is plane-first:
        disp_levels, disp_layered, logits, sigma, pi, probability ``(B, N,
        H, W)``, disp and depth ``(B, 1, H, W)``, and under
        ``render_probability`` dists ``(B, N - 1, H, W)``."""
        cfg, c = self.planes, self.convs
        x = self.ladder(input_features, grid, generator)
        H, W = x.shape[-2:]
        out = {}
        levels = torch.sigmoid(upcast(c["dispconv"](x)))
        out["disp_levels"] = levels
        disp_layered = cfg.disp_max * (cfg.disp_min / cfg.disp_max) ** levels
        out["disp_layered"] = disp_layered
        logits = upcast(c["piconv"](x))
        if self.render_probability:
            out["dists"] = plane_dists(disp_layered, W, H)
            probability = render_probability_from_logits(logits, out["dists"])
            logits = torch.cat([logits, torch.ones_like(logits[:, :1])], dim=1)
        else:
            probability = torch.softmax(logits, dim=1)
        out["logits"] = logits
        if self.use_mixture_loss:
            sigma = torch.clamp(torch.sigmoid(upcast(c["sigmaconv"](x))), 0.01, 1.0)
            out["sigma"] = sigma
            out["pi"] = probability
            probability = mixture_reweight(probability, sigma)
        out["probability"] = probability
        out["disp"] = (probability * disp_layered).sum(dim=1, keepdim=True)
        out["depth"] = disp_to_depth(out["disp"], W)
        return out
