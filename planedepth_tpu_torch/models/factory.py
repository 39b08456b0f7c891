"""Model factory (``planedepth_tpu/models/factory.py``): config -> ``DepthModel``."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from planedepth_tpu_torch.config import ModelConfig
from planedepth_tpu_torch.models.depth_decoder import DepthDecoder
from planedepth_tpu_torch.models.fal_net import FalNet
from planedepth_tpu_torch.models.plade_net import PladeNet
from planedepth_tpu_torch.models.resnet import ResnetEncoder

NET_TYPES = ("ResNet", "PladeNet", "FalNet")


class DepthModel(nn.Module):
    """One depth network behind ``(image, grid) -> outputs``, by
    ``cfg.net_type``: the ResNet encoder + plane ``DepthDecoder``
    (submodules ``encoder`` and ``depth``, which take the reference's
    ``encoder.pth`` and ``depth.pth`` state dicts), ``PladeNet`` (submodule
    ``plade``) or ``FalNet`` (submodule ``fal``), the JAX package's names.

    ``image`` is ``(B, 3, H, W)`` in [0, 1], ``grid`` the ``(B, 2, H, W)``
    augmentation grid.  ``fused_sweep_loss`` reaches
    only the ResNet decoder; the other families always emit ``disp``.
    ``dtype`` is the networks' compute dtype (``models/layers.py``: None
    for the input's, ``torch.bfloat16`` for the JAX package's default).
    """

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.net_type not in NET_TYPES:
            raise ValueError(f"unknown net_type {cfg.net_type!r} (one of {NET_TYPES})")
        self.cfg = cfg
        self.dtype = dtype
        if cfg.net_type == "PladeNet":
            self.plade = PladeNet(cfg.planes, num_ep=cfg.num_ep,
                                  use_mixture_loss=cfg.use_mixture_loss,
                                  render_probability=cfg.render_probability,
                                  plane_residual=cfg.plane_residual, dtype=dtype)
            return
        if cfg.net_type == "FalNet":
            if cfg.render_probability:
                # the JAX factory drops the flag for FalNet, and its rescue
                # step would then find no dists
                raise NotImplementedError(
                    "FalNet has no render_probability head: the JAX FalNet builds "
                    "none and its factory drops the flag")
            self.fal = FalNet(cfg.planes, dtype=dtype)
            return
        # remat reaches the depth encoder alone, as in the JAX factory
        self.encoder = ResnetEncoder(cfg.num_layers, dtype=dtype, remat=cfg.remat)
        self.depth = DepthDecoder(
            num_ch_enc=tuple(int(c) for c in self.encoder.num_ch_enc),
            planes=cfg.planes,
            num_ep=cfg.num_ep,
            pe_type=cfg.pe_type,
            use_denseaspp=cfg.use_denseaspp,
            use_mixture_loss=cfg.use_mixture_loss,
            render_probability=cfg.render_probability,
            plane_residual=cfg.plane_residual,
            fused_sweep_loss=cfg.fused_sweep_loss,
            dtype=dtype,
        )

    def forward(self, image: torch.Tensor, grid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator`` draws the ResNet decoder's dropout masks in
        training (PladeNet and FalNet have no dropout)."""
        if self.cfg.net_type == "PladeNet":
            return self.plade(image, grid)
        if self.cfg.net_type == "FalNet":
            return self.fal(image)
        return self.depth(self.encoder(image), grid, generator)


def build_depth_model(cfg: ModelConfig, bf16: bool = False) -> DepthModel:
    """``DepthModel`` computing in bf16 or in float32
    (``planedepth_tpu/models/factory.py:build_depth_model``)."""
    return DepthModel(cfg, dtype=torch.bfloat16 if bf16 else None)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn on the CPU from ``generator``: conv
    kernels normal with variance 1/fan_in (flax's default), conv biases 0,
    BatchNorm scale 1, bias 0, running mean 0, running var 1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            w = torch.randn(m.weight.shape, generator=generator) / math.sqrt(fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
