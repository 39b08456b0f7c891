"""Model factory (``planedepth_tpu/models/factory.py``): config -> ``DepthModel``."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from planedepth_tpu_torch.config import ModelConfig
from planedepth_tpu_torch.models.depth_decoder import DepthDecoder
from planedepth_tpu_torch.models.resnet import ResnetEncoder


class DepthModel(nn.Module):
    """ResNet encoder + plane ``DepthDecoder``: ``(image, grid) -> outputs``.

    ``image`` is ``(B, 3, H, W)`` in [0, 1], ``grid`` the ``(B, 2, H, W)``
    augmentation grid.  Submodules ``encoder`` and ``depth`` take the
    reference's ``encoder.pth`` and ``depth.pth`` state dicts.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.net_type != "ResNet":
            raise NotImplementedError(
                f"net_type {cfg.net_type!r} is not ported yet (ROADMAP A11)")
        self.cfg = cfg
        self.encoder = ResnetEncoder(cfg.num_layers)
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
        )

    def forward(self, image: torch.Tensor, grid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``generator`` draws the decoder's dropout masks in training."""
        return self.depth(self.encoder(image), grid, generator)


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
