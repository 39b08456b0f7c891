"""FalNet, the reference's baseline family: 49 fronto-parallel planes,
softmax compositing (``planedepth_tpu/models/fal_net.py``, reference
networks/fal_net.py:73-207), NCHW.

Module names follow the JAX modules (``backbone.conv0.conv``,
``backbone.conv0_1.conv1``, ``backbone.deconv6.conv1``, ``backbone.iconv1``,
``conv0``), which ``utils/weights.py:load_jax_params`` maps from a JAX
``{"fal": ...}`` tree.  The outputs are plane-first, as the ResNet
decoder's: ``logits``/``probability`` ``(B, N, H, W)``, ``disp_layered`` and
an all-ones ``padding_mask`` ``(B, N, H, 1)``, ``disp_rows`` ``(B, H, N)``,
``disp`` and ``depth`` ``(B, 1, H, W)``.  FalNet has no mixture head: it
trains only through the no-mixture plane sweep.  ``dtype`` is the
backbone's compute dtype (``models/layers.py``); the logits leave it in
float32, as the JAX module's do.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from planedepth_tpu_torch.config import PlaneConfig
from planedepth_tpu_torch.geometry.camera import disp_to_depth
from planedepth_tpu_torch.models.layers import (
    Conv2d,
    ConvELU,
    Deconv,
    ResidualBlock,
    to_dtype,
    upcast,
)

# FalNet/PladeNet input normalisation (reference plade_net.py:248, fal_net.py:176)
FAL_MEAN = (0.411, 0.432, 0.45)


def subtract_fal_mean(image: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(FAL_MEAN, dtype=image.dtype, device=image.device)
    return image - mean[:, None, None]


class FalBackBone(nn.Module):
    """Seven strided conv + residual stages at 32...512 channels, the
    deconv/iconv ladder back to full resolution, and the bias-free
    ``iconv1`` head (reference fal_net.py:73-156)."""

    CHANNELS = (32, 64, 128, 256, 256, 256, 512)
    # (deconv out, iconv out) per level 6..2; the deconv1 + iconv1 head after
    LADDER = ((256, 256), (128, 256), (128, 256), (128, 128), (64, 64))

    def __init__(self, no_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"conv{i}", ConvELU(cin, ch, 3, stride=1 if i == 0 else 2,
                                                dtype=dtype))
            self.add_module(f"conv{i}_1", ResidualBlock(ch, dtype=dtype))
            cin = ch
        for level, (dch, ich) in zip(range(6, 1, -1), self.LADDER):
            self.add_module(f"deconv{level}", Deconv(cin, dch, dtype))
            self.add_module(f"iconv{level}", ConvELU(dch + self.CHANNELS[level - 1], ich,
                                                     dtype=dtype))
            cin = ich
        self.deconv1 = Deconv(cin, 64, dtype)
        self.iconv1 = Conv2d(64 + self.CHANNELS[0], no_out, 3, padding=1, bias=False,
                             dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_dtype(x, self.dtype)
        outs = []
        for i in range(len(self.CHANNELS)):
            x = getattr(self, f"conv{i}_1")(getattr(self, f"conv{i}")(x))
            outs.append(x)
        h = outs[6]
        for level in range(6, 1, -1):
            skip = outs[level - 1]
            h = getattr(self, f"deconv{level}")(h, skip.shape[-2:])
            h = getattr(self, f"iconv{level}")(torch.cat([h, skip], 1))
        h = self.deconv1(h, outs[0].shape[-2:])
        return self.iconv1(torch.cat([h, outs[0]], 1))


class FalNet(nn.Module):
    """``image - FAL_MEAN`` -> backbone -> 1x1 ``conv0`` -> softmax over the
    planes (reference fal_net.py:159-207).  The plane disparities are the
    fixed geometric grid ``disp_max * (disp_min / disp_max) ** (n / (N - 1))``
    (``fal_net.py:86-87``) and take no gradient."""

    def __init__(self, planes: PlaneConfig, dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = planes.disp_levels
        self.planes = planes
        self.backbone = FalBackBone(n, dtype)
        self.conv0 = Conv2d(n, n, 1, dtype=dtype)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.planes
        n = cfg.disp_levels
        logits = upcast(self.conv0(self.backbone(subtract_fal_mean(image))))
        B, _, H, W = logits.shape
        probability = torch.softmax(logits, dim=1)
        lvl = torch.arange(n, dtype=torch.float32, device=image.device)
        disp = cfg.disp_max * (cfg.disp_min / cfg.disp_max) ** (lvl / (n - 1))
        disp_layered = disp[None, :, None, None].expand(B, n, H, 1)
        out = {"logits": logits, "probability": probability,
               "disp_layered": disp_layered,
               "padding_mask": torch.ones_like(disp_layered),
               "disp_rows": disp[None, None, :].expand(B, H, n).contiguous(),
               "disp": (probability * disp_layered).sum(dim=1, keepdim=True)}
        out["depth"] = disp_to_depth(out["disp"], W)
        return out
