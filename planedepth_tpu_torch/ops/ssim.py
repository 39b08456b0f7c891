"""SSIM distance (``planedepth_tpu/ops/ssim.py``, reference layers.py:276-306), NCHW.

Reflection pad by 1, then 3x3 means; ``C1 = 0.01^2``, ``C2 = 0.03^2``.  The
output is ``clamp((1 - SSIM) / 2, 0, 1)`` per pixel and channel.  Plain
tensor code on any device, as the JAX package computes it in XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3/1 mean of the reflection-padded input; same H x W."""
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, stride=1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM distance, ``(B, C, H, W) -> (B, C, H, W)``."""
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x ** 2
    sigma_y = _avg_pool3(y * y) - mu_y ** 2
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x ** 2 + mu_y ** 2 + _C1) * (sigma_x + sigma_y + _C2)
    return torch.clamp((1.0 - n / d) / 2.0, 0.0, 1.0)
