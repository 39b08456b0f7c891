"""Frozen perceptual feature extractors (``planedepth_tpu/models/perceptual.py``,
reference layers.py:378-449), chosen by ``LossConfig.pc_net``.

``Vgg19Features``: ImageNet normalisation, then torchvision's ``features``
layers up to pool3; the three slices end at the pools (``features[0:5]``,
``[5:10]``, ``[10:19]``), so the features compared are the pooled maps.
Parameters keep torchvision's ``features.{i}`` names.
``Resnet18Features``: ImageNet normalisation, then the ResNet-18 trunk
(``models/resnet.py``, under ``encoder.``) with BatchNorm on its running
statistics; its first three feature maps (relu1, layer1, layer2).
Both nets are frozen (``requires_grad_(False)``, always in eval mode);
gradients still reach their input.  The normalisation runs in the input's
dtype (a bf16 reconstruction in bf16, a float32 image in float32), then
casts to the nets' compute ``dtype`` (``models/layers.py``), as the JAX
modules do.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from planedepth_tpu_torch.models.layers import Conv2d, to_dtype
from planedepth_tpu_torch.models.resnet import ResNetTrunk

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# torchvision vgg19 config E up to pool3: channels, then "M" for a max-pool
_VGG_LAYERS = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M")
SLICE_ENDS = (5, 10, 19)


class _Frozen(nn.Module):
    """A feature net that no step trains: no parameter requires grad, and
    it stays in eval mode."""

    def normalise(self, x: torch.Tensor) -> torch.Tensor:
        """ImageNet normalisation in x's dtype, then the compute dtype."""
        return to_dtype((x - self.mean.to(x.dtype)) / self.std.to(x.dtype), self.dtype)

    def freeze(self):
        # constants, not weights: outside the state dict
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        """Frozen: stays in eval mode."""
        return super().train(False)


class Vgg19Features(_Frozen):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        layers, ch = [], 3
        for item in _VGG_LAYERS:
            if item == "M":
                layers.append(nn.MaxPool2d(2))
            else:
                layers += [Conv2d(ch, item, 3, padding=1, dtype=dtype), nn.ReLU()]
                ch = item
        self.features = nn.Sequential(*layers)
        self.freeze()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.normalise(x)
        feats, start = [], 0
        for end in SLICE_ENDS:
            h = self.features[start:end](h)
            feats.append(h)
            start = end
        return feats


class Resnet18Features(_Frozen):
    """(reference layers.py:424-449)"""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetTrunk(18, dtype=dtype)
        self.freeze()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.encoder(self.normalise(x))[:3]


def make_perceptual_net(kind: str, dtype: Optional[torch.dtype] = None) -> nn.Module:
    if kind == "vgg19":
        return Vgg19Features(dtype)
    if kind == "resnet18":
        return Resnet18Features(dtype)
    raise ValueError(f"unknown perceptual net: {kind}")
