"""Frozen VGG-19 feature extractor (``planedepth_tpu/models/perceptual.py:Vgg19Features``,
reference layers.py:378-422).

ImageNet normalisation, then torchvision's ``features`` layers up to pool3;
the three slices end at the pools (``features[0:5]``, ``[5:10]``,
``[10:19]``), so the features compared are the pooled maps.  Parameters keep
torchvision's ``features.{i}`` names.  The net is frozen
(``requires_grad_(False)``, eval mode); gradients still reach its input.
``Resnet18Features`` is not ported yet (ROADMAP A4).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# torchvision vgg19 config E up to pool3: channels, then "M" for a max-pool
_VGG_LAYERS = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M")
SLICE_ENDS = (5, 10, 19)


class Vgg19Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers, ch = [], 3
        for item in _VGG_LAYERS:
            if item == "M":
                layers.append(nn.MaxPool2d(2))
            else:
                layers += [nn.Conv2d(ch, item, 3, padding=1), nn.ReLU()]
                ch = item
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        """Frozen: stays in eval mode."""
        return super().train(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = (x - self.mean) / self.std
        feats, start = [], 0
        for end in SLICE_ENDS:
            h = self.features[start:end](h)
            feats.append(h)
            start = end
        return feats
