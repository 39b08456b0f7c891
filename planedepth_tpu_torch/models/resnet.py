"""ResNet encoder, NCHW (``planedepth_tpu/models/resnet.py``).

Written out here because the port may not depend on torchvision; the
parameter layout is torchvision's (``conv1``, ``bn1``,
``layer{i}.{b}.conv{k}``/``bn{k}``, ``downsample.0``/``.1``), under the
``encoder.`` prefix of the reference's ``ResnetEncoder``, so a reference
``encoder.pth`` loads as it is.  BatchNorm is torch's (eps 1e-5); the stem's
max-pool pads with -inf, as ``F.max_pool2d`` does.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# blocks per stage and block type, as torchvision builds them
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def encoder_channels(num_layers: int) -> np.ndarray:
    """Channels of the 5 feature maps [relu1, layer1..layer4]."""
    ch = np.array([64, 64, 128, 256, 512])
    if num_layers > 34:
        ch[1:] *= 4
    return ch


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                         nn.BatchNorm2d(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, width, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = (_downsample(in_ch, width, stride)
                           if stride != 1 or in_ch != width else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = (_downsample(in_ch, out_ch, stride)
                           if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetTrunk(nn.Module):
    """conv1 .. layer4, returning the 5 feature maps [relu1, layer1..layer4];
    ``in_ch`` input channels (6 for the pose encoder's frame pairs)."""

    def __init__(self, num_layers: int = 50, in_ch: int = 3):
        super().__init__()
        kind, blocks = RESNET_SPECS[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(in_ch, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for stage, (width, n) in enumerate(zip((64, 128, 256, 512), blocks)):
            layer = []
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                layer.append(block(in_ch, width, stride))
                in_ch = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        features = [x]
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            features.append(x)
        return features


class ResnetEncoder(nn.Module):
    """Depth encoder (reference networks/resnet_encoder.py:18-55): input
    normalisation ``(x - 0.45) / 0.225``, then the trunk."""

    def __init__(self, num_layers: int = 50, in_ch: int = 3):
        super().__init__()
        self.num_ch_enc = encoder_channels(num_layers)
        self.encoder = ResNetTrunk(num_layers, in_ch)

    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        return self.encoder((image - 0.45) / 0.225)


class ResnetPoseEncoder(ResnetEncoder):
    """Pose encoder on ``num_input_images`` frames stacked on channels
    (reference pose_net.py:19-97): the same normalisation and trunk with a
    ``3 * num_input_images``-channel ``conv1``; a reference
    ``pose_encoder.pth`` loads as it is."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 2):
        super().__init__(num_layers, in_ch=3 * num_input_images)
