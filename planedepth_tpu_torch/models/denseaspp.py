"""DenseASPP block, NCHW (``planedepth_tpu/models/denseaspp.py``).

Five cascaded dilated blocks (d = 3, 6, 12, 18, 24) with dense concatenation,
each [BN -> ReLU -> 1x1 conv -> BN -> ReLU -> 3x3 dilated conv -> channel
dropout], then dropout and a 1x1 fuse.  Module names are the reference's
(``ASPP_{d}.norm1/conv1/norm2/conv2``, ``classification.1``).  BN momentum is
the reference's 0.0003 in torch's convention; in eval mode BN uses its running
statistics and dropout is inactive.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

DILATIONS = (3, 6, 12, 18, 24)
NUM_FEATURES, D_FEATURE0, D_FEATURE1, DROPOUT0 = 256, 512, 128, 0.1


class DenseAsppBlock(nn.Module):
    def __init__(self, in_ch: int, dilation: int, bn_start: bool):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(in_ch, momentum=0.0003) if bn_start else None
        self.conv1 = nn.Conv2d(in_ch, D_FEATURE0, 1)
        self.norm2 = nn.BatchNorm2d(D_FEATURE0, momentum=0.0003)
        self.conv2 = nn.Conv2d(D_FEATURE0, D_FEATURE1, 3, padding=dilation,
                               dilation=dilation)

    def forward(self, x):
        if self.norm1 is not None:
            x = self.norm1(x)
        x = self.conv1(F.relu(x))
        x = self.conv2(F.relu(self.norm2(x)))
        return F.dropout2d(x, DROPOUT0, training=self.training)


class DenseAspp(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        ch = in_ch
        for i, d in enumerate(DILATIONS):
            setattr(self, f"ASPP_{d}", DenseAsppBlock(ch, d, bn_start=i > 0))
            ch += D_FEATURE1
        self.classification = nn.Sequential(
            nn.Dropout2d(DROPOUT0), nn.Conv2d(ch, NUM_FEATURES, 1))

    def forward(self, x):
        feature = x
        for d in DILATIONS:
            out = getattr(self, f"ASPP_{d}")(feature)
            feature = torch.cat([out, feature], dim=1)
        return self.classification(feature)
