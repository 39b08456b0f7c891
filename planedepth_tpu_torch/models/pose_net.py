"""Pose decoder, NCHW (``planedepth_tpu/models/pose_net.py:PoseDecoder``,
reference networks/pose_net.py:99-155).

A 1x1 squeeze of the encoder's last feature map, the optional neural
positional encoding of the augmentation grid (resized to that map, align
corners), three pose convs, the spatial mean and the 0.01 scale into
``(axisangle, translation)``.  The modules sit in one ``net`` ModuleList in
the reference's order: squeeze, [epconv], pose_0, pose_1, pose_2
(``utils/torch_convert.py:convert_pose_decoder``), so a reference
``pose.pth`` loads as it is.  ``PladePoseNet`` is not ported yet (ROADMAP
A11).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from planedepth_tpu_torch.models.layers import ep_conv, resize_bilinear_align_corners


class PoseDecoder(nn.Module):
    """One frame pair's features -> its relative pose (the reference
    trainer's ``num_input_features=1``, ``num_frames_to_predict_for=1``)."""

    def __init__(self, num_ch_enc: Sequence[int], num_ep: int = 0):
        super().__init__()
        self.num_ep = num_ep
        layers = [nn.Conv2d(int(num_ch_enc[-1]), 256, 1)]
        if num_ep > 0:
            layers.append(ep_conv(num_ep))
        layers += [nn.Conv2d(256 + num_ep, 256, 3, padding=1),
                   nn.Conv2d(256, 256, 3, padding=1),
                   nn.Conv2d(256, 6, 1)]
        self.net = nn.ModuleList(layers)

    def forward(self, features: Sequence[torch.Tensor], grid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``features``: the pose encoder's pyramid; ``grid`` ``(B, 2, H, W)``.
        Returns axisangle and translation, each ``(B, 1, 1, 3)``."""
        squeeze, *rest = self.net
        x = F.relu(squeeze(features[-1]))
        if self.num_ep > 0:
            epconv, *rest = rest
            x = torch.cat([x, resize_bilinear_align_corners(epconv(grid), x.shape[-2:])],
                          dim=1)
        pose_0, pose_1, pose_2 = rest
        x = pose_2(F.relu(pose_1(F.relu(pose_0(x)))))
        out = 0.01 * x.mean(dim=(2, 3)).reshape(-1, 1, 1, 6)
        return out[..., :3], out[..., 3:]
