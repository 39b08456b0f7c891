"""Pose networks, NCHW (``planedepth_tpu/models/pose_net.py``): ``PoseDecoder``
and the two-image ``PladePoseNet``.

``PoseDecoder`` (reference networks/pose_net.py:99-155): a 1x1 squeeze of
the encoder's last feature map, the optional neural positional encoding of
the augmentation grid (resized to that map, align corners), three pose
convs, the spatial mean and the 0.01 scale into ``(axisangle,
translation)``.  The modules sit in one ``net`` ModuleList in the
reference's order: squeeze, [epconv], pose_0, pose_1, pose_2
(``utils/torch_convert.py:convert_pose_decoder``), so a reference
``pose.pth`` loads as it is.

``PladePoseNet`` (reference pose_net.py:209-346, JAX ``pose_net.py:73-149``):
the FAL-net-style siamese encoder ``PladeBackbone`` (both images through one
set of stage convs, the grid's positional encoding at six scales, a last
stage on the two images' features side by side), then the pose head.  The
reference trainer never builds it; it is kept for API parity.  Its modules
carry the JAX module names (``backbone.conv0.norm``, ``backbone.conv_ep1.conv0``,
``pose_0``), which ``utils/weights.py:load_jax_plade_pose_params`` maps.
The shared stage convs run twice a forward, so in training their
BatchNorm running statistics take two updates a forward, one an image, as
the JAX module's do inside one ``apply`` and the reference's do.

``dtype`` is the compute dtype (``models/layers.py``); the spatial mean is
float32, as the JAX modules'.  On row shards (a spatial mesh axis) the
convs, the pool, BatchNorm and the resizes take their rows through
``models/layers.py``, and the spatial mean is the image's, the same pose
on every rank of the spatial group (``parallel/halo.py:image_mean``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from planedepth_tpu_torch.models.layers import (
    Conv2d,
    ConvELU,
    EpConv,
    ResidualBlock,
    ep_conv,
    resize_bilinear_align_corners,
    to_dtype,
    upcast,
)
from planedepth_tpu_torch.parallel.halo import image_mean


class PoseDecoder(nn.Module):
    """One frame pair's features -> its relative pose (the reference
    trainer's ``num_input_features=1``, ``num_frames_to_predict_for=1``)."""

    def __init__(self, num_ch_enc: Sequence[int], num_ep: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_ep = num_ep
        self.dtype = dtype
        layers = [Conv2d(int(num_ch_enc[-1]), 256, 1, dtype=dtype)]
        if num_ep > 0:
            layers.append(ep_conv(num_ep, dtype))
        layers += [Conv2d(256 + num_ep, 256, 3, padding=1, dtype=dtype),
                   Conv2d(256, 256, 3, padding=1, dtype=dtype),
                   Conv2d(256, 6, 1, dtype=dtype)]
        self.net = nn.ModuleList(layers)

    def forward(self, features: Sequence[torch.Tensor], grid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``features``: the pose encoder's pyramid; ``grid`` ``(B, 2, H, W)``.
        Returns axisangle and translation, each ``(B, 1, 1, 3)``."""
        squeeze, *rest = self.net
        x = F.relu(squeeze(to_dtype(features[-1], self.dtype)))
        if self.num_ep > 0:
            epconv, *rest = rest
            x = torch.cat([x, resize_bilinear_align_corners(epconv(grid), x.shape[-2:])],
                          dim=1)
        pose_0, pose_1, pose_2 = rest
        return pose_head_output(pose_2(F.relu(pose_1(F.relu(pose_0(x))))))


def pose_head_output(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, 6, h, w)`` pose-conv output -> axisangle and translation, each
    ``(B, 1, 1, 3)``: the float32 spatial mean (the image's on row shards)
    scaled by 0.01."""
    out = 0.01 * image_mean(upcast(x)).reshape(-1, 1, 1, 6)
    return out[..., :3], out[..., 3:]


class PladeBackbone(nn.Module):
    """Two-image siamese encoder (reference pose_net.py:209-308, JAX
    ``pose_net.py:PladeBackbone``): ``(x, y, grid)`` -> ``(B, 256, H/64,
    W/64)``."""

    STAGES = (2, 3, 4, 5, 6)

    def __init__(self, batch_norm: bool = True, num_ep: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_ep < 1:
            raise ValueError(f"PladeBackbone needs num_ep > 0 (its encodings are built "
                             f"unconditionally, as in the JAX module), got {num_ep}")
        self.dtype = dtype
        bn, dt, ep = batch_norm, dtype, num_ep
        self.conv0 = ConvELU(3, 64, 3, batch_norm=bn, dtype=dt)
        self.conv0_1 = ResidualBlock(64, dtype=dt)
        self.conv0l = ConvELU(3, 64, 3, batch_norm=bn, dtype=dt)
        self.conv0l_1 = ResidualBlock(64, dtype=dt)
        self.conv1 = ConvELU(64 + ep, 128, stride=2, batch_norm=bn, dtype=dt)
        self.conv1_1 = ResidualBlock(128, dtype=dt)
        cin = {2: 128 + 64 + ep, 3: 256 + ep, 4: 256 + ep, 5: 256 + ep, 6: 2 * 256 + ep}
        for i in self.STAGES:
            self.add_module(f"conv{i}", ConvELU(cin[i], 256, stride=2, batch_norm=bn,
                                                dtype=dt))
            self.add_module(f"conv{i}_1", ResidualBlock(256, dtype=dt))
        for i in range(1, 7):
            self.add_module(f"conv_ep{i}", EpConv(num_ep, dt))

    def forward(self, x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        """``x``, ``y`` ``(B, 3, H, W)``, ``grid`` ``(B, 2, H, W)``."""
        dt = self.dtype
        x, y, grid = to_dtype(x, dt), to_dtype(y, dt), to_dtype(grid, dt)
        eps = [getattr(self, f"conv_ep{i}")(grid) for i in range(1, 7)]

        def d(g, ref):
            return resize_bilinear_align_corners(g, ref.shape[-2:])

        def stage(i, *parts):
            return getattr(self, f"conv{i}_1")(getattr(self, f"conv{i}")(
                torch.cat(parts, dim=1)))

        def enc_half(img):
            out0 = self.conv0_1(self.conv0(img))
            out1 = stage(1, out0, eps[0])
            half = resize_bilinear_align_corners(img, out1.shape[-2:])
            out0l = self.conv0l_1(self.conv0l(half))
            out = stage(2, out1, out0l, d(eps[1], out1))
            for i in (3, 4, 5):
                out = stage(i, out, d(eps[i - 1], out))
            return out

        out5_x, out5_y = enc_half(x), enc_half(y)
        return stage(6, out5_x, out5_y, d(eps[5], out5_x))


class PladePoseNet(nn.Module):
    """The siamese pose net (reference pose_net.py:311-346, JAX
    ``pose_net.py:PladePoseNet``): ``PladeBackbone`` (submodule
    ``backbone``), two 3x3 ReLU convs and a 1x1 to 6 channels (``pose_0``,
    ``pose_1``, ``pose_2``)."""

    def __init__(self, batch_norm: bool = True, num_ep: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone = PladeBackbone(batch_norm, num_ep, dtype)
        self.pose_0 = Conv2d(256, 256, 3, padding=1, dtype=dtype)
        self.pose_1 = Conv2d(256, 256, 3, padding=1, dtype=dtype)
        self.pose_2 = Conv2d(256, 6, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor, grid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns axisangle and translation, each ``(B, 1, 1, 3)``."""
        h = self.backbone(x, y, grid)
        return pose_head_output(self.pose_2(F.relu(self.pose_1(F.relu(self.pose_0(h))))))
