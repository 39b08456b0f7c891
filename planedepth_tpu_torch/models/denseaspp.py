"""DenseASPP block, NCHW (``planedepth_tpu/models/denseaspp.py``).

Five cascaded dilated blocks (d = 3, 6, 12, 18, 24) with dense concatenation,
each [BN -> ReLU -> 1x1 conv -> BN -> ReLU -> 3x3 dilated conv -> channel
dropout], then dropout and a 1x1 fuse.  Module names are the reference's
(``ASPP_{d}.norm1/conv1/norm2/conv2``, ``classification.1``).  BN momentum is
the reference's 0.0003 in torch's convention; in eval mode BN uses its running
statistics and dropout is inactive.  In training the channel-dropout masks are
drawn from the ``torch.Generator`` the caller passes.  ``dtype`` is the
compute dtype of ``models/layers.py``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from planedepth_tpu_torch.models.layers import BatchNorm2d, Conv2d, scalar

DILATIONS = (3, 6, 12, 18, 24)
NUM_FEATURES, D_FEATURE0, D_FEATURE1, DROPOUT0 = 256, 512, 128, 0.1


class DropoutRows:
    """A rank's rows of the global network batch, for dropout masks drawn
    over that batch: ``generator`` draws the ``(size, C)`` mask a
    single-process step on the global batch draws, and the rank keeps
    ``rows`` (a CPU index tensor), so the ranks' masks together are that
    step's (``train/step.py:make_train_step`` builds it)."""

    def __init__(self, generator: torch.Generator, rows: torch.Tensor, size: int):
        self.generator, self.rows, self.size = generator, rows, size


def channel_dropout(x: torch.Tensor, rate: float, training: bool,
                    generator: Union[torch.Generator, DropoutRows, None]) -> torch.Tensor:
    """``F.dropout2d`` with its per-sample channel mask drawn from
    ``generator`` (flax ``nn.Dropout(broadcast_dims=(1, 2))`` in NHWC).  The
    ``(B, C)`` mask is drawn in float32 on the generator's device and moved to
    x's, so a CPU generator gives the same masks on the card and on the CPU,
    in any dtype.  A :class:`DropoutRows` draws the global batch's mask and
    keeps this rank's rows."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("DenseASPP dropout in training needs a torch.Generator")
    rows, size = None, x.shape[0]
    if isinstance(generator, DropoutRows):
        generator, rows, size = generator.generator, generator.rows, generator.size
    keep = torch.full((size, x.shape[1], 1, 1), 1.0 - rate, device=generator.device)
    keep = torch.bernoulli(keep, generator=generator)
    if rows is not None:
        keep = keep[rows]
    keep = keep.to(x.device, x.dtype)
    return x * keep / scalar(1.0 - rate, x)


class DenseAsppBlock(nn.Module):
    def __init__(self, in_ch: int, dilation: int, bn_start: bool, dropout: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.norm1 = BatchNorm2d(in_ch, momentum=0.0003) if bn_start else None
        self.conv1 = Conv2d(in_ch, D_FEATURE0, 1, dtype=dtype)
        self.norm2 = BatchNorm2d(D_FEATURE0, momentum=0.0003)
        self.conv2 = Conv2d(D_FEATURE0, D_FEATURE1, 3, padding=dilation,
                            dilation=dilation, dtype=dtype)

    def forward(self, x, generator=None):
        if self.norm1 is not None:
            x = self.norm1(x)
        x = self.conv1(F.relu(x))
        x = self.conv2(F.relu(self.norm2(x)))
        return channel_dropout(x, self.dropout, self.training, generator)


class DenseAspp(nn.Module):
    """``dropout`` is the JAX module's ``dropout0``: the rate of every
    channel dropout (the reference's 0.1)."""

    def __init__(self, in_ch: int, dropout: float = DROPOUT0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        ch = in_ch
        for i, d in enumerate(DILATIONS):
            setattr(self, f"ASPP_{d}", DenseAsppBlock(ch, d, i > 0, dropout, dtype))
            ch += D_FEATURE1
        # index 0 keeps the reference's key ``classification.1``
        self.classification = nn.Sequential(
            nn.Identity(), Conv2d(ch, NUM_FEATURES, 1, dtype=dtype))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        feature = x
        for d in DILATIONS:
            out = getattr(self, f"ASPP_{d}")(feature, generator)
            feature = torch.cat([out, feature], dim=1)
        feature = channel_dropout(feature, self.dropout, self.training, generator)
        return self.classification(feature)
