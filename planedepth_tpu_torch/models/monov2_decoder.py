"""Monodepth2-style multi-scale sigmoid-disparity decoder, NCHW
(``planedepth_tpu/models/monov2_decoder.py``, reference
networks/monov2_decoder.py:17-65).

The upconv ladder over the 5 encoder features (nearest x2 upsampling, the
encoder's skips), and at each scale in ``scales`` a sigmoid 3x3 ``dispconv``
in float32, keyed ``("disp", i)``.  The reference trainer never builds it;
it is kept for API parity.  Its modules carry the JAX module names
(``upconv_4_0.conv.conv``, ``dispconv_0.conv``), which
``utils/weights.py:load_jax_monov2_params`` maps.  ``dtype`` is the compute
dtype (``models/layers.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from planedepth_tpu_torch.models.layers import (
    Conv3x3,
    ConvBlock,
    to_dtype,
    upcast,
    upsample2x_nearest,
)

NUM_CH_DEC = (16, 32, 64, 128, 256)


class Monov2Decoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 1, use_skips: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        self.dtype = dtype
        for i in range(4, -1, -1):
            cin = int(num_ch_enc[-1]) if i == 4 else NUM_CH_DEC[i + 1]
            self.add_module(f"upconv_{i}_0", ConvBlock(cin, NUM_CH_DEC[i], dtype))
            cin = NUM_CH_DEC[i] + (int(num_ch_enc[i - 1]) if use_skips and i > 0 else 0)
            self.add_module(f"upconv_{i}_1", ConvBlock(cin, NUM_CH_DEC[i], dtype))
        for i in self.scales:
            self.add_module(f"dispconv_{i}", Conv3x3(NUM_CH_DEC[i], num_output_channels,
                                                     dtype))

    def forward(self, input_features: Sequence[torch.Tensor]
                ) -> Dict[Tuple[str, int], torch.Tensor]:
        """``input_features``: the encoder's 5 maps, finest first.  Returns
        ``{("disp", i): (B, num_output_channels, H / 2^i, W / 2^i)}``."""
        outputs = {}
        x = to_dtype(input_features[-1], self.dtype)
        for i in range(4, -1, -1):
            x = upsample2x_nearest(getattr(self, f"upconv_{i}_0")(x))
            if self.use_skips and i > 0:
                x = torch.cat([x, to_dtype(input_features[i - 1], self.dtype)], dim=1)
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                outputs[("disp", i)] = torch.sigmoid(upcast(getattr(self, f"dispconv_{i}")(x)))
        return outputs
