"""Configuration of the inference slice (counterpart of ``planedepth_tpu/config.py``).

Same names and defaults as the JAX package's ``PlaneConfig`` and
``ModelConfig``, and the ``height``/``width`` of its ``DataConfig``.  The
TPU-only fields (``s2d_tail``, ``s2d_stem``, ``fused_head``,
``fused_head_bf16``, ``fused_sweep_loss``, ``remat``) have no counterpart: the
disparity head takes its CUDA kernel whenever its tensors lie on the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PlaneConfig:
    """Plane-volume layout (reference: networks/depth_decoder.py:18-52)."""

    disp_levels: int = 49           # vertical (fronto-parallel) planes
    disp_min: float = 2.0
    disp_max: float = 300.0
    xz_levels: int = 14             # ground planes
    xz_min: float = 0.1852
    xz_max: float = 0.3704
    yz_levels: int = 0              # side planes (2 x yz_levels//2)
    yz_min: float = 0.1
    yz_max: float = 10.0

    def __post_init__(self):
        if self.disp_levels < 2:
            raise ValueError("disp_levels must be >= 2")
        if not (self.xz_levels == 0 or self.xz_levels >= 2):
            raise ValueError("xz_levels must be 0 or >= 2")
        if self.yz_levels % 2 != 0 or self.yz_levels == 2:
            raise ValueError("yz_levels must be even and 0 or >= 4 (two "
                             "half-sets with >= 2 levels each)")

    @property
    def all_levels(self) -> int:
        return self.disp_levels + self.xz_levels + self.yz_levels


@dataclass(frozen=True)
class ModelConfig:
    """Network architecture selection (reference: options.py:99-163)."""

    net_type: str = "ResNet"        # ResNet (PladeNet | FalNet: ROADMAP A11)
    num_layers: int = 50            # resnet depth: 18/34/50/101/152
    num_ep: int = 8                 # positional-encoding channels
    pe_type: str = "neural"         # neural | frequency
    use_denseaspp: bool = True
    use_mixture_loss: bool = True
    plane_residual: bool = True
    render_probability: bool = False
    planes: PlaneConfig = field(default_factory=PlaneConfig)


@dataclass(frozen=True)
class DataConfig:
    """Network input size (reference: options.py:27-60)."""

    height: int = 192
    width: int = 640

    def __post_init__(self):
        if self.height % 32 or self.width % 32:
            raise ValueError("'height' and 'width' must be multiples of 32")
