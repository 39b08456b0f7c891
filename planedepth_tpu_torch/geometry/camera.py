"""Camera constants and the disparity/depth law (``planedepth_tpu/geometry/camera.py``).

Normalized KITTI intrinsics fx=0.58, fy=1.92, cx=cy=0.5 and
``depth = 0.1 * 0.58 * W / disp`` (baseline 0.1 model units), bit for bit.
"""
from __future__ import annotations

import numpy as np

# Normalized KITTI intrinsics (rows scaled by 1/W, 1/H).
NORMALIZED_K = np.array(
    [[0.58, 0.0, 0.5, 0.0],
     [0.0, 1.92, 0.5, 0.0],
     [0.0, 0.0, 1.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]],
    dtype=np.float32,
)

BASELINE = 0.1            # stereo baseline in model units
FX_NORM = 0.58
STEREO_SCALE_FACTOR = 5.4  # model units -> metres


def disp_to_depth(disp, width: int):
    """``depth = 0.1 * 0.58 * W / disp``."""
    return BASELINE * FX_NORM * width / disp
