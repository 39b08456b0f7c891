"""Camera model (``planedepth_tpu/geometry/camera.py``).

Normalized KITTI intrinsics fx=0.58, fy=1.92, cx=cy=0.5 and
``depth = 0.1 * 0.58 * W / disp`` (baseline 0.1 model units), bit for bit;
the pixel grids, the unit-depth camera rays of ``render_probability``'s plane
distances, backprojection and projection of the depth warp and of the
self-reconstruction, in the JAX package's layouts.
"""
from __future__ import annotations

import numpy as np
import torch

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


def pixel_intrinsics(width: int, height: int) -> np.ndarray:
    """Normalized K scaled to pixel units."""
    K = NORMALIZED_K.copy()
    K[0, :] *= width
    K[1, :] *= height
    return K


def disp_to_depth(disp, width: int):
    """``depth = 0.1 * 0.58 * W / disp``."""
    return BASELINE * FX_NORM * width / disp


def depth_to_disp(depth, width: int):
    """``disp = 0.1 * 0.58 * W / depth``, the inverse of :func:`disp_to_depth`."""
    return BASELINE * FX_NORM * width / depth


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Integer pixel-centre coordinates ``(H, W, 2)`` with x, y channels."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def identity_norm_grid(height: int, width: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """The [-1, 1] identity grid ``(H, W, 2)`` used when no crop is applied."""
    ys, xs = torch.meshgrid(torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device),
                            torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def create_camera_plane(height: int, width: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Unit-depth camera rays ``K^-1 [x, y, 1]`` ``(H, W, 3)`` (reference
    layers.py:468-492), K in pixel units; the inverse by numpy, as the JAX
    package takes it, and the product written out term by term."""
    K_inv = torch.from_numpy(np.linalg.inv(pixel_intrinsics(width, height))[:3, :3]
                             ).to(dtype=dtype, device=device)
    grid = pixel_grid(height, width, dtype, device)
    x, y = grid[..., 0], grid[..., 1]
    return torch.stack([K_inv[i, 0] * x + K_inv[i, 1] * y + K_inv[i, 2]
                        for i in range(3)], dim=-1)


def _homogeneous_pixels(height: int, width: int, like: torch.Tensor) -> torch.Tensor:
    """``(3, H*W)`` rows x, y, 1."""
    grid = pixel_grid(height, width, like.dtype, like.device).reshape(-1, 2)
    return torch.cat([grid, torch.ones_like(grid[:, :1])], dim=1).T


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Depth ``(B, H, W)`` -> homogeneous camera-frame points ``(B, 4, H*W)``
    (reference layers.py:128-156); ``inv_K`` is ``(B, 4, 4)``."""
    B, H, W = depth.shape
    cam = torch.matmul(inv_K[:, :3, :3], _homogeneous_pixels(H, W, depth))
    cam = depth.reshape(B, 1, H * W) * cam
    return torch.cat([cam, torch.ones_like(cam[:, :1])], dim=1)


def project_3d(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor,
               height: int, width: int, eps: float = 1e-7) -> torch.Tensor:
    """Homogeneous points ``(B, 4, H*W)`` into a camera at pose ``T``
    (reference layers.py:159-182): normalised [-1, 1] coordinates
    ``(B, H, W, 2)`` in the align_corners=True convention."""
    P = torch.matmul(K, T)[:, :3, :]
    cam = torch.matmul(P, points)                                    # (B, 3, HW)
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    pix = pix.reshape(-1, 2, height, width).permute(0, 2, 3, 1)      # (B, H, W, 2)
    scale = torch.tensor([width - 1, height - 1], dtype=pix.dtype, device=pix.device)
    return (pix / scale - 0.5) * 2.0
