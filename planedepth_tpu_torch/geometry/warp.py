"""Per-plane warp coordinates of the 2-D warp modes (``planedepth_tpu/geometry/warp.py``).

Reference trainer.py:523-603 and layers.py:184-234 (``HomographyWarp``).
Each function returns normalised [-1, 1] sampling coordinates
(align_corners=True) ``(B, N, H, W, 2)``, plane axis second, as the JAX
package does; the port's plane volume is plane-first, so ``disp_layered``
comes in as ``(B, N, H, W_b)`` (``W_b`` 1 or W).  Everything is computed in
the inputs' float type; the 3x3 products over pixels are written out term by
term, so no matrix-product precision setting (TF32) can touch a coordinate.
"""
from __future__ import annotations

from typing import Tuple

import torch

from planedepth_tpu_torch.geometry.camera import backproject_depth, project_3d


def depth_warp_coords(disp_layered: torch.Tensor, T: torch.Tensor, K: torch.Tensor,
                      inv_K: torch.Tensor, width: int) -> torch.Tensor:
    """Backproject each plane's depth and project it into the target camera
    (trainer.py:533-538).  ``disp_layered`` ``(B, N, H, W_b)``; ``T``, ``K``,
    ``inv_K`` ``(B, 4, 4)``.  Returns ``(B, N, H, W, 2)``."""
    B, N, H, _ = disp_layered.shape
    depths = (0.1 * 0.58 * width / disp_layered).expand(B, N, H, width)
    rep = lambda M: M.repeat_interleave(N, dim=0)                       # (B*N, 4, 4)
    cam_points = backproject_depth(depths.reshape(B * N, H, width), rep(inv_K))
    coords = project_3d(cam_points, rep(K), rep(T), H, width)
    return coords.reshape(B, N, H, width, 2)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) batched 3x3 inverse: no LU, whose products may
    run at a reduced matrix precision, feeds a pixel coordinate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _apply_3x3(M: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Rows of ``M @ [x, y, 1]`` for ``M`` ``(..., 3, 3)`` over the pixel
    grid: three ``(..., H, W)`` maps."""
    M = M[..., None, None]
    return tuple(M[..., i, 0, :, :] * x + M[..., i, 1, :, :] * y + M[..., i, 2, :, :]
                 for i in range(3))


def homography_warp_coords(distance: torch.Tensor, normal: torch.Tensor, T: torch.Tensor,
                           K: torch.Tensor, inv_K: torch.Tensor, height: int,
                           width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plane-induced homography warp (reference layers.py:184-234).

    For plane (n, d) and relative pose T = [R|t] the source->target
    homography is ``K (R + t n^T / d) K^-1``; target pixels are pulled
    through its inverse.  The mask drops samples whose ray does not face the
    rotated normal or that land behind the camera (``z <= 1e-7``), and a
    masked coordinate is pinned to 2.0 (outside the image), so a singular
    homography samples 0 with zero gradients instead of NaN.

    ``distance`` ``(B, N)``, ``normal`` ``(B, N, 3)``, ``T``, ``K``, ``inv_K``
    ``(B, 4, 4)``.  Returns (coords ``(B, N, H, W, 2)``, mask ``(B, N, H, W)``).
    """
    dtype, device = distance.dtype, distance.device
    R = T[:, None, :3, :3]
    t = T[:, None, :3, 3:4]
    Rtnd = R + torch.matmul(t, normal[:, :, None, :]) / distance[:, :, None, None]
    H_s2t = torch.matmul(K[:, None, :3, :3], torch.matmul(Rtnd, inv_K[:, None, :3, :3]))
    H_t2s = inv3x3(H_s2t)                                             # (B, N, 3, 3)

    x = torch.arange(width, dtype=dtype, device=device)
    y = torch.arange(height, dtype=dtype, device=device)[:, None]
    X, Y, Z = _apply_3x3(H_t2s, x, y)                                 # (B, N, H, W)
    # visibility: the ray K^-1 x_t must face the rotated plane normal
    rays = _apply_3x3(inv_K[:, :3, :3], x, y)                         # 3 x (B, H, W)
    Rn = torch.matmul(T[:, :3, :3], normal.transpose(1, 2))           # (B, 3, N)
    facing = sum(r[:, None] * Rn[:, i, :, None, None] for i, r in enumerate(rays)) > 0.0
    mask = facing & (Z > 1e-7)
    Z = torch.clamp_min(Z, 1e-7)
    cx = (X / Z / (width - 1) - 0.5) * 2.0
    cy = (Y / Z / (height - 1) - 0.5) * 2.0
    coords = torch.stack([cx, cy], dim=-1)
    coords = torch.where(mask[..., None], coords, torch.full_like(coords, 2.0))
    return coords, mask.to(dtype)
