"""Orthogonal plane-volume construction (``planedepth_tpu/geometry/planes.py``).

Plane-first layout: every per-plane map is ``(B, N, H, W_b)``.  Without yz
side planes each map is constant along a row (vertical planes are constant,
ground planes depend on the row only, the augmentation grid is rectilinear),
so it is built and returned with ``W_b = 1`` and consumers broadcast it;
with yz planes ``W_b = W``.  The 0.1*0.58*W disparity law, the 1.92 fy and
the 1e-7 clamps are those of the JAX package, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from planedepth_tpu_torch.config import PlaneConfig


class PlaneVolume(NamedTuple):
    disp_layered: torch.Tensor   # (B, N, H, W_b) per-plane disparity (pixels)
    padding_mask: torch.Tensor   # (B, N, H, W_b) float 0/1 validity
    distance: torch.Tensor       # (B, N) plane distance (model units)
    normal: torch.Tensor         # (B, N, 3) plane normal


def build_plane_volume(
    grid: torch.Tensor,
    cfg: PlaneConfig,
    width: int,
    residual_levels: Optional[torch.Tensor] = None,
) -> PlaneVolume:
    """The plane volume for a ``(B, 2, H, W)`` augmentation grid (x, y channels).

    ``residual_levels`` are optional ``(B, N)`` per-image plane offsets in
    (-0.5, 0.5) from the decoder's residual head.
    """
    B, _, H, W_g = grid.shape
    dtype, device = grid.dtype, grid.device
    no, xz, yz = cfg.disp_levels, cfg.xz_levels, cfg.yz_levels
    dw = 0.1 * 0.58 * width
    W_b = 1 if yz == 0 else W_g

    def resid(lo, hi):
        return 0.0 if residual_levels is None else residual_levels[:, lo:hi]

    def levels(n):
        return torch.arange(n, dtype=dtype, device=device)[None, :].expand(B, n)

    # --- vertical planes ----------------------------------------------------
    lvl = levels(no) + resid(0, no)                                   # (B, no)
    disp_v = cfg.disp_max * (cfg.disp_min / cfg.disp_max) ** (lvl / (no - 1))
    parts_d = [disp_v[:, :, None, None].expand(B, no, H, W_b)]
    parts_m = [torch.ones((B, no, H, W_b), dtype=dtype, device=device)]
    parts_dist = [dw / disp_v]
    parts_n = [torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
               .expand(B, no, 3)]

    gx = grid[:, 0]                                                   # (B, H, W)
    gy = grid[:, 1] if yz > 0 else grid[:, 1, :, :1]                  # (B, H, W_b)
    # per-row half-extent of the virtual-camera x range
    fs_row = (gx[:, :, -1:] - gx[:, :, :1]) / 2.0                     # (B, H, 1)

    # --- xz ground planes ---------------------------------------------------
    if xz > 0:
        glvl = levels(xz) + resid(no, no + xz)
        h = cfg.xz_min + (cfg.xz_max - cfg.xz_min) * glvl / (xz - 1)  # (B, xz)
        y_mask = (gy >= 1e-7).to(dtype)
        y = torch.clamp_min(gy, 1e-7)
        ground = h[:, :, None, None] * (1.92 / (y / 2.0))[:, None]
        ground = ground * fs_row[:, None]
        disp_g = dw / ground                                          # (B,xz,H,W_b)
        parts_d.append(disp_g)
        parts_m.append(y_mask[:, None].expand(disp_g.shape))

        gyc = (gy[:, -1, 0] + gy[:, 0, 0]) / 2.0                      # (B,)
        py = (gyc + 1.0) * H / 2.0
        fs = (gx[:, 0, -1] - gx[:, 0, 0]) / 2.0
        py_cy_fys = (py - H / 2.0) / (H * 1.92 * fs)
        n_unnorm = torch.stack(
            [torch.zeros_like(py_cy_fys), torch.ones_like(py_cy_fys),
             py_cy_fys], dim=1)                                       # (B, 3)
        n_scale = 1.0 / torch.sqrt(1.0 + py_cy_fys ** 2)
        xz_norm = n_unnorm * n_scale[:, None]
        parts_n.append(xz_norm[:, None, :].expand(B, xz, 3))
        parts_dist.append(h * n_scale[:, None])

    # --- yz side planes -----------------------------------------------------
    if yz > 0:
        half = yz // 2
        ylvl = torch.arange(half, dtype=dtype, device=device)
        ylvl = torch.cat([ylvl, ylvl])[None, :].expand(B, yz)
        ylvl = ylvl + resid(no + xz, no + xz + yz)
        yz_disp_max = 1.0 / cfg.yz_min
        yz_disp_min = 1.0 / cfg.yz_max
        yz_disp = yz_disp_max * (yz_disp_min / yz_disp_max) ** (
            ylvl / (0.5 * yz - 1))
        h_yz = 1.0 / yz_disp                                          # (B, yz)

        xr_mask = (gx >= 1e-7).to(dtype)
        xr = torch.clamp_min(gx, 1e-7)
        g_r = h_yz[:, :half, None, None] * (0.58 / (xr / 2.0))[:, None]
        g_r = g_r * fs_row[:, None]
        xl_mask = (gx <= -1e-7).to(dtype)
        xl = torch.clamp_max(gx, -1e-7)
        g_l = -h_yz[:, half:, None, None] * (0.58 / (xl / 2.0))[:, None]
        g_l = g_l * fs_row[:, None]

        parts_d.append(dw / torch.cat([g_r, g_l], dim=1))
        parts_m.append(torch.cat([xr_mask[:, None].expand(g_r.shape),
                                  xl_mask[:, None].expand(g_l.shape)], dim=1))

        gxc = (gx[:, 0, -1] + gx[:, 0, 0]) / 2.0
        px = (gxc + 1.0) * width / 2.0
        fs = (gx[:, 0, -1] - gx[:, 0, 0]) / 2.0
        px_cx_fxs = (px - width / 2.0) / (width * 0.58 * fs)
        n_unnorm = torch.stack(
            [torch.ones_like(px_cx_fxs), torch.zeros_like(px_cx_fxs),
             px_cx_fxs], dim=1)
        n_scale = 1.0 / torch.sqrt(1.0 + px_cx_fxs ** 2)
        n_r = (n_unnorm * n_scale[:, None])[:, None, :].expand(B, half, 3)
        parts_n.append(torch.cat([n_r, -n_r], dim=1))
        parts_dist.append(h_yz * n_scale[:, None])

    return PlaneVolume(
        disp_layered=torch.cat(parts_d, dim=1),
        padding_mask=torch.cat(parts_m, dim=1),
        distance=torch.cat(parts_dist, dim=1),
        normal=torch.cat(parts_n, dim=1),
    )
