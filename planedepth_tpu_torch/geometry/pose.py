"""Pose algebra: axis-angle -> SE(3) and the crop-rotation conjugation
(``planedepth_tpu/geometry/pose.py``, reference layers.py:17-92 and
trainer.py:386-400).  Batched functions of ``(B, ...)`` tensors.
"""
from __future__ import annotations

import torch

from planedepth_tpu_torch.geometry.warp import inv3x3
from planedepth_tpu_torch.parallel.halo import global_rows


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``(B, 3)`` (or ``(B, 1, 3)``) -> rotation ``(B, 4, 4)``,
    Rodrigues as the reference writes it (the +1e-7 in the axis norm)."""
    vec = vec.reshape(vec.shape[0], 3)
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)       # (B, 1)
    axis = vec / (angle + 1e-7)
    ca, sa = torch.cos(angle)[:, 0], torch.sin(angle)[:, 0]
    C = 1.0 - ca
    x, y, z = axis.unbind(-1)
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows = [[x * xC + ca, xyC - zs, zxC + ys, zero],
            [xyC + zs, y * yC + ca, yzC - xs, zero],
            [zxC - ys, yzC + xs, z * zC + ca, zero],
            [zero, zero, zero, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation ``(B, 3)`` -> ``(B, 4, 4)``."""
    t = t.reshape(t.shape[0], 3)
    eye = torch.eye(4, dtype=t.dtype, device=t.device).expand(t.shape[0], 4, 4)
    return torch.cat([eye[:, :, :3], torch.cat([t, torch.ones_like(t[:, :1])], 1)[:, :, None]],
                     dim=2)


def transformation_from_parameters(axisangle: torch.Tensor, translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """(axisangle, translation) -> 4x4 SE(3); ``invert`` composes the inverse
    (negative frame offsets, reference trainer.py:381-382)."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return torch.matmul(R, T) if invert else torch.matmul(T, R)


def rc_correction(grid: torch.Tensor) -> torch.Tensor:
    """The crop's virtual-camera rotation ``Rc`` ``(B, 3, 3)`` from the
    ``(B, 2, H, W)`` augmentation grid: the pose net predicts motion in the
    cropped camera, conjugated into the canonical one by ``Rc R Rc^-1``.
    It reads the image's first and last grid rows, from the ranks that
    hold them on row shards (``parallel/halo.py:global_rows``)."""
    ends = global_rows(grid, (0, -1))                      # (B, 2, 2, W)
    gx0 = (ends[:, 0, 0, -1] + ends[:, 0, 0, 0]) / 2.0
    gy0 = (ends[:, 1, 1, 0] + ends[:, 1, 0, 0]) / 2.0
    f = (ends[:, 0, 0, -1] - ends[:, 0, 0, 0]) / 2.0
    col = torch.stack([-gx0 / (2 * 0.58), -gy0 / (2 * 1.92), f], dim=1)   # (B, 3)
    eye = torch.eye(3, dtype=grid.dtype, device=grid.device).expand(grid.shape[0], 3, 3)
    return torch.cat([eye[:, :, :2], col[:, :, None]], dim=2)


def apply_rc(Rt: torch.Tensor, Rc: torch.Tensor,
             rotate_translation: bool = False) -> torch.Tensor:
    """Conjugate a pose by the crop rotation (reference trainer.py:396-400):
    ``R' = Rc R Rc^-1`` in a 4x4 of zeros.  The reference's quirks stay: on
    the pose-net path the translation column is zero and ``T[3, 3]`` is 0, so
    the predicted translation gets no gradient; ``rotate_translation`` (the
    COLMAP path) sets ``t' = Rc t``."""
    R = torch.matmul(Rc, torch.matmul(Rt[:, :3, :3], inv3x3(Rc)))
    if rotate_translation:
        t = torch.matmul(Rc, Rt[:, :3, 3:4])
    else:
        t = torch.zeros_like(R[:, :, :1])
    top = torch.cat([R, t], dim=2)                                    # (B, 3, 4)
    return torch.cat([top, torch.zeros_like(top[:, :1])], dim=1)
