"""Synthetic stereo scenes (a copy of ``planedepth_tpu/data/synthetic.py:make_stereo_batch``).

A textured left image is warped by a planted disparity field into a
geometrically consistent right view (the right-view pixel at x samples the
left image at x + d).  Pure numpy; the tests hold it bit-equal to the JAX
package's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from planedepth_tpu_torch.geometry.camera import NORMALIZED_K


def smooth_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Band-limited random RGB texture in [0, 1], (H, W, 3)."""
    base = rng.standard_normal((h // 4 + 2, w // 4 + 2, 3))
    img = np.kron(base, np.ones((4, 4, 1)))[:h, :w]
    for _ in range(2):
        img = (
            img
            + np.roll(img, 1, 0)
            + np.roll(img, -1, 0)
            + np.roll(img, 1, 1)
            + np.roll(img, -1, 1)
        ) / 5.0
    img = img - img.min()
    return (img / (img.max() + 1e-8)).astype(np.float32)


def shift_image(img: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """Synthesize the right view: right(x) = left(x + disp) with linear
    interpolation along width (border clamp)."""
    h, w, c = img.shape
    xs = np.arange(w)[None, :] + disp
    x0 = np.floor(xs).astype(np.int64)
    frac = (xs - x0)[..., None]
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    rows = np.arange(h)[:, None]
    return (1.0 - frac) * img[rows, x0c] + frac * img[rows, x1c]


def make_stereo_batch(
    batch_size: int = 2,
    height: int = 64,
    width: int = 96,
    seed: int = 0,
    constant_disp: Optional[float] = None,
    novel_frame_ids=(),
) -> Dict[str, np.ndarray]:
    """Build a batch dict in the JAX package's key convention (NHWC numpy).

    Keys: color_l/color_r/color_aug_l/color_aug_r (B,H,W,3), grid (B,H,W,2),
    K/inv_K (B,4,4), Rt_l/Rt_r (B,4,4), depth_gt_l/depth_gt_r (B,H,W,1).
    """
    rng = np.random.default_rng(seed)
    K = NORMALIZED_K.copy()
    K[0] *= width
    K[1] *= height
    inv_K = np.linalg.pinv(K)

    gx, gy = np.meshgrid(
        np.linspace(-1, 1, width), np.linspace(-1, 1, height)
    )
    grid = np.stack([gx, gy], axis=-1).astype(np.float32)

    colors_l, colors_r, depths = [], [], []
    for b in range(batch_size):
        img = smooth_texture(rng, height, width)
        if constant_disp is not None:
            disp = np.full((height, width), constant_disp, np.float32)
        else:
            # fronto-parallel background + a closer box
            disp = np.full((height, width), 4.0, np.float32)
            y0, x0 = height // 3, width // 3
            disp[y0 : 2 * y0, x0 : 2 * x0] = 10.0
        right = shift_image(img, disp)
        colors_l.append(img)
        colors_r.append(right.astype(np.float32))
        depths.append((0.1 * 0.58 * width / disp)[..., None])

    color_l = np.stack(colors_l)
    color_r = np.stack(colors_r)
    Rt_l = np.broadcast_to(np.eye(4, dtype=np.float32), (batch_size, 4, 4)).copy()
    Rt_l[:, 0, 3] = 0.1
    Rt_r = np.broadcast_to(np.eye(4, dtype=np.float32), (batch_size, 4, 4)).copy()
    Rt_r[:, 0, 3] = -0.1

    out = {}
    for f in novel_frame_ids:
        # temporal neighbors: small horizontal ego-motion of the left view
        shift = np.full((height, width), 1.5 * f, np.float32)
        frames = np.stack([shift_image(img, shift) for img in colors_l])
        out[f"color_{f}"] = frames.astype(np.float32)
        out[f"color_aug_{f}"] = frames.astype(np.float32).copy()
        Rt = np.broadcast_to(
            np.eye(4, dtype=np.float32), (batch_size, 4, 4)
        ).copy()
        Rt[:, 0, 3] = 0.02 * f
        out[f"Rt_{f}"] = Rt

    return out | {
        "color_l": color_l,
        "color_r": color_r,
        "color_aug_l": color_l.copy(),
        "color_aug_r": color_r.copy(),
        "grid": np.broadcast_to(grid[None], (batch_size, height, width, 2)).copy(),
        "K": np.broadcast_to(K[None], (batch_size, 4, 4)).copy(),
        "inv_K": np.broadcast_to(inv_K[None], (batch_size, 4, 4)).copy().astype(np.float32),
        "Rt_l": Rt_l,
        "Rt_r": Rt_r,
        "depth_gt_l": np.stack(depths).astype(np.float32),
        "depth_gt_r": np.stack(depths).astype(np.float32),
    }
