"""KITTI calibration parsing and velodyne->depth projection
(``planedepth_tpu/data/kitti_utils.py``, a copy held to it by
``tests/test_torch_kitti.py``).

Host-side numpy utilities (reference kitti_utils.py:8-98).  The projection
reproduces the KITTI matlab convention (round - 1 indexing) and resolves
duplicate projected points by taking the minimum depth — implemented here
with a vectorized ``np.minimum.at`` scatter instead of the reference's
python loop over Counter duplicates, which is ~100x faster on full scans.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI calibration text file into str -> array/str."""
    data: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.asarray(
                    [float(v) for v in value.split()], dtype=np.float64
                )
            except ValueError:
                data[key] = value
    return data


def load_velodyne_points(filename: str) -> np.ndarray:
    """Load a KITTI velodyne .bin scan as (P, 4) homogeneous points."""
    points = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def velo_to_image_projection(calib_dir: str, cam: int = 2) -> tuple:
    """Build the velodyne->image projection matrix and image shape."""
    cam2cam = read_calib_file(
        os.path.join(calib_dir, "calib_cam_to_cam.txt")
    )
    velo2cam_raw = read_calib_file(
        os.path.join(calib_dir, "calib_velo_to_cam.txt")
    )
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_raw["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_raw["T"]

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ velo2cam
    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)  # (H, W)
    return P_velo2im, im_shape


def generate_depth_map(
    calib_dir: str, velo_filename: str, cam: int = 2, vel_depth: bool = False
) -> np.ndarray:
    """Project a velodyne scan to a sparse depth map (reference
    kitti_utils.py:46-98 semantics, vectorized duplicate handling)."""
    P_velo2im, im_shape = velo_to_image_projection(calib_dir, cam)
    H, W = int(im_shape[0]), int(im_shape[1])

    velo = load_velodyne_points(velo_filename)

    from planedepth_tpu_torch.data import native

    fast = native.velodyne_to_depth_native(
        velo, P_velo2im, H, W, use_x_as_depth=vel_depth
    )
    if fast is not None:
        return fast.astype(np.float64)

    velo = velo[velo[:, 0] >= 0]

    pts = (P_velo2im @ velo.T).T                     # (P, 3)
    z = pts[:, 2]
    u = np.round(pts[:, 0] / z) - 1                  # matlab-compatible index
    v = np.round(pts[:, 1] / z) - 1
    depth_vals = velo[:, 0] if vel_depth else z

    valid = (u >= 0) & (v >= 0) & (u < W) & (v < H)
    u = u[valid].astype(np.int64)
    v = v[valid].astype(np.int64)
    depth_vals = depth_vals[valid]

    depth = np.full((H, W), np.inf, dtype=np.float64)
    np.minimum.at(depth, (v, u), depth_vals)
    depth[np.isinf(depth)] = 0.0
    depth[depth < 0] = 0.0
    return depth


def resize_depth_nearest(depth: np.ndarray, out_hw) -> np.ndarray:
    """Nearest-neighbor resize of a sparse depth map to (H, W) — the
    reference uses skimage order=0 (kitti_dataset.py:79-80)."""
    H, W = depth.shape
    Ho, Wo = out_hw
    iy = np.clip(np.round(np.arange(Ho) * (H / Ho) + (H / Ho - 1) / 2), 0,
                 H - 1).astype(np.int64)
    ix = np.clip(np.round(np.arange(Wo) * (W / Wo) + (W / Wo - 1) / 2), 0,
                 W - 1).astype(np.int64)
    return depth[iy][:, ix]
