"""Ground-truth exporters (reference splits/eigen_raw/export_gt_depth.py:22-61
and splits/eigen_improved/prepare_groundtruth.py:22-49;
``planedepth_tpu/eval/export_gt.py``, a copy that reads the 16-bit PNGs
through ``data/image_io.py`` in place of PIL).

Write ``gt_depths.npz`` for a test split: eigen_raw projects velodyne scans;
eigen_improved reads the official annotated depth PNGs (note the reference
divides by 255, not 256 — reproduced for score parity).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from planedepth_tpu_torch.data.image_io import read_png
from planedepth_tpu_torch.data.kitti import SIDE_MAP, readlines
from planedepth_tpu_torch.data.kitti_utils import generate_depth_map


def export_eigen_raw_gt(
    data_path: str, split_dir: str, out_path: str = None
) -> str:
    """velodyne -> gt_depths.npz for the eigen_raw test list."""
    lines = readlines(os.path.join(split_dir, "test_files.txt"))
    gt_depths: List[np.ndarray] = []
    for line in lines:
        folder, frame_id, side = line.split()
        calib_dir = os.path.join(data_path, folder.split("/")[0])
        velo = os.path.join(
            data_path, folder,
            f"velodyne_points/data/{int(frame_id):010d}.bin",
        )
        gt = generate_depth_map(calib_dir, velo, SIDE_MAP[side], True)
        gt_depths.append(gt.astype(np.float32))
    out_path = out_path or os.path.join(split_dir, "gt_depths.npz")
    np.savez_compressed(out_path, data=np.array(gt_depths, dtype=object))
    return out_path


def export_eigen_improved_gt(
    kitti_depth_path: str, split_dir: str, out_path: str = None
) -> str:
    """Official annotated depth maps -> gt_depths.npz (note /255 as in the
    reference prepare_groundtruth.py:46 — NOT the KITTI-standard /256)."""
    lines = readlines(os.path.join(split_dir, "test_files.txt"))
    gt_depths: List[np.ndarray] = []
    for line in lines:
        folder, frame_id, side = line.split()
        date, drive = folder.split("/")
        png = os.path.join(
            kitti_depth_path, drive, "proj_depth", "groundtruth",
            f"image_0{SIDE_MAP[side]}", f"{int(frame_id):010d}.png",
        )
        gt = read_png(png).astype(np.float32) / 255.0
        gt_depths.append(gt)
    out_path = out_path or os.path.join(split_dir, "gt_depths.npz")
    np.savez_compressed(out_path, data=np.array(gt_depths, dtype=object))
    return out_path
