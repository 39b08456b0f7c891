"""Eigen-protocol metrics (``planedepth_tpu/eval/metrics.py``, reference evaluate_depth_HR.py:27-59).

A copy of the JAX package's numpy code, with one change: the resize of each
prediction to the GT size is ``data/image_io.py:resize_bilinear``, a numpy
copy of ``cv2.resize``'s bilinear rule, because OpenCV is not a dependency
of the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from planedepth_tpu_torch.data.image_io import resize_bilinear

MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0
STEREO_SCALE_FACTOR = 5.4
GARG_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, ...]:
    """The 7 standard metrics on flat positive arrays."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray) -> np.ndarray:
    """Flip post-processing: the plain mean (reference evaluate_depth_HR.py:51-59)."""
    return 0.5 * (l_disp + r_disp)


def evaluate_disparities(
    pred_disps: np.ndarray,
    gt_depths,
    pred_width: int,
    eval_split: str = "eigen_raw",
    stereo: bool = True,
    pred_depth_scale_factor: float = 1.0,
) -> Dict[str, float]:
    """KITTI Eigen evaluation: each ``(h, w)`` prediction is resized to its
    GT's ``(H_i, W_i)``; returns the 7 mean metrics (+ median-scaling stats
    when not ``stereo``)."""
    errors = []
    ratios = []
    scale = (STEREO_SCALE_FACTOR if stereo else pred_depth_scale_factor) or 1.0

    for i in range(pred_disps.shape[0]):
        gt_depth = np.asarray(gt_depths[i]).copy()
        gt_h, gt_w = gt_depth.shape[:2]
        disp = resize_bilinear(pred_disps[i], gt_h, gt_w)
        pred_depth = 0.1 * 0.58 * pred_width / disp

        if eval_split in ("eigen_raw", "eigen_improved"):
            gt_depth = np.clip(gt_depth, MIN_DEPTH, MAX_DEPTH)
            mask = (gt_depth > MIN_DEPTH) & (gt_depth < MAX_DEPTH)
            crop = np.array(
                [GARG_CROP[0] * gt_h, GARG_CROP[1] * gt_h,
                 GARG_CROP[2] * gt_w, GARG_CROP[3] * gt_w]
            ).astype(np.int32)
            crop_mask = np.zeros_like(mask)
            crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = True
            mask = mask & crop_mask
        else:
            mask = gt_depth > 0

        pred_depth = pred_depth[mask]
        gt = gt_depth[mask]

        pred_depth = pred_depth * scale
        if not stereo:
            ratio = np.median(gt) / np.median(pred_depth)
            ratios.append(ratio)
            pred_depth *= ratio

        pred_depth = np.clip(pred_depth, MIN_DEPTH, MAX_DEPTH)
        errors.append(compute_errors(gt, pred_depth))

    mean = np.array(errors).mean(0)
    out = dict(zip(
        ["abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"],
        [float(v) for v in mean],
    ))
    if ratios:
        r = np.array(ratios)
        out["ratio_med"] = float(np.median(r))
        out["ratio_std"] = float(np.std(r / np.median(r)))
    return out
