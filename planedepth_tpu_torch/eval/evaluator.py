"""Split evaluation (``planedepth_tpu/eval/evaluator.py``, reference evaluate_depth_HR.py:62-284).

Runs the model over a test split's KITTI frames at its train resolution,
optionally flip post-processes, and scores against ``gt_depths.npz`` with
the Eigen protocol (``eval/metrics.py``).  Also saves the disparities as
``.npy``, evaluates external disparity files (with the eigen -> benchmark
id remap) and writes the KITTI benchmark's 16-bit PNGs, through
``data/image_io.py`` in place of OpenCV.  The forward runs where the model
lies: on the card, unless the caller built it on the CPU.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.data.image_io import resize_bilinear, write_png
from planedepth_tpu_torch.data.kitti import DATASETS, readlines, split_path
from planedepth_tpu_torch.data.loader import BatchLoader, EpochSampler
from planedepth_tpu_torch.eval.metrics import (
    STEREO_SCALE_FACTOR,
    batch_post_process_disparity,
    evaluate_disparities,
)
from planedepth_tpu_torch.train.flip import flip_grid, flip_w

SPLITS_DIR = os.path.dirname(os.path.dirname(split_path("x", "test")))
BENCHMARK_SIZE = (1216, 352)          # (W, H) of the KITTI depth benchmark


def mirror_batch(image: torch.Tensor, grid: torch.Tensor):
    """Double an NCHW batch with its mirror image: W flipped, and the grid
    flipped with its x channel negated (``evaluator.py:61-65``)."""
    return (torch.cat([image, flip_w(image)]).contiguous(),
            torch.cat([grid, flip_grid(grid)]).contiguous())


def predict_disparities(
    model: torch.nn.Module,
    batches: Iterable[Mapping[str, np.ndarray]],
    post_process: bool,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Forward ``model`` over batches with NHWC numpy ``color_l`` (B, H, W, 3)
    and ``grid`` (B, H, W, 2), returning ``(num, H, W)`` disparities and the
    per-image mean over pixels of the largest plane probability.

    With ``post_process`` each batch is doubled by :func:`mirror_batch` and
    the two disparities are averaged.
    """
    model.eval()
    disps, prob_max = [], []
    with torch.inference_mode():
        for batch in batches:
            image = torch.from_numpy(batch["color_l"]).to(device).permute(0, 3, 1, 2)
            grid = torch.from_numpy(batch["grid"]).to(device).permute(0, 3, 1, 2)
            if post_process:
                image, grid = mirror_batch(image, grid)
            out = model(image.contiguous(), grid.contiguous())
            disp = out["disp"][:, 0].cpu().numpy()
            if post_process:
                n = disp.shape[0] // 2
                disp = batch_post_process_disparity(disp[:n], disp[n:, :, ::-1])
            disps.append(disp)
            pmax = out["probability"].amax(dim=1).mean(dim=(-2, -1))
            prob_max.append(pmax[: disp.shape[0]].cpu().numpy())
    return np.concatenate(disps), np.concatenate(prob_max)


def predict_split_disparities(
    model: torch.nn.Module,
    cfg: TrainConfig,
    filenames,
    batch_size: int = 4,
    post_process: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Forward the model over a file list of ``cfg.data.dataset`` under
    ``cfg.data.data_path`` (eval preprocessing: the bicubic resize to the
    train size, no crop), in batches of ``batch_size`` padded cyclically to
    a whole batch; returns ``(num, H, W)`` disparities and the prob-max."""
    dataset = DATASETS[cfg.data.dataset](
        cfg.data.data_path, filenames, cfg.data.height, cfg.data.width,
        novel_frame_ids=(), is_train=False, use_crop=False,
        img_ext=".png" if cfg.data.png else ".jpg")
    sampler = EpochSampler(len(dataset), batch_size, shuffle=False, drop_last=False)
    loader = BatchLoader(dataset, sampler, num_workers=cfg.data.num_workers)
    device = next(model.parameters()).device
    return predict_disparities(model, loader.epoch(0), post_process, device)


def write_benchmark_pngs(pred_disps: np.ndarray, out_dir: str) -> None:
    """The KITTI benchmark's 16-bit depth PNGs, bit-faithful to the
    reference (evaluate_depth_HR.py:200-208), including its raw
    ``STEREO_SCALE_FACTOR / disp`` WITHOUT the 0.1*0.58*W disparity law
    used everywhere else (a reference quirk kept for submission parity; do
    not "fix" it to disp_to_depth here)."""
    os.makedirs(out_dir, exist_ok=True)
    width, height = BENCHMARK_SIZE
    for idx in range(len(pred_disps)):
        disp = resize_bilinear(pred_disps[idx], height, width)
        depth = np.clip(STEREO_SCALE_FACTOR / disp, 0, 80)
        write_png(os.path.join(out_dir, f"{idx:010d}.png"), np.uint16(depth * 256))


def evaluate(
    cfg: TrainConfig,
    model: Optional[torch.nn.Module],
    eval_split: str = "eigen_raw",
    post_process: bool = False,
    batch_size: int = 4,
    save_pred_disps: Optional[str] = None,
    ext_disp_to_eval: Optional[str] = None,
    eval_eigen_to_benchmark: bool = False,
    splits_dir: Optional[str] = None,
) -> Dict[str, float]:
    """End-to-end split evaluation (reference evaluate_depth_HR.py:62-279).

    The test list is the repository's ``splits/<eval_split>/test_files.txt``;
    ``gt_depths.npz`` and the benchmark remap are read under ``splits_dir``
    (the repository's ``splits/`` unless given).  With ``ext_disp_to_eval``
    the disparities come from that ``.npy`` file and ``model`` is not used.
    The ``benchmark`` split writes its PNGs into ``save_pred_disps`` (or
    ``benchmark_predictions``) and returns ``{}``.
    """
    splits_dir = splits_dir or SPLITS_DIR

    if ext_disp_to_eval is None:
        filenames = readlines(split_path(eval_split, "test"))
        pred_disps, _ = predict_split_disparities(
            model, cfg, filenames, batch_size=batch_size, post_process=post_process)
        pred_disps = pred_disps[:len(filenames)]
    else:
        pred_disps = np.load(ext_disp_to_eval)
        if eval_eigen_to_benchmark:
            remap = np.load(os.path.join(splits_dir, "benchmark", "eigen_to_benchmark_ids.npy"))
            pred_disps = pred_disps[remap]

    if save_pred_disps:
        np.save(save_pred_disps, pred_disps)

    if eval_split == "benchmark":
        write_benchmark_pngs(pred_disps, save_pred_disps or "benchmark_predictions")
        return {}

    gt_path = os.path.join(splits_dir, eval_split, "gt_depths.npz")
    gt_depths = np.load(gt_path, fix_imports=True, encoding="latin1",
                        allow_pickle=True)["data"]
    return evaluate_disparities(pred_disps, gt_depths, cfg.data.width,
                                eval_split=eval_split, stereo=not cfg.no_stereo)
