"""Batched prediction (``planedepth_tpu/eval/evaluator.py:predict_split_disparities``).

The KITTI file reader is not ported yet (ROADMAP); callers hand in batches
as ``planedepth_tpu_torch/data/synthetic.py`` makes them.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Tuple

import numpy as np
import torch

from planedepth_tpu_torch.eval.metrics import batch_post_process_disparity


def mirror_batch(image: torch.Tensor, grid: torch.Tensor):
    """Double an NCHW batch with its mirror image: W flipped, and the grid
    flipped with its x channel negated (``evaluator.py:61-65``)."""
    flipped = grid.flip(-1)
    flipped = torch.cat([-flipped[:, :1], flipped[:, 1:]], dim=1)
    return (torch.cat([image, image.flip(-1)]).contiguous(),
            torch.cat([grid, flipped]).contiguous())


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
