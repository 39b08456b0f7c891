"""Run logging (``planedepth_tpu/utils/logging.py``, reference trainer.py:174-184,812-867).

A ``logs.log`` text file, scalars and image panels to TensorBoard when
``tensorboardX`` imports, the ``examples/s`` console line with its ETA, the
7-metric validation row and the ``opt.json`` config dump.
"""
from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

METRIC_NAMES = ("de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms",
                "da/a1", "da/a2", "da/a3")


def sec_to_hm_str(t: float) -> str:
    """10239 -> '02h50m39s' (reference utils.py:45-62)."""
    t = int(t)
    return f"{t // 3600:02d}h{(t // 60) % 60:02d}m{t % 60:02d}s"


def normalize_image(x: np.ndarray) -> np.ndarray:
    """Rescale to [0, 1] for the panels (reference utils.py:36-42)."""
    ma, mi = float(np.max(x)), float(np.min(x))
    return (x - mi) / (ma - mi + 1e-5)


class Logger:
    """Text and TensorBoard logging of one run under ``log_path``.  A
    disabled logger (a rank other than 0) makes no directory, writer or
    file, and every call does nothing."""

    def __init__(self, log_path: str, enabled: bool = True):
        self.log_path = log_path
        self.enabled = enabled
        self.writers = {}
        self.log_file = None
        if not enabled:
            return
        os.makedirs(log_path, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self.writers = {mode: SummaryWriter(os.path.join(log_path, mode))
                            for mode in ("train", "val")}
        self.log_file = open(os.path.join(log_path, "logs.log"), "a")

    def scalars(self, mode: str, values: Dict[str, float], step: int) -> None:
        w = self.writers.get(mode)
        if w is not None:
            for k, v in values.items():
                w.add_scalar(k, float(v), step)

    def has_writer(self, mode: str) -> bool:
        return mode in self.writers

    def images(self, mode: str, images: Dict[str, np.ndarray], step: int) -> None:
        """``images``: name -> ``(H, W, C)`` float in [0, 1]."""
        w = self.writers.get(mode)
        if w is not None:
            for k, v in images.items():
                w.add_image(k, np.moveaxis(v, -1, 0), step)

    def text(self, line: str) -> None:
        if self.enabled:
            print(line, file=self.log_file, flush=True)

    def metric_row(self, metrics: Dict[str, float]) -> None:
        """LaTeX-ready 7-metric row (reference trainer.py:516-517)."""
        if not self.enabled:
            return
        header = "\n  " + ("{:>8} | " * 7).format(
            "abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
        row = ("&{: 8.4f}  " * 7).format(
            *[float(metrics[n]) for n in METRIC_NAMES]) + "\\\\"
        for line in (header, row):
            print(line)
            self.text(line)

    def save_config(self, config_json: str) -> None:
        if not self.enabled:
            return
        with open(os.path.join(self.log_path, "opt.json"), "w") as f:
            f.write(config_json)

    def close(self) -> None:
        for w in self.writers.values():
            w.close()
        if self.log_file is not None:
            self.log_file.close()


class ThroughputMeter:
    """examples/s and ETA console line (reference trainer.py:812-822)."""

    def __init__(self, total_steps: int, batch_size: int):
        self.total_steps = total_steps
        self.batch_size = batch_size
        self.start = time.time()

    def log_line(self, epoch: int, batch_idx: int, step: int,
                 duration: float, loss: float) -> str:
        sps = self.batch_size / max(duration, 1e-9)
        elapsed = time.time() - self.start
        left = (self.total_steps / max(step, 1) - 1.0) * elapsed if step > 0 else 0
        return (f"epoch {epoch:>3} | batch {batch_idx:>6} | "
                f"examples/s: {sps:5.1f} | loss: {loss:.5f} | "
                f"time elapsed: {sec_to_hm_str(elapsed)} | "
                f"time left: {sec_to_hm_str(left)}")
