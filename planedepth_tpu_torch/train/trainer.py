"""Training orchestration (``planedepth_tpu/train/trainer.py``, reference trainer.py:45-913).

The epoch loop around ``make_train_step``: batches from the deterministic
sampler, throughput and scalar logging, validation with the best
``de/abs_rel`` kept, per-epoch checkpoints (``last_models``, ``best_models``),
the ``models_to_load`` restore that chains the three-stage recipe, and the
frozen self-distillation teacher, built from the student after the restore;
in the temporal recipes the pose networks train, save and restore beside the
depth model.  One card, one process; image panels are not ported (ROADMAP A7).
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Optional

import torch

import planedepth_tpu_torch
from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.data.loader import BatchLoader, EpochSampler
from planedepth_tpu_torch.train.state import fast_forward_schedule, make_optimizer
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    make_eval_step,
    make_train_step,
)
from planedepth_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_submodules,
    save_checkpoint,
)
from planedepth_tpu_torch.utils.logging import Logger, ThroughputMeter

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(planedepth_tpu_torch.__file__)))


class Trainer:
    """``Trainer(cfg, datasets=(train, val), device=None)``: ``train()`` runs
    the epochs.  Datasets follow the JAX package's protocol (``__len__`` and
    ``getitem(index, epoch)`` returning one NHWC numpy sample).  ``device``
    is the card unless the caller names another."""

    def __init__(self, cfg: TrainConfig, datasets=None,
                 device: Optional[torch.device] = None):
        if datasets is None:
            raise NotImplementedError(
                "the KITTI reader is not ported yet (ROADMAP 'Next' 1: data/kitti.py); "
                "pass datasets=(train, val)")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Trainer: CUDA is not available; pass "
                                   "device=torch.device('cpu') to run on the CPU")
            device = torch.device("cuda")
        self.cfg = cfg
        self.device = torch.device(device)
        self.log_path = os.path.join(cfg.log_dir, cfg.model_name)

        # data ---------------------------------------------------------------
        self.train_dataset, self.val_dataset = datasets
        b = cfg.per_step_batch
        self.train_loader = BatchLoader(
            self.train_dataset,
            EpochSampler(len(self.train_dataset), b, shuffle=True, seed=cfg.seed,
                         drop_last=True),
            num_workers=cfg.data.num_workers)
        self.val_loader = BatchLoader(
            self.val_dataset,
            EpochSampler(len(self.val_dataset), b, shuffle=False, seed=cfg.seed,
                         drop_last=False),
            num_workers=cfg.data.num_workers)
        self.steps_per_epoch = self.train_loader.sampler.steps_per_epoch()

        # models, optimizer, restore, teacher --------------------------------
        # Adam over the depth and pose networks together, as the JAX
        # package's one params tree holds them
        self.bundle = ModelBundle(cfg, self.device)
        self.optimizer, self.scheduler = make_optimizer(
            cfg, self.bundle.parameters(), self.steps_per_epoch)
        if cfg.load_weights_folder is not None:
            restore_submodules(self.bundle.model, load_checkpoint(cfg.load_weights_folder),
                               cfg.models_to_load, self.optimizer,
                               restore_optimizer=cfg.restore_optimizer,
                               pose_nets=self.pose_nets())
        if cfg.loss.self_distillation > 0:
            # the frozen teacher is the (just restored) student
            # (reference trainer.py:109-112)
            self.bundle.freeze_teacher()

        # resume fast-forward (reference trainer.py:242-244 replays the LR
        # scheduler): the step count, the schedule and the dropout seeds
        self.step_count = cfg.optim.start_epoch * self.steps_per_epoch
        if self.step_count:
            fast_forward_schedule(self.optimizer, self.scheduler, self.step_count)
        self.train_step = make_train_step(self.bundle, self.optimizer, self.scheduler,
                                          step=self.step_count)
        self.eval_step = make_eval_step(self.bundle)

        # logging ------------------------------------------------------------
        self.logger = Logger(self.log_path)
        self.logger.save_config(cfg.to_json())
        self._save_provenance()
        self.best_absrel = 10.0
        self.meter = ThroughputMeter(self.steps_per_epoch * cfg.optim.num_epochs,
                                     cfg.per_step_batch)

    # --- loops --------------------------------------------------------------
    def train(self) -> None:
        for epoch in range(self.cfg.optim.start_epoch, self.cfg.optim.num_epochs):
            self.run_epoch(epoch)
            self.save("last_models")

    def run_epoch(self, epoch: int) -> None:
        cfg = self.cfg
        for batch_idx, batch in enumerate(self.train_loader.epoch(epoch)):
            t0 = time.time()
            metrics = self.train_step(batch_to_tensors(batch, self.device))
            early = batch_idx % 100 == 0 and self.step_count < cfg.log_frequency
            if early or self.step_count % cfg.log_frequency == 0:
                line = self.meter.log_line(epoch, batch_idx, self.step_count,
                                           time.time() - t0, metrics["loss/total_loss"])
                print(line)
                self.logger.text(line)
                self.logger.scalars("train", metrics, self.step_count)
            self.step_count += 1
        self.val(epoch)

    def val(self, epoch: int) -> Dict[str, float]:
        """Validation over the val split (reference trainer.py:468-521):
        the batch-size-weighted mean of each metric; a new best
        ``de/abs_rel`` saves ``best_models``."""
        total: Dict[str, float] = {}
        n = 0
        for batch in self.val_loader.epoch(0):
            if "depth_gt_l" not in batch:
                continue
            metrics = self.eval_step(batch_to_tensors(batch, self.device))
            b = batch["color_l"].shape[0]
            n += b
            for k, v in metrics.items():
                total[k] = total.get(k, 0.0) + v * b
        if n == 0:
            return {}
        metrics = {k: v / n for k, v in total.items()}
        if metrics.get("de/abs_rel", 10.0) < self.best_absrel:
            self.best_absrel = metrics["de/abs_rel"]
            self.save("best_models")
        self.logger.scalars("val", metrics, self.step_count)
        self.logger.metric_row(metrics)
        return metrics

    # --- state --------------------------------------------------------------
    def pose_nets(self) -> Dict[str, torch.nn.Module]:
        """The pose networks by checkpoint name (none without temporal
        frames or under ``use_colmap``)."""
        return {k: v for k, v in self.bundle.nets().items() if k != "model"}

    def _save_provenance(self) -> None:
        """Run provenance: the package version, the trained networks with
        their parameter counts and, in a git checkout, the commit (the
        reference snapshots its source files, trainer.py:57-67)."""
        info = {"version": planedepth_tpu_torch.__version__,
                "networks": {name: sum(p.numel() for p in net.parameters())
                             for name, net in self.bundle.nets().items()}}
        try:
            git = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                                 text=True, cwd=REPO_DIR, timeout=30)
            if git.returncode == 0:
                info["git"] = git.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
        with open(os.path.join(self.log_path, "provenance.json"), "w") as f:
            json.dump(info, f, indent=2)

    def save(self, tag: str) -> str:
        return save_checkpoint(self.log_path, tag, self.bundle.model, self.optimizer,
                               config_json=self.cfg.to_json(),
                               height=self.cfg.data.height, width=self.cfg.data.width,
                               step=self.step_count, pose_nets=self.pose_nets())

    def close(self) -> None:
        self.logger.close()
