"""Training orchestration (``planedepth_tpu/train/trainer.py``, reference trainer.py:45-913).

The epoch loop around ``make_train_step``: the split's KITTI datasets
(unless the caller hands in its own), batches from the deterministic
sampler, throughput and scalar logging, validation with the best
``de/abs_rel`` kept, per-epoch checkpoints (``last_models``, ``best_models``),
the converted ImageNet weights (``utils/pretrained.py``: a perceptual loss
on a random VGG raises unless ``allow_random_pc``), the ``models_to_load``
restore that chains the three-stage recipe, and the
frozen self-distillation teacher, built from the student after the restore;
in the temporal recipes the pose networks train, save and restore beside the
depth model; TensorBoard image panels (reference trainer.py:831-856: the
inputs, side 'r' synthesised by the oracle view synthesis in eval mode, and
the normalised disparity) on the epoch's first batch and every
``log_img_frequency`` steps, and on every ``log_img_frequency``-th
validation batch, when a writer exists.

Data parallel as the reference's ``torchrun`` runs it (JAX: the trainer's
mesh): each rank is a process with a card, its sampler's share of every
global batch (``data/loader.py``), the step under DDP with global BatchNorm
moments (``train/step.py``, ``parallel/mesh.py``) and validation on the
global batch, so that every rank decides ``best_models`` alike; rank 0
alone logs, writes the run's files and checkpoints and builds panels.  A
single process is the group of one.  The next batch's device copy overlaps
the current step (:func:`parallel.mesh.prefetch_to_device`), and the losses
are read to the host on log steps only.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

import planedepth_tpu_torch
from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.data.kitti import DATASETS, readlines, split_path
from planedepth_tpu_torch.data.loader import BatchLoader, EpochSampler
from planedepth_tpu_torch.parallel.mesh import (
    all_ranks,
    default_device,
    make_mesh,
    prefetch_to_device,
    replicate_state,
)
from planedepth_tpu_torch.train.state import fast_forward_schedule, make_optimizer
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    make_eval_step,
    make_train_step,
)
from planedepth_tpu_torch.train.view_synthesis import pred_novel_images
from planedepth_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_submodules,
    save_checkpoint,
)
from planedepth_tpu_torch.utils.logging import Logger, ThroughputMeter, normalize_image
from planedepth_tpu_torch.utils.pretrained import apply_pretrained, check_perceptual_weights

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(planedepth_tpu_torch.__file__)))


def split_datasets(cfg: TrainConfig):
    """The train and val datasets of ``cfg.data.split``'s ``train_files.txt``
    and ``val_files.txt`` (JAX ``train/trainer.py:72-92``): the train set
    augmented (the crop unless ``no_crop``, the ranges of ``cfg.data``,
    COLMAP poses under ``use_colmap``), the val set resized only."""
    ds_cls = DATASETS[cfg.data.dataset]
    img_ext = ".png" if cfg.data.png else ".jpg"
    train_files = readlines(split_path(cfg.data.split, "train"))
    val_files = readlines(split_path(cfg.data.split, "val"))
    train = ds_cls(cfg.data.data_path, train_files, cfg.data.height, cfg.data.width,
                   cfg.novel_frame_ids, is_train=True, use_crop=not cfg.data.no_crop,
                   use_colmap=cfg.data.use_colmap, colmap_path=cfg.data.colmap_path,
                   img_ext=img_ext, seed=cfg.seed, crop_factor=cfg.data.crop_factor,
                   gamma_range=cfg.data.gamma_range,
                   brightness_range=cfg.data.brightness_range,
                   color_range=cfg.data.color_range)
    val = ds_cls(cfg.data.data_path, val_files, cfg.data.height, cfg.data.width,
                 cfg.novel_frame_ids, is_train=False, use_crop=False, use_colmap=False,
                 img_ext=img_ext, seed=cfg.seed)
    return train, val


class Trainer:
    """``Trainer(cfg, datasets=None, device=None)``: ``train()`` runs the
    epochs.  Without ``datasets`` it reads the split's KITTI frames
    (:func:`split_datasets`); ``datasets=(train, val)`` follow the JAX
    package's protocol (``__len__`` and ``getitem(index, epoch)`` returning
    one NHWC numpy sample).  ``device`` is this rank's card
    (``cuda:LOCAL_RANK`` under a launcher) unless the caller names another.
    In a process group ``cfg.per_step_batch`` is the global batch, which
    the ranks share evenly."""

    def __init__(self, cfg: TrainConfig, datasets=None,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else default_device()
        self.rank, self.world = make_mesh()
        self.is_chief = self.rank == 0
        if cfg.per_step_batch % self.world:
            raise ValueError(f"per_step_batch {cfg.per_step_batch} must be divisible by "
                             f"the {self.world} ranks; set --batch_size accordingly")
        self.log_path = os.path.join(cfg.log_dir, cfg.model_name)

        # data: this rank's share of every global batch -------------------
        self.train_dataset, self.val_dataset = datasets or split_datasets(cfg)
        b = cfg.per_step_batch // self.world
        self.train_loader = BatchLoader(
            self.train_dataset,
            EpochSampler(len(self.train_dataset), b, self.world, self.rank, shuffle=True,
                         seed=cfg.seed, drop_last=True),
            num_workers=cfg.data.num_workers)
        self.val_loader = BatchLoader(
            self.val_dataset,
            EpochSampler(len(self.val_dataset), b, self.world, self.rank, shuffle=False,
                         seed=cfg.seed, drop_last=False),
            num_workers=cfg.data.num_workers)
        self.steps_per_epoch = self.train_loader.sampler.steps_per_epoch()

        # models, optimizer, restore, teacher --------------------------------
        # Adam over the depth and pose networks together, as the JAX
        # package's one params tree holds them
        self.bundle = ModelBundle(cfg, self.device)
        # ImageNet-pretrained encoders and the frozen perceptual net
        # (reference resnet_encoder.py:35, layers.py:381), before the restore
        loaded = apply_pretrained(cfg, self.bundle)
        check_perceptual_weights(cfg, loaded)
        if loaded:
            print(f"[pretrained] loaded: {', '.join(loaded)}")
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
        # rank 0's weights on every rank (the nets' DDP wrappers would
        # broadcast them too; the teacher has none)
        nets = list(self.bundle.nets().values())
        if self.bundle.teacher is not None:
            nets.append(self.bundle.teacher)
        replicate_state(nets)

        # resume fast-forward (reference trainer.py:242-244 replays the LR
        # scheduler): the step count, the schedule and the dropout seeds
        self.step_count = cfg.optim.start_epoch * self.steps_per_epoch
        if self.step_count:
            fast_forward_schedule(self.optimizer, self.scheduler, self.step_count)
        self.train_step = make_train_step(self.bundle, self.optimizer, self.scheduler,
                                          step=self.step_count)
        self.eval_step = make_eval_step(self.bundle)

        # logging: rank 0's ---------------------------------------------------
        self.logger = Logger(self.log_path, enabled=self.is_chief)
        if self.is_chief:
            self.logger.save_config(cfg.to_json())
            self._save_provenance()
        self.best_absrel = 10.0
        self._val_panel_step = 0
        self.meter = ThroughputMeter(self.steps_per_epoch * cfg.optim.num_epochs,
                                     cfg.per_step_batch)

    # --- loops --------------------------------------------------------------
    def train(self) -> None:
        for epoch in range(self.cfg.optim.start_epoch, self.cfg.optim.num_epochs):
            self.run_epoch(epoch)
            if self.is_chief:
                self.save("last_models")

    def device_batches(self, epoch: int):
        """``(host batch, device batch)`` of the epoch, this rank's share,
        the next batch's copy overlapping the current step (JAX
        ``trainer.py:_device_prefetch``)."""
        return prefetch_to_device(self.train_loader.epoch(epoch), self.device)

    @staticmethod
    def read_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The step's losses on the host: the one place a training step
        waits for the device, on log steps only."""
        return {k: float(v) for k, v in metrics.items()}

    def run_epoch(self, epoch: int) -> None:
        cfg = self.cfg
        for batch_idx, (batch, device_batch) in enumerate(self.device_batches(epoch)):
            t0 = time.time()
            metrics = self.train_step(device_batch)
            early = batch_idx % 100 == 0 and self.step_count < cfg.log_frequency
            if self.is_chief and (early or self.step_count % cfg.log_frequency == 0):
                values = self.read_metrics(metrics)
                line = self.meter.log_line(epoch, batch_idx, self.step_count,
                                           time.time() - t0, values["loss/total_loss"])
                print(line)
                self.logger.text(line)
                self.logger.scalars("train", values, self.step_count)
            # train panels every log_img_frequency steps (reference
            # trainer.py:316-320), and on the epoch's first batch
            if batch_idx == 0 or self.step_count % cfg.log_img_frequency == 0:
                self.log_images("train", batch)
            self.step_count += 1
        self.val(epoch)

    def val(self, epoch: int) -> Dict[str, float]:
        """Validation over the val split (reference trainer.py:468-521):
        the batch-size-weighted mean of each metric; a new best
        ``de/abs_rel`` saves ``best_models``.  Each step's metrics are the
        global batch's on every rank (the reference's ``all_reduce``,
        trainer.py:504-508), so the ranks' means, and their choice of
        ``best_models``, are alike."""
        total: Dict[str, float] = {}
        n = 0
        for batch_idx, batch in enumerate(self.val_loader.epoch(0)):
            if not all_ranks("depth_gt_l" in batch, self.device):
                continue
            metrics = self.eval_step(batch_to_tensors(batch, self.device))
            # val panels every log_img_frequency batches, on their own step
            # count (reference trainer.py:499-500)
            if batch_idx % self.cfg.log_img_frequency == 0:
                self.log_images("val", batch, step=self._val_panel_step)
                self._val_panel_step += 1
            b = batch["color_l"].shape[0]
            n += b
            for k, v in metrics.items():
                total[k] = total.get(k, 0.0) + v * b
        if n == 0:
            return {}
        metrics = {k: v / n for k, v in total.items()}
        if metrics.get("de/abs_rel", 10.0) < self.best_absrel:
            self.best_absrel = metrics["de/abs_rel"]
            if self.is_chief:
                self.save("best_models")
        self.logger.scalars("val", metrics, self.step_count)
        self.logger.metric_row(metrics)
        return metrics

    # --- panels -------------------------------------------------------------
    def panels(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Image panels of up to 4 samples of the NHWC numpy ``batch``: the
        stereo pair, side 'r' synthesised by ``pred_novel_images`` (where
        the recipe has that side) and the normalised disparity, each
        ``(H, W, 3)`` in [0, 1], from one eval-mode forward (JAX
        ``train/trainer.py:viz_step``)."""
        cfg = self.cfg
        tensors = batch_to_tensors(batch, self.device)
        color = "color_aug" if cfg.loss.match_aug else "color"
        model = self.bundle.model.eval()
        sides = tuple(s for s in cfg.target_sides if s == "r")
        with torch.inference_mode():
            out = model(tensors["color_aug_l"], tensors["grid"])
            rec = pred_novel_images(
                out, tensors[f"{color}_l"], sides, {s: tensors["Rt_r"] for s in sides},
                tensors["K"], tensors["inv_K"], warp_type=cfg.warp_type,
                use_mixture_loss=cfg.model.use_mixture_loss,
                render_probability=cfg.model.render_probability)
            hwc = lambda t: t.permute(0, 2, 3, 1).float().cpu().numpy()
            disp = hwc(out["disp"])
            pred = hwc(rec[("rgb_rec", "r")].clamp(0.0, 1.0)) if ("rgb_rec", "r") in rec else None
        images = {}
        for j in range(min(4, batch["color_l"].shape[0])):
            images[f"color_l/{j}"] = np.asarray(batch["color_l"][j])
            images[f"color_r/{j}"] = np.asarray(batch["color_r"][j])
            if pred is not None:
                images[f"color_pred_r/{j}"] = pred[j]
            images[f"disp/{j}"] = np.repeat(normalize_image(disp[j]), 3, axis=-1)
        return images

    def log_images(self, mode: str, batch: Dict[str, np.ndarray],
                   step: Optional[int] = None) -> None:
        """The panels of ``batch`` to the ``mode`` writer (reference
        trainer.py:831-856); without a writer (no ``tensorboardX``) nothing
        is computed (nor on ranks other than 0, whose logger has none)."""
        if self.logger.has_writer(mode):
            self.logger.images(mode, self.panels(batch),
                               self.step_count if step is None else step)

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
