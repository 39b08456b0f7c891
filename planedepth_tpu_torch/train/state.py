"""Optimizer and LR schedule (``planedepth_tpu/train/state.py``, reference
trainer.py:96-104).

``torch.optim.Adam`` with eps 1e-8 makes the same update as ``optax.adam``;
the MultiStepLR is stepped once per optimizer step with the milestones in
steps (epoch milestones x ``steps_per_epoch``), which is ``multistep_lr``'s
``piecewise_constant_schedule``: step t runs at lr x gamma^(milestones <= t).
``fast_forward_schedule`` moves the schedule to a resumed run's step.
"""
from __future__ import annotations

import bisect
from typing import Iterable, Tuple

import torch

from planedepth_tpu_torch.config import TrainConfig


def make_optimizer(cfg: TrainConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.MultiStepLR]:
    """Adam(beta_1, beta_2) and its per-step MultiStepLR."""
    o = cfg.optim
    optimizer = torch.optim.Adam(params, lr=o.learning_rate,
                                 betas=(o.beta_1, o.beta_2), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[int(m) * steps_per_epoch for m in o.milestones],
        gamma=o.lr_gamma)
    return optimizer, scheduler


def fast_forward_schedule(optimizer: torch.optim.Optimizer,
                          scheduler: torch.optim.lr_scheduler.MultiStepLR,
                          step: int) -> None:
    """Advance the LR schedule to optimizer step ``step`` without touching
    Adam's moments (``planedepth_tpu/train/state.py:fast_forward_schedule``;
    the reference replays MultiStepLR ``start_epoch`` times on resume,
    trainer.py:243-244): the next step runs at the LR the schedule gives step
    ``step``, as ``step`` scheduler steps would leave it."""
    passed = bisect.bisect_right(sorted(scheduler.milestones.elements()), step)
    for group, base in zip(optimizer.param_groups, scheduler.base_lrs):
        group["lr"] = base * scheduler.gamma ** passed
    scheduler.last_epoch = step
