"""Training CLI (reference train.py:14-21; ``planedepth_tpu/cli/train.py``).

    python -m planedepth_tpu_torch.cli.train --stage stage1 --data_path ./kitti_data --png

Stage presets: ``--stage stage1|hr_finetune|self_distillation`` applies the
reference README recipe, then individual flags override.  The Trainer runs
on the card; ``main(argv, device=torch.device("cpu"))`` runs it on the CPU.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from planedepth_tpu_torch.cli.options import (
    args_to_config,
    build_parser,
    parse_with_explicit,
)
from planedepth_tpu_torch.config import STAGE_PRESETS
from planedepth_tpu_torch.train.trainer import Trainer


def main(argv=None, device: Optional[torch.device] = None) -> Trainer:
    """Parse ``argv``, train, and return the closed Trainer."""
    parser = build_parser()
    parser.add_argument("--stage", type=str, default=None,
                        choices=list(STAGE_PRESETS))
    args, explicit = parse_with_explicit(parser, argv)
    cfg = args_to_config(args, explicit=explicit, stage=args.stage)
    # append net_type to the run name (reference train.py:19)
    cfg = cfg.replace(model_name=f"{cfg.model_name}_{cfg.model.net_type}")
    trainer = Trainer(cfg, device=device)
    trainer.train()
    trainer.close()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
