"""Training CLI (reference train.py:14-21; ``planedepth_tpu/cli/train.py``).

    python -m planedepth_tpu_torch.cli.train --stage stage1 --data_path ./kitti_data --png
    python -m torch.distributed.run --nproc_per_node 4 -m planedepth_tpu_torch.cli.train \
        --stage stage1 --data_path ./kitti_data --png

Stage presets: ``--stage stage1|hr_finetune|self_distillation`` applies the
reference README recipe, then individual flags override.  The Trainer runs
on the card; ``main(argv, device=torch.device("cpu"))`` runs it on the CPU.
Under a launcher (the reference's ``torchrun --nproc_per_node=4``,
``train_ResNet.sh``) each rank joins the process group its environment
names before the Trainer is built and leaves it after; ``--batch_size`` is
then the global batch, shared by the data ranks.  ``--mesh_shape D S``
(``TrainConfig.mesh_shape``) lays the launcher's ``D S`` ranks out as a
``data x spatial`` mesh, each image's rows over the ``S`` ranks of a data
rank (``parallel/mesh.py``), for every recipe; the height a multiple of
``32 S`` (``64 S`` for FalNet and PladeNet):

    python -m torch.distributed.run --nproc_per_node 4 -m planedepth_tpu_torch.cli.train \
        --stage hr_finetune --data_path ./kitti_data --png --mesh_shape 2 2
"""
from __future__ import annotations

import sys
from typing import Optional

import torch
import torch.distributed as dist

from planedepth_tpu_torch.cli.options import (
    args_to_config,
    build_parser,
    parse_with_explicit,
)
from planedepth_tpu_torch.config import STAGE_PRESETS
from planedepth_tpu_torch.parallel.mesh import init_distributed
from planedepth_tpu_torch.train.trainer import Trainer


def main(argv=None, device: Optional[torch.device] = None) -> Trainer:
    """Parse ``argv``, train, and return the closed Trainer."""
    parser = build_parser()
    parser.add_argument("--stage", type=str, default=None,
                        choices=list(STAGE_PRESETS))
    parser.add_argument("--mesh_shape", type=int, nargs="+", default=None,
                        help="D S: image rows over the S ranks of each of D data ranks")
    args, explicit = parse_with_explicit(parser, argv)
    cfg = args_to_config(args, explicit=explicit, stage=args.stage)
    if args.mesh_shape is not None:
        cfg = cfg.replace(mesh_shape=tuple(args.mesh_shape))
    # append net_type to the run name (reference train.py:19)
    cfg = cfg.replace(model_name=f"{cfg.model_name}_{cfg.model.net_type}")
    joined = init_distributed(device)
    try:
        trainer = Trainer(cfg, device=device)
        trainer.train()
        trainer.close()
    finally:
        if joined:
            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
