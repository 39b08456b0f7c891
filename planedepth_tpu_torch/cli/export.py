"""Serving export (``planedepth_tpu/cli/export.py``): the eval forward as a
``torch.export`` program.

Writes ``(image, grid) -> disp`` at a fixed size with ``torch.export.save``,
the interface of the JAX package's serialised artifact: ``image (B, H, W,
3)`` and ``grid (B, H, W, 2)`` float32 NHWC in, ``disp (B, H, W, 1)`` out,
the transposes inside the program, so a client feeds either artifact the
same arrays.

    python -m planedepth_tpu_torch.cli.export --load_weights_folder <run>/last_models \
        --height 384 --width 1280 --out planedepth.pt2

The model is the one ``cli/evaluate.py`` evaluates (``eval_model``: bf16
unless ``--no_bf16``, the checkpoint's meta and networks); without
``--load_weights_folder`` its weights are seeded random
(``models/factory.py:init_weights_``, seed ``--seed``), for shape and
serving checks.  The program runs without the model code: the disp head
and the head epilogue are the ``planedepth_tpu_torch::`` custom ops, which
``import planedepth_tpu_torch.ops`` registers::

    import torch, planedepth_tpu_torch.ops
    forward = torch.export.load("planedepth.pt2").module()
    disp = forward(image, grid)

It runs on the device it was exported on (the card by default).
"""
from __future__ import annotations

import copy
import os
import sys
from typing import Optional

import torch
import torch.nn as nn

from planedepth_tpu_torch.cli.evaluate import default_device, eval_model
from planedepth_tpu_torch.cli.options import args_to_config, build_parser, parse_with_explicit
from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.models.factory import init_weights_


class EvalForward(nn.Module):
    """NHWC ``(image, grid)`` -> NHWC ``disp`` through an eval-mode model."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        out = self.model(image.permute(0, 3, 1, 2).contiguous(),
                         grid.permute(0, 3, 1, 2).contiguous())
        return out["disp"].permute(0, 2, 3, 1)


def export_program(cfg: TrainConfig, model: nn.Module,
                   batch_size: int = 1) -> torch.export.ExportedProgram:
    """The eval forward of ``model`` (on its device) exported at
    ``cfg.data``'s size and ``batch_size`` images."""
    H, W = cfg.data.height, cfg.data.width
    dev = next(model.parameters()).device
    image = torch.zeros((batch_size, H, W, 3), device=dev)
    grid = torch.zeros((batch_size, H, W, 2), device=dev)
    # the program keeps weights of its own, which require no grad, so that
    # its outputs require none
    frozen = copy.deepcopy(model).eval().requires_grad_(False)
    program = torch.export.export(EvalForward(frozen), (image, grid))
    # functional inference IR, traced again: this drops what the decoder
    # computes beside disp (pi and the probability volume in eval)
    return program.run_decompositions({})


def export_forward(cfg: TrainConfig, model: nn.Module, out_path: str,
                   batch_size: int = 1) -> int:
    """Export the eval forward of ``model`` to ``out_path``; returns its bytes."""
    program = export_program(cfg, model, batch_size)
    # the zero inputs it was traced on are no part of the program (saved,
    # they would add 20 bytes a pixel of the batch)
    program.example_inputs = None
    torch.export.save(program, out_path)
    return os.path.getsize(out_path)


def main(argv=None, device: Optional[torch.device] = None) -> int:
    parser = build_parser()
    parser.add_argument("--out", type=str, default="planedepth.pt2")
    parser.add_argument("--export_batch", type=int, default=1)
    args, explicit = parse_with_explicit(parser, argv)
    if device is None:
        device = default_device("export")
    cfg, model = eval_model(args_to_config(args), explicit)
    if not cfg.load_weights_folder:
        # export with random init (for shape and serving checks)
        init_weights_(model, torch.Generator().manual_seed(cfg.seed))
    n = export_forward(cfg, model.to(device), args.out, args.export_batch)
    print(f"exported {args.out} ({n} bytes)")
    return n


if __name__ == "__main__":
    main(sys.argv[1:])
