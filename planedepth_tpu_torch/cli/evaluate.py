"""Evaluation CLI (reference evaluate_depth_HR.py:282-284, eval.sh;
``planedepth_tpu/cli/evaluate.py``).

    python -m planedepth_tpu_torch.cli.evaluate --eval_stereo --eval_split eigen_raw \
        --post_process --png --data_path ./kitti_data --load_weights_folder <run>/last_models

Resolution + network configuration are read from the checkpoint's
``.meta.json`` / the run's ``opt.json`` when the corresponding flags are not
explicitly passed (the reference embeds height/width in ``encoder.pth`` and
the evaluator reads them, trainer.py:879-882 / evaluate_depth_HR.py:98-106).

Two parts, which :func:`main` runs in turn: :func:`load` parses the flags,
adopts the checkpoint's meta and restores its networks into a model on the
card (or on ``device``); then one call to ``eval/evaluator.py:evaluate``
with :func:`evaluate_kwargs`.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional, Tuple

import torch

from planedepth_tpu_torch.cli.options import (
    args_to_config,
    build_parser,
    parse_with_explicit,
)
from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.eval.evaluator import evaluate
from planedepth_tpu_torch.models.factory import build_depth_model
from planedepth_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_checkpoint_meta,
    network_names,
    restore_submodules,
)

METRICS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")

# model flags: if ANY is explicitly passed, the CLI's model config wins
# wholesale (mixing saved + CLI model fields would be ambiguous)
_MODEL_DESTS = frozenset({
    "net_type", "num_layers", "num_ep", "pe_type", "use_denseaspp",
    "use_mixture_loss", "plane_residual", "render_probability",
    "disp_levels", "disp_min", "disp_max", "xz_levels", "yz_levels",
})


def apply_checkpoint_meta(cfg, meta, explicit):
    """Adopt the checkpoint's train resolution + model config for every
    field the user did not explicitly set."""
    if not meta:
        return cfg
    saved = meta.get("config")
    if saved and not (_MODEL_DESTS & explicit):
        cfg = cfg.replace(model=TrainConfig.from_dict(saved).model)
    data_kw = {}
    if meta.get("height") and "height" not in explicit:
        data_kw["height"] = int(meta["height"])
    if meta.get("width") and "width" not in explicit:
        data_kw["width"] = int(meta["width"])
    if data_kw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **data_kw))
    return cfg


def load(argv=None, device: Optional[torch.device] = None
         ) -> Tuple[object, TrainConfig, Optional[torch.nn.Module]]:
    """Parse ``argv``; with ``--load_weights_folder``, adopt its meta and
    restore every network of the model from it.  Returns ``(args, cfg,
    model)``; ``model`` is None without a checkpoint."""
    args, explicit = parse_with_explicit(build_parser(), argv)
    if args.eval_mono == args.eval_stereo:
        raise ValueError("choose exactly one of --eval_mono / --eval_stereo")
    cfg = args_to_config(args)
    if not cfg.load_weights_folder:
        return args, cfg, None
    if device is None:
        device = default_device("evaluate")
    cfg, model = eval_model(cfg, explicit)
    return args, cfg, model.to(device)


def eval_model(cfg: TrainConfig, explicit=frozenset()) -> Tuple[TrainConfig, torch.nn.Module]:
    """``(cfg, model)``: the eval forward's model on the CPU, in eval mode.
    With ``cfg.load_weights_folder`` the checkpoint's meta is adopted for
    every flag not in ``explicit`` and every network is restored from it;
    without, the networks keep the weights they were built with."""
    if cfg.load_weights_folder:
        cfg = apply_checkpoint_meta(cfg, load_checkpoint_meta(cfg.load_weights_folder),
                                    explicit)
    # the decoder emits disp outside the fused training step; bf16
    # convolutions unless --no_bf16, as the JAX evaluator's ModelBundle(cfg)
    model = build_depth_model(dataclasses.replace(cfg.model, fused_sweep_loss=False),
                              cfg.bf16)
    if cfg.load_weights_folder:
        restore_submodules(model, load_checkpoint(cfg.load_weights_folder),
                           network_names(model))
    return cfg, model.eval()


def default_device(entry: str) -> torch.device:
    """The card, or a ``RuntimeError`` naming ``entry`` where CUDA is absent."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{entry}: CUDA is not available; pass "
                           f"device=torch.device('cpu') to run on the CPU")
    return torch.device("cuda")


def evaluate_kwargs(args) -> Dict:
    """The keyword arguments of ``evaluate`` that the flags set."""
    return dict(
        eval_split=args.eval_split,
        post_process=args.post_process,
        save_pred_disps=(f"disps_{args.eval_split}_split.npy" if args.save_pred_disps
                         else None),
        ext_disp_to_eval=args.ext_disp_to_eval,
        eval_eigen_to_benchmark=args.eval_eigen_to_benchmark,
    )


def metric_lines(metrics: Dict[str, float]) -> Tuple[str, str]:
    """The reference's header and LaTeX row of the seven metrics."""
    header = "\n  " + ("{:>8} | " * 7).format(*METRICS)
    row = ("&{: 8.5f}  " * 7).format(*[metrics[k] for k in METRICS]) + "\\\\"
    return header, row


def main(argv=None, device: Optional[torch.device] = None) -> Dict[str, float]:
    args, cfg, model = load(argv, device)
    metrics = evaluate(cfg, model, **evaluate_kwargs(args))
    if metrics:                 # the benchmark split writes PNGs and scores nothing
        for line in metric_lines(metrics):
            print(line)
    print("\n-> Done!")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
