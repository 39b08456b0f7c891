"""CLI flag surface (reference options.py:17-293) -> TrainConfig
(``planedepth_tpu/cli/options.py``, a copy held to it by
``tests/test_torch_cli.py``).

Keeps the reference's flag NAMES so existing run scripts translate 1:1,
but parses into the typed frozen config instead of a mutable namespace.
Deliberately NOT reproduced: the reference's dead/broken flags
(--scheduler_step_size, --avg_reprojection, --stage1_weights_folder are
parsed there but never read; --num_ep's help text is wrong).

The JAX package's flags of TPU layout and TPU-only samplers
(``--fused_head``, ``--s2d_tail``, ``--rowshift_warp``) are not here, so
argparse refuses them by name: the port has no such fields (``config.py``).
``--no_bf16`` (float32 networks and kernels), ``--warp_sample_bf16`` and the
two memory trades ``--remat`` (``model.remat``: the depth encoder's residual
blocks recomputed in the backward pass) and ``--remat_warp`` (``remat_warp``:
the oracle route's view synthesis and losses recomputed) map as in the JAX
package.
"""
from __future__ import annotations

import argparse

from planedepth_tpu_torch.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("PlaneDepth-TPU (PyTorch/CUDA)")
    # paths
    p.add_argument("--data_path", type=str, default="./kitti_data")
    p.add_argument("--log_dir", type=str, default="./log")
    p.add_argument("--model_name", type=str, default="planedepth")
    # training
    p.add_argument("--split", type=str, default="eigen_full_left")
    p.add_argument("--dataset", type=str, default="kitti")
    p.add_argument("--png", action="store_true")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--num_layers", type=int, default=50)
    p.add_argument("--net_type", type=str, default="ResNet",
                   choices=["ResNet", "PladeNet", "FalNet"])
    p.add_argument("--warp_type", type=str, default="disp_warp",
                   choices=["depth_warp", "disp_warp", "homography_warp"])
    p.add_argument("--novel_frame_ids", nargs="*", type=int, default=[])
    p.add_argument("--no_stereo", action="store_true")
    p.add_argument("--no_crop", action="store_true")
    # planes
    p.add_argument("--disp_levels", type=int, default=49)
    p.add_argument("--disp_min", type=float, default=2.0)
    p.add_argument("--disp_max", type=float, default=300.0)
    p.add_argument("--xz_levels", type=int, default=14)
    p.add_argument("--yz_levels", type=int, default=0)
    # model features
    p.add_argument("--num_ep", type=int, default=8)
    p.add_argument("--pe_type", type=str, default="neural",
                   choices=["neural", "frequency"])
    p.add_argument("--use_denseaspp", action="store_true")
    p.add_argument("--use_mixture_loss", action="store_true")
    p.add_argument("--plane_residual", action="store_true")
    p.add_argument("--render_probability", action="store_true")
    p.add_argument("--flip_right", action="store_true")
    p.add_argument("--use_mom", action="store_true")
    # losses
    p.add_argument("--alpha_smooth", type=float, default=0.04)
    p.add_argument("--gamma_smooth", type=float, default=2.0)
    p.add_argument("--alpha_pc", type=float, default=0.1)
    p.add_argument("--alpha_self", type=float, default=0.0)
    p.add_argument("--self_distillation", type=float, default=0.0)
    p.add_argument("--automask", action="store_true")
    p.add_argument("--use_ssim", action="store_true")
    p.add_argument("--match_aug", action="store_true")
    p.add_argument("--pc_net", type=str, default="vgg19",
                   choices=["vgg19", "resnet18"])
    # colmap
    p.add_argument("--use_colmap", action="store_true")
    p.add_argument("--colmap_path", type=str, default="./kitti_colmap")
    # optimization
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--beta_1", type=float, default=0.5)
    p.add_argument("--beta_2", type=float, default=0.999)
    p.add_argument("--num_epochs", type=int, default=50)
    p.add_argument("--milestones", nargs="*", type=int, default=[30, 40])
    p.add_argument("--start_epoch", type=int, default=0)
    # system
    p.add_argument("--num_workers", type=int, default=12)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--no_bf16", action="store_true",
                   help="float32 networks and kernels (default: bf16, as the JAX package)")
    # performance
    p.add_argument("--warp_sample_bf16", action="store_true",
                   help="sample the warped plane stacks in bfloat16")
    p.add_argument("--fused_sweep", action="store_true",
                   help="fused plane sweep kernels for the stereo hot path")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize encoder residual blocks")
    p.add_argument("--remat_warp", action="store_true",
                   help="rematerialize the view-synthesis + loss segment")
    # loading
    p.add_argument("--load_weights_folder", type=str, default=None)
    p.add_argument("--models_to_load", nargs="+", type=str,
                   default=["encoder", "depth"])
    p.add_argument("--no_restore_optimizer", action="store_true",
                   help="do NOT restore the Adam state from the checkpoint")
    p.add_argument("--weights_dir", type=str, default=None,
                   help="directory of converted ImageNet npz weights "
                        "(scripts/convert_torch_weights.py)")
    p.add_argument("--allow_random_pc", action="store_true",
                   help="allow alpha_pc > 0 with a RANDOM perceptual net")
    # logging
    p.add_argument("--log_frequency", type=int, default=500)
    p.add_argument("--log_img_frequency", type=int, default=250)
    # eval
    p.add_argument("--eval_split", type=str, default="eigen_raw")
    p.add_argument("--eval_stereo", action="store_true")
    p.add_argument("--eval_mono", action="store_true")
    p.add_argument("--post_process", action="store_true")
    p.add_argument("--save_pred_disps", action="store_true")
    p.add_argument("--ext_disp_to_eval", type=str, default=None)
    p.add_argument("--eval_eigen_to_benchmark", action="store_true")
    p.add_argument("--no_eval", action="store_true")
    return p


# dest -> (config section, field, value transform); section None = TrainConfig.
# The flags without a counterpart in the port's config are not here.
_IDENT = lambda v: v  # noqa: E731
_FLAG_MAP = {
    "model_name": (None, "model_name", _IDENT),
    "log_dir": (None, "log_dir", _IDENT),
    "batch_size": (None, "batch_size", _IDENT),
    "seed": (None, "seed", _IDENT),
    "warp_type": (None, "warp_type", _IDENT),
    "novel_frame_ids": (None, "novel_frame_ids", tuple),
    "no_stereo": (None, "no_stereo", _IDENT),
    "flip_right": (None, "flip_right", _IDENT),
    "load_weights_folder": (None, "load_weights_folder", _IDENT),
    "models_to_load": (None, "models_to_load", tuple),
    "no_restore_optimizer": (None, "restore_optimizer", lambda v: not v),
    "weights_dir": (None, "weights_dir", _IDENT),
    "allow_random_pc": (None, "allow_random_pc", _IDENT),
    "log_frequency": (None, "log_frequency", _IDENT),
    "log_img_frequency": (None, "log_img_frequency", _IDENT),
    "fused_sweep": (None, "fused_sweep", _IDENT),
    "no_bf16": (None, "bf16", lambda v: not v),
    "warp_sample_bf16": (None, "warp_sample_bf16", _IDENT),
    "remat_warp": (None, "remat_warp", _IDENT),
    "net_type": ("model", "net_type", _IDENT),
    "num_layers": ("model", "num_layers", _IDENT),
    "num_ep": ("model", "num_ep", _IDENT),
    "pe_type": ("model", "pe_type", _IDENT),
    "use_denseaspp": ("model", "use_denseaspp", _IDENT),
    "use_mixture_loss": ("model", "use_mixture_loss", _IDENT),
    "plane_residual": ("model", "plane_residual", _IDENT),
    "render_probability": ("model", "render_probability", _IDENT),
    "remat": ("model", "remat", _IDENT),
    "disp_levels": ("planes", "disp_levels", _IDENT),
    "disp_min": ("planes", "disp_min", _IDENT),
    "disp_max": ("planes", "disp_max", _IDENT),
    "xz_levels": ("planes", "xz_levels", _IDENT),
    "yz_levels": ("planes", "yz_levels", _IDENT),
    "alpha_smooth": ("loss", "alpha_smooth", _IDENT),
    "gamma_smooth": ("loss", "gamma_smooth", _IDENT),
    "alpha_pc": ("loss", "alpha_pc", _IDENT),
    "alpha_self": ("loss", "alpha_self", _IDENT),
    "self_distillation": ("loss", "self_distillation", _IDENT),
    "automask": ("loss", "automask", _IDENT),
    "use_ssim": ("loss", "use_ssim", _IDENT),
    "match_aug": ("loss", "match_aug", _IDENT),
    "pc_net": ("loss", "pc_net", _IDENT),
    "use_mom": ("loss", "use_mom", _IDENT),
    "data_path": ("data", "data_path", _IDENT),
    "dataset": ("data", "dataset", _IDENT),
    "split": ("data", "split", _IDENT),
    "height": ("data", "height", _IDENT),
    "width": ("data", "width", _IDENT),
    "png": ("data", "png", _IDENT),
    "no_crop": ("data", "no_crop", _IDENT),
    "use_colmap": ("data", "use_colmap", _IDENT),
    "colmap_path": ("data", "colmap_path", _IDENT),
    "num_workers": ("data", "num_workers", _IDENT),
    "learning_rate": ("optim", "learning_rate", _IDENT),
    "beta_1": ("optim", "beta_1", _IDENT),
    "beta_2": ("optim", "beta_2", _IDENT),
    "num_epochs": ("optim", "num_epochs", _IDENT),
    "milestones": ("optim", "milestones", tuple),
    "start_epoch": ("optim", "start_epoch", _IDENT),
}


def parse_with_explicit(parser: argparse.ArgumentParser, argv):
    """Parse argv twice: once normally, once with all defaults suppressed to
    learn WHICH flags were explicitly passed (needed so ``--stage`` presets
    can be overridden per-flag, reference README.md:36-90 stage recipes)."""
    saved = [(a, a.default) for a in parser._actions]
    for a in parser._actions:
        a.default = argparse.SUPPRESS
    try:
        explicit = set(vars(parser.parse_args(argv)))
    finally:
        for a, d in saved:
            a.default = d
    return parser.parse_args(argv), explicit


def _apply_overrides(cfg: TrainConfig, a: argparse.Namespace, dests):
    """Apply the flags named in ``dests`` onto ``cfg``."""
    import dataclasses as dc

    sections = {"model": {}, "planes": {}, "loss": {}, "data": {},
                "optim": {}, None: {}}
    for dest in dests:
        if dest not in _FLAG_MAP:
            continue
        section, field, tf = _FLAG_MAP[dest]
        sections[section][field] = tf(getattr(a, dest))
    if sections["planes"]:
        sections["model"]["planes"] = dc.replace(
            cfg.model.planes, **sections["planes"]
        )
    kw = dict(sections[None])
    if sections["model"]:
        kw["model"] = dc.replace(cfg.model, **sections["model"])
    if sections["loss"]:
        kw["loss"] = dc.replace(cfg.loss, **sections["loss"])
    if sections["data"]:
        kw["data"] = dc.replace(cfg.data, **sections["data"])
    if sections["optim"]:
        kw["optim"] = dc.replace(cfg.optim, **sections["optim"])
    return cfg.replace(**kw) if kw else cfg


def args_to_config(
    a: argparse.Namespace, explicit=None, stage: str = None
) -> TrainConfig:
    """Namespace -> TrainConfig.

    Without ``stage``: every flag applies (argparse defaults included).
    With ``stage``: start from the preset (reference README recipe) and
    apply only the explicitly-passed flags on top.
    """
    if stage is not None:
        from planedepth_tpu_torch.config import STAGE_PRESETS

        cfg = STAGE_PRESETS[stage]()
        if explicit is None:
            explicit = set()
        return _apply_overrides(cfg, a, sorted(explicit & set(_FLAG_MAP)))
    return _apply_overrides(TrainConfig(), a, sorted(_FLAG_MAP))
