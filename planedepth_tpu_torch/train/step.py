"""The stereo training and validation steps (``planedepth_tpu/train/step.py``).

One ``train_step`` call is the reference's per-batch work for the stereo
recipes (trainer.py:278-356): flip_right batch doubling on the device, the
depth forward in training mode (BatchNorm on batch statistics, DenseASPP
dropout drawn from a generator seeded per step), the fused plane sweep
against the right view, the mixture NLL, perceptual and smoothness losses,
backward, and the Adam step.  Batches are dicts of NCHW tensors
(:func:`batch_to_tensors` converts the NHWC numpy batches of ``data/``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.models.perceptual import Vgg19Features
from planedepth_tpu_torch.ops.losses import smooth_loss_disp
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep
from planedepth_tpu_torch.train.flip import add_flip_right_inputs
from planedepth_tpu_torch.train.losses import compute_depth_metrics, perceptual_loss


def sweep_pad(cfg: TrainConfig) -> int:
    """W padding of the sweep: the max disparity with the plane-residual
    overshoot; shifts are clipped to its lane-rounded value less 2."""
    return int(cfg.model.planes.disp_max * 1.08) + 4


def fused_sweep_ok(cfg: TrainConfig) -> bool:
    """True when the training mode is covered by the fused plane sweep."""
    return (
        cfg.fused_sweep
        and cfg.warp_type == "disp_warp"
        and not cfg.model.render_probability
        and cfg.model.planes.yz_levels == 0
        and tuple(cfg.target_sides) == ("r",)
    )


def _check_ported(cfg: TrainConfig) -> None:
    """Raise for what the stereo step does not reach yet, naming its ROADMAP item."""
    if cfg.novel_frame_ids:
        raise NotImplementedError("pose networks and temporal sides are not "
                                  "ported yet (ROADMAP A10)")
    if cfg.loss.self_distillation > 0 or cfg.loss.use_mom:
        raise NotImplementedError("the distillation teacher and use_mom are not "
                                  "ported yet (ROADMAP A9)")
    if cfg.loss.alpha_self > 0:
        raise NotImplementedError("alpha_self waits on its JAX oracle (ROADMAP C1)")
    if not cfg.model.use_mixture_loss:
        raise NotImplementedError("the no-mixture sweep is not ported yet "
                                  "(ROADMAP B1')")
    if not fused_sweep_ok(cfg):
        raise NotImplementedError("only the fused stereo disp_warp path is ported "
                                  "(view synthesis: ROADMAP A4/A10)")
    if cfg.loss.alpha_pc > 0 and cfg.loss.pc_net != "vgg19":
        raise NotImplementedError("the ResNet-18 perceptual net is not ported yet "
                                  "(ROADMAP A4)")


class ModelBundle:
    """The ``DepthModel`` and the frozen perceptual VGG of one configuration,
    with seeded random weights (``init_weights_`` from ``cfg.seed``), on
    ``device``: the card unless the caller names another device."""

    def __init__(self, cfg: TrainConfig, device: Optional[torch.device] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ModelBundle: CUDA is not available; pass "
                                   "device=torch.device('cpu') to run on the CPU")
            device = torch.device("cuda")
        _check_ported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        model_cfg = dataclasses.replace(cfg.model, fused_sweep_loss=True)
        g = torch.Generator().manual_seed(cfg.seed)
        self.model = init_weights_(DepthModel(model_cfg), g).to(self.device)
        self.pc = (init_weights_(Vgg19Features(), g).to(self.device)
                   if cfg.loss.alpha_pc > 0 else None)


def batch_to_tensors(batch: Mapping[str, np.ndarray],
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """NHWC numpy batch (``data/synthetic.py`` keys) -> NCHW tensors on device."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


def fused_stereo_losses(bundle: ModelBundle, outputs: Dict[str, torch.Tensor],
                        batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stereo loss of the mixture recipes through the fused plane sweep:
    mixture NLL (with the automask minimum), perceptual loss on the
    composited reconstruction, edge-aware smoothness on the right 80% of
    columns (``planedepth_tpu/train/step.py:fused_stereo_losses``)."""
    cfg = bundle.cfg
    color = "color_aug" if cfg.loss.match_aug else "color"
    source, target = batch[f"{color}_l"], batch[f"{color}_r"]
    mask_rows = outputs["padding_mask"][..., 0].transpose(1, 2).contiguous()
    with_auto = cfg.loss.automask
    with_disp = "disp" not in outputs
    sweep = plane_sweep(source, target, outputs["logits"], outputs["sigma"],
                        outputs["disp_rows"], mask_rows, sweep_pad(cfg),
                        with_auto, with_disp)
    rgb, nll = sweep[:2]
    ph = torch.minimum(nll, sweep[2]) if with_auto else nll
    disp = sweep[-1][:, None] if with_disp else outputs["disp"]

    ph_loss = ph.mean()
    losses = {"loss/ph_loss": ph_loss, "loss/pc_loss": torch.zeros_like(ph_loss)}
    total = ph_loss
    if bundle.pc is not None:
        pc = perceptual_loss(bundle.pc, rgb, target,
                             source if with_auto else None, remat=cfg.pc_remat)
        losses["loss/pc_loss"] = pc
        total = total + cfg.loss.alpha_pc * pc
    x0 = int(0.2 * source.shape[-1])
    smooth = smooth_loss_disp(disp[..., x0:], batch["color_l"][..., x0:],
                              gamma=cfg.loss.gamma_smooth)
    losses["loss/smooth_loss"] = smooth
    losses["loss/total_loss"] = total + cfg.loss.alpha_smooth * smooth
    return losses


def process_batch(bundle: ModelBundle, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Flip doubling, depth forward and losses -> the loss dict.  The
    model's mode (train or eval) is the caller's."""
    if bundle.cfg.flip_right:
        batch = add_flip_right_inputs(batch)
    outputs = bundle.model(batch["color_aug_l"], batch["grid"], generator)
    return fused_stereo_losses(bundle, outputs, batch)


def make_train_step(bundle: ModelBundle, optimizer: torch.optim.Optimizer,
                    scheduler) -> Callable[[Dict[str, torch.Tensor]], Dict[str, float]]:
    """``train_step(batch) -> {loss name: float}``: forward, backward, Adam
    step, LR schedule step.  Step t draws its dropout masks from a CPU
    generator seeded with ``(cfg.seed, t)``: the same masks on any device."""
    cfg = bundle.cfg
    state = {"step": 0}

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        bundle.model.train()
        g = torch.Generator().manual_seed((cfg.seed << 32) + state["step"])
        optimizer.zero_grad(set_to_none=True)
        losses = process_batch(bundle, batch, g)
        losses["loss/total_loss"].backward()
        optimizer.step()
        scheduler.step()
        state["step"] += 1
        return {k: float(v.detach()) for k, v in losses.items()}

    return train_step


def make_eval_step(bundle: ModelBundle) -> Callable[[Dict[str, torch.Tensor]], Dict[str, float]]:
    """Validation forward (eval mode: the decoder's disp head) + depth
    metrics (reference trainer.py:468-508)."""
    cfg = bundle.cfg

    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        bundle.model.eval()
        with torch.inference_mode():
            out = bundle.model(batch["color_aug_l"], batch["grid"])
            metrics = compute_depth_metrics(out["depth"], batch["depth_gt_l"],
                                            batch["grid"],
                                            stereo_scale=not cfg.no_stereo)
        return {k: float(v) for k, v in metrics.items()}

    return eval_step
