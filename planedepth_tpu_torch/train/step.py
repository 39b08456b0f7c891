"""The training and validation steps (``planedepth_tpu/train/step.py``).

One ``train_step`` call is the reference's per-batch work (trainer.py:278-402):
flip_right batch doubling on the device, the depth forward in training mode
(BatchNorm on batch statistics, DenseASPP dropout drawn from a generator
seeded per step), the pose networks and the crop-rotation conjugation for
the temporal neighbours, under ``self_distillation`` the frozen teacher's
``disp_pp`` and ``mask_novel``, under ``use_mom`` the mirror occlusion mask,
the losses, backward, and the Adam step.  The losses take one of three
routes, as in the JAX package: the stereo recipes through the fused plane
sweep against the right view (:func:`fused_stereo_losses`); the homography
and depth warps through the 2-D warp for every side (``train/mono.py``); the
mixed stereo + temporal ``disp_warp`` recipe through both, side 'r' in the
sweep and the temporal sides in the 2-D warp.  Batches are dicts of NCHW
tensors (:func:`batch_to_tensors` converts the NHWC numpy batches of
``data/``).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.geometry.pose import (
    apply_rc,
    rc_correction,
    transformation_from_parameters,
)
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.models.perceptual import Vgg19Features
from planedepth_tpu_torch.models.pose_net import PoseDecoder
from planedepth_tpu_torch.models.resnet import ResnetPoseEncoder
from planedepth_tpu_torch.ops.losses import smooth_loss_disp
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep
from planedepth_tpu_torch.train.distill import (
    fused_mom_mask_novel,
    generate_post_process_disp,
)
from planedepth_tpu_torch.train.flip import add_flip_right_inputs
from planedepth_tpu_torch.train.losses import compute_depth_metrics, perceptual_loss
from planedepth_tpu_torch.train.mono import fused_warp2d_losses, fused_warp2d_ok


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


def fused_mixed_ok(cfg: TrainConfig) -> bool:
    """True for the stereo + temporal ``disp_warp`` recipes (reference
    trainer.py:85-88): side 'r' rides the plane sweep, the temporal sides
    the 2-D warp."""
    return (
        cfg.fused_sweep
        and cfg.warp_type == "disp_warp"
        and not cfg.model.render_probability
        and cfg.model.planes.yz_levels == 0
        and not cfg.no_stereo
        and len(cfg.novel_frame_ids) > 0
    )


def _check_ported(cfg: TrainConfig) -> None:
    """Raise for what the training step does not reach yet, naming its
    ROADMAP item."""
    if cfg.loss.alpha_self > 0:
        raise NotImplementedError("alpha_self is not ported yet (ROADMAP C1)")
    if cfg.model.render_probability:
        raise NotImplementedError("render_probability is not ported yet (ROADMAP A3)")
    if cfg.novel_frame_ids and cfg.loss.use_mom:
        raise NotImplementedError("use_mom with temporal sides is not ported yet "
                                  "(ROADMAP A10)")
    if cfg.model.planes.yz_levels > 0:
        raise NotImplementedError("training with yz side planes is not ported yet "
                                  "(ROADMAP A10)")
    if not (fused_sweep_ok(cfg) or fused_warp2d_ok(cfg) or fused_mixed_ok(cfg)):
        raise NotImplementedError("this recipe needs the non-fused view synthesis, "
                                  "which is not ported yet (ROADMAP A4)")
    if cfg.loss.alpha_pc > 0 and cfg.loss.pc_net != "vgg19":
        raise NotImplementedError("the ResNet-18 perceptual net is not ported yet "
                                  "(ROADMAP A4)")


class ModelBundle:
    """The networks of one configuration, with seeded random weights
    (``init_weights_`` from one generator seeded with ``cfg.seed``), on
    ``device``: the card unless the caller names another device.

    ``model`` is the ``DepthModel``; under ``cfg.use_pose_net`` the pose
    encoder (a ResNet on frame pairs) and the ``pose`` decoder train beside
    it; ``pc`` is the frozen perceptual VGG.  Under ``self_distillation`` the
    step also needs the frozen teacher, which :meth:`freeze_teacher` takes
    from the student once its weights are final (the trainer calls it after
    the restore)."""

    def __init__(self, cfg: TrainConfig, device: Optional[torch.device] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ModelBundle: CUDA is not available; pass "
                                   "device=torch.device('cpu') to run on the CPU")
            device = torch.device("cuda")
        _check_ported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        # the ResNet decoder stops at its plane heads under the fused sweep;
        # PladeNet and FalNet always emit disp, as in the JAX package
        model_cfg = dataclasses.replace(
            cfg.model, fused_sweep_loss=fused_sweep_ok(cfg) and cfg.model.net_type == "ResNet")
        g = torch.Generator().manual_seed(cfg.seed)
        self.model = init_weights_(DepthModel(model_cfg), g).to(self.device)
        self.pc = (init_weights_(Vgg19Features(), g).to(self.device)
                   if cfg.loss.alpha_pc > 0 else None)
        self.pose_encoder: Optional[ResnetPoseEncoder] = None
        self.pose: Optional[PoseDecoder] = None
        if cfg.use_pose_net:
            self.pose_encoder = init_weights_(
                ResnetPoseEncoder(cfg.model.pose_num_layers, num_input_images=2),
                g).to(self.device)
            self.pose = init_weights_(
                PoseDecoder(self.pose_encoder.num_ch_enc, cfg.model.pose_num_ep),
                g).to(self.device)
        self.teacher: Optional[DepthModel] = None

    def nets(self) -> Dict[str, nn.Module]:
        """The trained networks: ``model`` and, under ``use_pose_net``,
        ``pose_encoder`` and ``pose``, in the order of the JAX package's
        ``params`` tree."""
        nets = {"model": self.model}
        if self.pose_encoder is not None:
            nets.update(pose_encoder=self.pose_encoder, pose=self.pose)
        return nets

    def parameters(self) -> Iterator[nn.Parameter]:
        for net in self.nets().values():
            yield from net.parameters()

    def named_parameters(self) -> Iterator[Tuple[str, nn.Parameter]]:
        for name, net in self.nets().items():
            for k, p in net.named_parameters():
                yield f"{name}.{k}", p

    def train(self, mode: bool = True) -> "ModelBundle":
        for net in self.nets().values():
            net.train(mode)
        return self

    def freeze_teacher(self) -> DepthModel:
        """The teacher becomes a deep copy of the student as it is now
        (reference trainer.py:109-112): eval mode (running statistics, no
        dropout), no parameter requires a gradient."""
        self.teacher = copy.deepcopy(self.model).eval().requires_grad_(False)
        return self.teacher

    def predict_poses(self, batch: Dict[str, torch.Tensor]) -> Dict:
        """The pose of every target side (reference trainer.py:358-402): 'r'
        from the batch; each temporal frame f from the pose nets on the pair
        (f, l) for f < 0 and (l, f) otherwise, inverted for f < 0, or under
        ``use_colmap`` from the batch's ``Rt_{f}``; then conjugated by the
        crop rotation.  The pose encoder's BatchNorm follows its mode: in
        training every call updates the running statistics, as in the
        reference (the JAX package keeps the last call's update only)."""
        cfg = self.cfg
        poses: Dict = {"r": batch["Rt_r"]}
        for f in cfg.novel_frame_ids:
            if cfg.data.use_colmap:
                Rt = batch[f"Rt_{f}"]
            else:
                pair = ([batch[f"color_aug_{f}"], batch["color_aug_l"]] if f < 0
                        else [batch["color_aug_l"], batch[f"color_aug_{f}"]])
                axisangle, translation = self.pose(self.pose_encoder(torch.cat(pair, 1)),
                                                   batch["grid"])
                Rt = transformation_from_parameters(axisangle[:, 0], translation[:, 0],
                                                    invert=f < 0)
            poses[f] = apply_rc(Rt, rc_correction(batch["grid"]),
                                rotate_translation=cfg.data.use_colmap)
        return poses


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
    """The stereo loss through the fused plane sweep
    (``planedepth_tpu/train/step.py:fused_stereo_losses``).  With the
    mixture: the mixture NLL (with the automask minimum, times
    ``mask_novel`` when the outputs hold one).  Without it (FalNet,
    ``use_mixture_loss=False``): the sweep's no-mixture mode, and the L1 of
    the softmax composite, blended with the target by ``mask_novel``, with
    the automask minimum against ``mean |source - target|``.  Then the
    perceptual loss on the composite (blended by ``mask_novel``), the
    distillation L1 to the teacher's ``disp_pp``, edge-aware smoothness on
    the right 80% of columns.  The sweep computes ``disp`` from its centre
    samples unless the model did."""
    cfg = bundle.cfg
    color = "color_aug" if cfg.loss.match_aug else "color"
    source, target = batch[f"{color}_l"], batch[f"{color}_r"]
    mask_rows = outputs["padding_mask"][..., 0].transpose(1, 2).contiguous()
    mix = cfg.model.use_mixture_loss
    # without the mixture the automask is the L1's, taken outside the kernel
    with_auto = cfg.loss.automask and mix
    with_disp = "disp" not in outputs
    sweep = plane_sweep(source, target, outputs["logits"], outputs["sigma"] if mix else None,
                        outputs["disp_rows"], mask_rows, sweep_pad(cfg),
                        with_auto, with_disp)
    rgb = sweep[0]
    disp = sweep[-1][:, None] if with_disp else outputs["disp"]
    mask_novel = outputs.get("mask_novel")                    # (B, 1, H, W)
    if mix:
        ph = torch.minimum(sweep[1], sweep[2]) if with_auto else sweep[1]
        if mask_novel is not None:
            ph = ph * mask_novel[:, 0]
    else:
        pred = rgb if mask_novel is None else rgb * mask_novel + target * (1.0 - mask_novel)
        ph = (pred - target).abs().mean(1)
        if cfg.loss.automask:
            ph = torch.minimum(ph, (source - target).abs().mean(1))

    ph_loss = ph.mean()
    losses = {"loss/ph_loss": ph_loss, "loss/pc_loss": torch.zeros_like(ph_loss)}
    total = ph_loss
    if bundle.pc is not None:
        pred = rgb
        if mask_novel is not None:
            pred = rgb * mask_novel + target * (1.0 - mask_novel)
        pc = perceptual_loss(bundle.pc, pred, target,
                             source if cfg.loss.automask else None, remat=cfg.pc_remat)
        losses["loss/pc_loss"] = pc
        total = total + cfg.loss.alpha_pc * pc
    if cfg.loss.self_distillation > 0 and "disp_pp" in outputs:
        disp_loss = (disp - outputs["disp_pp"]).abs().mean()
        losses["loss/disp_loss"] = disp_loss
        total = total + cfg.loss.self_distillation * disp_loss
    x0 = int(0.2 * source.shape[-1])
    smooth = smooth_loss_disp(disp[..., x0:], batch["color_l"][..., x0:],
                              gamma=cfg.loss.gamma_smooth)
    losses["loss/smooth_loss"] = smooth
    losses["loss/total_loss"] = total + cfg.loss.alpha_smooth * smooth
    return losses


def process_batch(bundle: ModelBundle, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Flip doubling, the teacher's targets, depth forward, the poses, the
    mirror occlusion mask and losses -> the loss dict.  The networks' mode
    (train or eval) is the caller's.

    The teacher runs before the student, so its volumes are freed before the
    student's activations are built; the order changes no number.
    """
    cfg = bundle.cfg
    if cfg.flip_right:
        batch = add_flip_right_inputs(batch, cfg.novel_frame_ids)
    targets = {}
    if cfg.loss.self_distillation > 0:
        if bundle.teacher is None:
            raise RuntimeError("self_distillation needs the frozen teacher: call "
                               "bundle.freeze_teacher() once the student's weights are final")
        targets["disp_pp"], targets["mask_novel"] = generate_post_process_disp(
            bundle.teacher, batch["color_aug_l"], batch["grid"], sweep_pad(cfg))
    outputs = bundle.model(batch["color_aug_l"], batch["grid"], generator)
    outputs.update(targets)
    poses = bundle.predict_poses(batch)
    if cfg.loss.use_mom and cfg.flip_right:
        # overwrites the teacher's mask_novel, in the reference's order
        outputs["mask_novel"] = fused_mom_mask_novel(
            outputs, cfg.model.use_mixture_loss, sweep_pad(cfg))
    if fused_sweep_ok(cfg):
        return fused_stereo_losses(bundle, outputs, batch)
    if fused_warp2d_ok(cfg):
        return fused_warp2d_losses(bundle, outputs, batch, poses)
    # the mixed recipe (fused_mixed_ok): the stereo part holds the smoothness
    # term; the loss keys sum over the sides as the reference's side loop does
    losses = fused_stereo_losses(bundle, outputs, batch)
    extra = fused_warp2d_losses(bundle, outputs, batch, poses,
                                sides=tuple(cfg.novel_frame_ids), include_smooth=False)
    for k, v in extra.items():
        # disp_loss: the same value for every side, already in each part's total
        losses[k] = v if k == "loss/disp_loss" else losses.get(k, 0.0) + v
    return losses


def make_train_step(bundle: ModelBundle, optimizer: torch.optim.Optimizer,
                    scheduler, step: int = 0
                    ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, float]]:
    """``train_step(batch) -> {loss name: float}``: forward, backward, Adam
    step, LR schedule step.  Step t (counted from ``step``) draws its dropout
    masks from a CPU generator seeded with ``(cfg.seed, t)``: the same masks
    on any device."""
    cfg = bundle.cfg
    state = {"step": step}

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        bundle.train()
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
