"""The training and validation steps (``planedepth_tpu/train/step.py``).

One ``train_step`` call is the reference's per-batch work (trainer.py:278-402):
flip_right batch doubling on the device, the depth forward in training mode
(BatchNorm on batch statistics, DenseASPP dropout drawn from a generator
seeded per step), the pose networks and the crop-rotation conjugation for
the temporal neighbours, under ``self_distillation`` the frozen teacher's
``disp_pp`` and ``mask_novel``, under ``use_mom`` the mirror occlusion mask,
the losses, backward, and the Adam step.  The losses take one of four
routes, as in the JAX package: the stereo recipes through the fused plane
sweep against the right view (:func:`fused_stereo_losses`); the homography
and depth warps, and the ``disp_warp`` recipes with ``render_probability``
or yz side planes, through the 2-D warp for every side (``train/mono.py``);
the mixed stereo + temporal ``disp_warp`` recipe through both, side 'r' in
the sweep and the temporal sides in the 2-D warp; and every other recipe
(``fused_sweep`` off, the JAX CLI's default, and ``use_mom`` outside the
stereo sweep) through the oracle view synthesis
(``train/view_synthesis.py:pred_novel_images`` and
``train/losses.py:compute_losses``).  Batches are dicts of NCHW tensors
(:func:`batch_to_tensors` converts the NHWC numpy batches of ``data/``).
Under ``cfg.bf16`` (the default, as in the JAX package) the networks
compute in bf16 with float32 parameters, and the plane sweep and the 2-D
warp take bf16 images and plane heads; the losses are float32.  Under
``cfg.mesh_shape`` ``(D, S)`` each rank trains on its rows of its data
rank's samples, in every recipe (:func:`mesh_for`, :func:`make_train_step`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn

from planedepth_tpu_torch.config import TrainConfig
from planedepth_tpu_torch.geometry.pose import (
    apply_rc,
    rc_correction,
    transformation_from_parameters,
)
from planedepth_tpu_torch.models.denseaspp import DropoutRows
from planedepth_tpu_torch.models.factory import DepthModel, build_depth_model, init_weights_
from planedepth_tpu_torch.models.layers import remat, to_dtype, upcast
from planedepth_tpu_torch.models.perceptual import make_perceptual_net
from planedepth_tpu_torch.models.pose_net import PoseDecoder
from planedepth_tpu_torch.models.resnet import ResnetPoseEncoder
from planedepth_tpu_torch.ops.losses import smooth_loss_disp
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep
from planedepth_tpu_torch.parallel.mesh import (
    Mesh,
    ddp_wrap,
    distributed,
    gather_global,
    make_mesh,
    mean_over_ranks,
    shard_batch,
)
from planedepth_tpu_torch.train.distill import (
    fused_mom_mask_novel,
    generate_post_process_disp,
    head_probability,
    mirror_occlusion_mask,
)
from planedepth_tpu_torch.train.flip import add_flip_right_inputs
from planedepth_tpu_torch.train.losses import (
    compute_depth_metrics,
    compute_losses,
    perceptual_loss,
)
from planedepth_tpu_torch.train.mono import (
    fused_warp2d_losses,
    fused_warp2d_ok,
    self_reconstruction_loss,
)
from planedepth_tpu_torch.train.view_synthesis import pred_novel_images, pred_self_images


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


def spatial_recipe_gap(cfg: TrainConfig, training: bool = True) -> Optional[str]:
    """What of ``cfg`` image rows over ranks do not cover, or None: they
    cover every recipe the port trains and evaluates (the ResNet,
    PladeNet and FalNet families, the fused sweep, the 2-D warp on
    gathered rows, the oracle view synthesis, ``alpha_self``,
    ``render_probability``, yz planes; ``training=False``: the forward
    alone), so nothing."""
    return None


def row_stride(cfg: TrainConfig) -> int:
    """The network's total stride along the rows: 64 for FalNet and
    PladeNet (six stride-2 stages), 32 for the ResNet encoders (five)."""
    return 64 if cfg.model.net_type in ("FalNet", "PladeNet") else 32


def mesh_for(cfg: TrainConfig, training: bool = True) -> Mesh:
    """The mesh of ``cfg.mesh_shape`` over the launcher's ranks
    (``parallel/mesh.py:make_mesh``; ``()`` puts every rank on the data
    axis, ``(D,)`` too).  Raises ``ValueError`` where ``D S`` is not the
    world size or the height is not a multiple of :func:`row_stride` times
    ``S``, and ``NotImplementedError`` for a recipe the spatial axis does
    not cover (:func:`spatial_recipe_gap`)."""
    shape = tuple(cfg.mesh_shape)
    spatial = shape[1] if len(shape) > 1 else 1
    gap = spatial_recipe_gap(cfg, training) if spatial > 1 else None
    if gap is not None:
        raise NotImplementedError(f"image rows over ranks (mesh_shape {shape}) do not cover "
                                  f"{gap}")
    return make_mesh(spatial, shape[0] if shape else None, cfg.data.height, row_stride(cfg))


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


class ModelBundle:
    """The networks of one configuration, with seeded random weights
    (``init_weights_`` from one generator seeded with ``cfg.seed``), on
    ``device``: the card unless the caller names another device.

    ``model`` is the ``DepthModel``; under ``cfg.use_pose_net`` the pose
    encoder (a ResNet on frame pairs) and the ``pose`` decoder train beside
    it; ``pc`` is the frozen perceptual net (VGG-19 or ResNet-18, by
    ``cfg.loss.pc_net``).  Every network computes in bf16 under ``cfg.bf16``
    (``dtype``), with float32 parameters; on the fused sweep's path the
    decoder's train-mode heads stay bf16, as the JAX package's
    ``ModelBundle`` sets them.  Under ``self_distillation`` the
    step also needs the frozen teacher, which :meth:`freeze_teacher` takes
    from the student once its weights are final (the trainer calls it after
    the restore)."""

    def __init__(self, cfg: TrainConfig, device: Optional[torch.device] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ModelBundle: CUDA is not available; pass "
                                   "device=torch.device('cpu') to run on the CPU")
            device = torch.device("cuda")
        self.cfg = cfg
        self.device = torch.device(device)
        # the ResNet decoder stops at its plane heads under the fused sweep;
        # PladeNet and FalNet always emit disp, as in the JAX package
        fused = fused_sweep_ok(cfg)
        model_cfg = dataclasses.replace(
            cfg.model, fused_sweep_loss=fused and cfg.model.net_type == "ResNet")
        g = torch.Generator().manual_seed(cfg.seed)
        self.model = init_weights_(build_depth_model(model_cfg, cfg.bf16), g).to(self.device)
        self.dtype = self.model.dtype
        self.pc = (init_weights_(make_perceptual_net(cfg.loss.pc_net, self.dtype), g)
                   .to(self.device) if cfg.loss.alpha_pc > 0 else None)
        self.pose_encoder: Optional[ResnetPoseEncoder] = None
        self.pose: Optional[PoseDecoder] = None
        if cfg.use_pose_net:
            self.pose_encoder = init_weights_(
                ResnetPoseEncoder(cfg.model.pose_num_layers, num_input_images=2,
                                  dtype=self.dtype), g).to(self.device)
            self.pose = init_weights_(
                PoseDecoder(self.pose_encoder.num_ch_enc, cfg.model.pose_num_ep,
                            dtype=self.dtype), g).to(self.device)
        self.teacher: Optional[DepthModel] = None
        # the trained networks under DDP, by name, in a process group
        # (make_train_step wraps them); the step calls these, every other
        # forward (evaluation, panels, the teacher's copy) the modules
        self.ddp: Dict[str, nn.Module] = {}

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

    def trained(self, name: str) -> nn.Module:
        """The network ``name`` as the training step calls it: its DDP
        wrapper in a process group, else the module."""
        return self.ddp.get(name) or getattr(self, name)

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
                axisangle, translation = self.trained("pose")(
                    self.trained("pose_encoder")(torch.cat(pair, 1)), batch["grid"])
                Rt = transformation_from_parameters(axisangle[:, 0], translation[:, 0],
                                                    invert=f < 0)
            poses[f] = apply_rc(Rt, rc_correction(batch["grid"]),
                                rotate_translation=cfg.data.use_colmap)
        return poses


# NHWC numpy batch (``data/synthetic.py`` keys) -> NCHW tensors on a device
batch_to_tensors = shard_batch


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
    samples unless the model did.  Under ``cfg.bf16`` the images and the
    plane heads enter the sweep in bf16 (``in_dtype``) and the
    reconstruction comes back bf16; its NLL and disparity are float32."""
    cfg = bundle.cfg
    color = "color_aug" if cfg.loss.match_aug else "color"
    source, target = batch[f"{color}_l"], batch[f"{color}_r"]
    mask_rows = outputs["padding_mask"][..., 0].transpose(1, 2).contiguous()
    mix = cfg.model.use_mixture_loss
    # without the mixture the automask is the L1's, taken outside the kernel
    with_auto = cfg.loss.automask and mix
    with_disp = "disp" not in outputs
    in_dtype = torch.bfloat16 if cfg.bf16 else None
    sweep = plane_sweep(to_dtype(source, in_dtype), to_dtype(target, in_dtype),
                        to_dtype(outputs["logits"], in_dtype),
                        to_dtype(outputs["sigma"], in_dtype) if mix else None,
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
        pred = upcast(rgb)
        if mask_novel is not None:
            pred = pred * mask_novel + target * (1.0 - mask_novel)
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
    if cfg.loss.alpha_self > 0:
        self_loss = self_reconstruction_loss(cfg, disp, batch)
        losses["loss/self_loss"] = self_loss
        total = total + cfg.loss.alpha_self * self_loss
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
    outputs = bundle.trained("model")(batch["color_aug_l"], batch["grid"], generator)
    outputs.update(targets)
    poses = bundle.predict_poses(batch)
    if cfg.loss.use_mom and cfg.flip_right and (fused_sweep_ok(cfg) or fused_mixed_ok(cfg)):
        # overwrites the teacher's mask_novel, in the reference's order
        outputs["mask_novel"] = fused_mom_mask_novel(
            outputs, cfg.model.use_mixture_loss, sweep_pad(cfg))
    if fused_sweep_ok(cfg):
        return fused_stereo_losses(bundle, outputs, batch)
    if fused_warp2d_ok(cfg):
        return fused_warp2d_losses(bundle, outputs, batch, poses)
    if fused_mixed_ok(cfg):
        # the stereo part holds the smoothness term; the loss keys sum over
        # the sides as the reference's side loop does
        losses = fused_stereo_losses(bundle, outputs, batch)
        extra = fused_warp2d_losses(bundle, outputs, batch, poses,
                                    sides=tuple(cfg.novel_frame_ids), include_smooth=False)
        for k, v in extra.items():
            # disp_loss: the same value for every side, already in each part's total
            losses[k] = v if k == "loss/disp_loss" else losses.get(k, 0.0) + v
        return losses
    return oracle_losses(bundle, outputs, batch, poses)


def oracle_losses(bundle: ModelBundle, outputs: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], poses: Dict) -> Dict[str, torch.Tensor]:
    """The loss dict through the oracle view synthesis (the JAX package's
    ``synth_and_losses``, reference trainer.py:325-356): every target side
    synthesised by ``pred_novel_images``; under ``use_mom`` with
    ``flip_right`` the mirror occlusion mask of the source-view and the
    synthesised right-view probabilities replaces ``mask_novel``; under
    ``alpha_self`` the self-reconstruction of side 'r'; then
    ``compute_losses``.  Under ``cfg.remat_warp`` the whole segment is
    recomputed in the backward pass, as ``jax.checkpoint`` does it in the
    JAX step (``models/layers.py:remat``; on row shards its gathers run
    again there, on every rank)."""
    if bundle.cfg.remat_warp and torch.is_grad_enabled():
        return remat(_synth_and_losses, bundle, outputs, batch, poses)
    return _synth_and_losses(bundle, outputs, batch, poses)


def _synth_and_losses(bundle: ModelBundle, outputs: Dict[str, torch.Tensor],
                      batch: Dict[str, torch.Tensor], poses: Dict) -> Dict[str, torch.Tensor]:
    cfg = bundle.cfg
    color = "color_aug" if cfg.loss.match_aug else "color"
    rec = pred_novel_images(outputs, batch[f"{color}_l"], cfg.target_sides, poses,
                            batch["K"], batch["inv_K"], warp_type=cfg.warp_type,
                            use_mixture_loss=cfg.model.use_mixture_loss,
                            render_probability=cfg.model.render_probability,
                            sample_dtype=torch.bfloat16 if cfg.warp_sample_bf16 else None)
    if cfg.loss.use_mom and cfg.flip_right:
        probability = (outputs["probability"].detach() if "probability" in outputs
                       else head_probability(outputs, cfg.model.use_mixture_loss))
        shifts = outputs.get("disp_rows", outputs["disp_layered"])
        outputs = dict(outputs, mask_novel=mirror_occlusion_mask(
            probability, rec[("probability_rec", "r")].detach(), shifts.detach(),
            sweep_pad(cfg)))
    if cfg.loss.alpha_self > 0 and "r" in cfg.target_sides:
        rec[("self_rec", "r")] = pred_self_images(outputs["disp"], batch[f"{color}_r"],
                                                  batch["Rt_r"], batch["K"], batch["inv_K"])
    return compute_losses(cfg.loss, cfg.target_sides, batch, outputs, rec, bundle.pc,
                          cfg.model.use_mixture_loss, pc_remat=cfg.pc_remat)


def network_rows(batch: int, rank: int, size: int, flip_right: bool) -> Tuple[torch.Tensor, int]:
    """This rank's rows of the global network batch and that batch's size:
    rank r holds rows ``[r b, (r + 1) b)`` of the global batch, and under
    ``flip_right`` the network batch is ``[B; flip(B)]`` globally against
    ``[b_r; flip(b_r)]`` on the rank."""
    own = torch.arange(rank * batch, (rank + 1) * batch)
    if flip_right:
        return torch.cat([own, own + size * batch]), 2 * size * batch
    return own, size * batch


def make_train_step(bundle: ModelBundle, optimizer: torch.optim.Optimizer,
                    scheduler, step: int = 0
                    ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``train_step(batch) -> {loss name: 0-d tensor}``: forward, backward,
    Adam step, LR schedule step; the losses stay on the device, detached,
    as the JAX step returns device arrays (reading one waits for the step).
    Step t (counted from ``step``) draws its dropout masks from a CPU
    generator seeded with ``(cfg.seed, t)``: the same masks on any device.

    In a process group (``parallel/mesh.py``) ``batch`` is this rank's share
    of the global batch: the trained networks run under DDP, BatchNorm
    normalises by the global batch's moments, the dropout masks are the
    global batch's rows of this rank (:func:`network_rows`), and the losses
    are their means over the ranks: every rank computes what one process
    computes on the global batch.

    On a spatial mesh axis (``cfg.mesh_shape`` ``(D, S)``) ``batch`` holds
    this rank's rows of its data rank's samples: the ops that couple rows
    exchange halos over the spatial group, those that read an image
    anywhere (the 2-D warp, the oracle's and the self-reconstruction's 2-D
    samples) run on the gathered whole image and keep the rank's rows, the
    pose nets' and PladeNet's means are the image's, the dropout masks are the data
    rank's rows (the same on its ``S`` ranks), and each loss is this rank's
    share of its mean over the image, ``S sum / count``
    (``parallel/halo.py:shard_mean``).  With L the global loss, the ranks'
    losses add up to ``D S L`` and every cross-rank op sends its
    cotangents back to the rank that fed it, so the sum of the ranks'
    gradients is ``D S`` times L's, which DDP's average over the ``D S``
    ranks gives, and the mean of the losses over the ranks is L."""
    cfg = bundle.cfg
    state = {"step": step}
    mesh = mesh_for(cfg)
    if distributed():
        bundle.ddp = {name: ddp_wrap(net) for name, net in bundle.nets().items()}

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        bundle.train()
        g = torch.Generator().manual_seed((cfg.seed << 32) + state["step"])
        if mesh.data_size > 1:
            g = DropoutRows(g, *network_rows(batch["color_aug_l"].shape[0], mesh.data_rank,
                                             mesh.data_size, cfg.flip_right))
        optimizer.zero_grad(set_to_none=True)
        losses = process_batch(bundle, batch, g)
        losses["loss/total_loss"].backward()
        optimizer.step()
        scheduler.step()
        state["step"] += 1
        return mean_over_ranks({k: v.detach() for k, v in losses.items()})

    return train_step


def make_eval_step(bundle: ModelBundle) -> Callable[[Dict[str, torch.Tensor]], Dict[str, float]]:
    """Validation forward (eval mode: the decoder's disp head) + depth
    metrics (reference trainer.py:468-508).  In a process group the depth,
    ground truth and grid of every rank are gathered first, so that the
    metrics are the global batch's on every rank (JAX's global
    ``eval_step``; the mono median ratio is a median over the global
    batch, which no sum of the ranks' metrics gives).  On a spatial mesh
    axis the rows of the spatial group are joined first."""
    cfg = bundle.cfg
    mesh_for(cfg, training=False)

    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        bundle.model.eval()
        with torch.inference_mode():
            out = bundle.model(batch["color_aug_l"], batch["grid"])
            metrics = compute_depth_metrics(gather_global(out["depth"]),
                                            gather_global(batch["depth_gt_l"]),
                                            gather_global(batch["grid"]),
                                            stereo_scale=not cfg.no_stereo)
        return {k: float(v) for k, v in metrics.items()}

    return eval_step
