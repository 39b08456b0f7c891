"""Configuration (counterpart of ``planedepth_tpu/config.py``).

Same names and defaults as the JAX package's ``PlaneConfig``, ``ModelConfig``,
``LossConfig``, ``DataConfig`` (the KITTI reader's paths, split, image
format, crop and augmentation ranges), ``OptimConfig`` and the fields of
``TrainConfig`` that the training steps and the trainer read, the three stage
presets, the monocular recipe of the JAX package's ``bench.py`` and the
``to_json``/``from_dict`` round trip (``from_dict`` skips the JAX package's
fields that have no counterpart here, so it reads the JAX ``opt.json``
too).  The fields that choose a TPU layout (``s2d_tail``, ``s2d_stem``,
``fused_head``, ``sweep_rows``, ``sweep_gp_taps*``, ``sweep_quad*``,
``pc_s2d``, ``warp2d_*``) or a TPU-only sampler (``rowshift_warp``) have no
counterpart: the kernels run whenever their tensors lie on the card, and
the 2-D warp kernel samples every plane exactly, so the TPU's tap budget
(``warp2d_plan``) has no use.  ``cli/options.py`` refuses the flags of
those fields.  ``ModelConfig.remat`` and ``TrainConfig.remat_warp`` are
memory trades on any backend, as in the JAX package: the first recomputes
the depth encoder's residual blocks in the backward pass, the second the
oracle route's view synthesis and losses (``train/step.py:oracle_losses``);
each step's numbers are the same, and BatchNorm updates its statistics
once.  ``bf16`` (default True, as in the JAX package) computes the
networks in bf16 and feeds the plane sweep and the 2-D warp bf16 operands;
``warp_sample_bf16`` samples the 2-D warp's and the oracle view
synthesis's plane stacks in bf16.  ``mesh_shape`` ``(D, S)`` lays the
launcher's ``D S`` ranks out as the JAX mesh lays its devices, image rows
over the ``S`` ranks of each data rank (``parallel/mesh.py:make_mesh``);
``()`` puts every rank on the data axis.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class PlaneConfig:
    """Plane-volume layout (reference: networks/depth_decoder.py:18-52)."""

    disp_levels: int = 49           # vertical (fronto-parallel) planes
    disp_min: float = 2.0
    disp_max: float = 300.0
    xz_levels: int = 14             # ground planes
    xz_min: float = 0.1852
    xz_max: float = 0.3704
    yz_levels: int = 0              # side planes (2 x yz_levels//2)
    yz_min: float = 0.1
    yz_max: float = 10.0

    def __post_init__(self):
        if self.disp_levels < 2:
            raise ValueError("disp_levels must be >= 2")
        if not (self.xz_levels == 0 or self.xz_levels >= 2):
            raise ValueError("xz_levels must be 0 or >= 2")
        if self.yz_levels % 2 != 0 or self.yz_levels == 2:
            raise ValueError("yz_levels must be even and 0 or >= 4 (two "
                             "half-sets with >= 2 levels each)")

    @property
    def all_levels(self) -> int:
        return self.disp_levels + self.xz_levels + self.yz_levels


@dataclass(frozen=True)
class ModelConfig:
    """Network architecture selection (reference: options.py:99-163)."""

    net_type: str = "ResNet"        # ResNet | PladeNet | FalNet
    num_layers: int = 50            # resnet depth: 18/34/50/101/152
    num_ep: int = 8                 # positional-encoding channels
    pe_type: str = "neural"         # neural | frequency
    use_denseaspp: bool = True
    use_mixture_loss: bool = True
    plane_residual: bool = True
    render_probability: bool = False
    # recompute the depth encoder's residual blocks in the backward pass
    # (models/resnet.py): their activations are not kept between the passes
    remat: bool = False
    # set by train.step.ModelBundle on the fused stereo path: the decoder
    # then stops at the plane heads in training and the sweep computes disp
    fused_sweep_loss: bool = False
    planes: PlaneConfig = field(default_factory=PlaneConfig)
    # pose networks, built when novel_frame_ids is non-empty and not colmap
    # (reference trainer.py:92-94)
    pose_num_layers: int = 18
    pose_num_ep: int = 8


@dataclass(frozen=True)
class DataConfig:
    """Dataset and augmentation (reference: options.py:27-60, 113-115,
    156-158, 217-220)."""

    data_path: str = "./kitti_data"
    dataset: str = "kitti"          # kitti | kitti_odom | kitti_depth
    split: str = "eigen_full_left"  # a name under splits/, or a directory
    height: int = 192
    width: int = 640
    png: bool = False               # .png frames (else .jpg, decoded by PIL)
    no_crop: bool = False           # disables RandomResizeCrop
    # temporal poses from the batch's Rt_{f} (COLMAP) instead of the pose nets
    use_colmap: bool = False
    colmap_path: str = "./kitti_colmap"
    num_workers: int = 12           # loader threads (data/loader.py)
    # aug ranges (reference: datasets/mono_dataset.py:77-87)
    crop_factor: Tuple[float, float] = (0.75, 1.5)
    gamma_range: Tuple[float, float] = (0.8, 1.2)
    brightness_range: Tuple[float, float] = (0.5, 2.0)
    color_range: Tuple[float, float] = (0.8, 1.2)

    def __post_init__(self):
        if self.height % 32 or self.width % 32:
            raise ValueError("'height' and 'width' must be multiples of 32")


@dataclass(frozen=True)
class LossConfig:
    """Loss weights and switches (reference: options.py:62-77,141-155,208-248)."""

    alpha_smooth: float = 0.04
    gamma_smooth: float = 2.0
    alpha_pc: float = 0.1
    alpha_self: float = 0.0
    self_distillation: float = 0.0
    automask: bool = False
    use_ssim: bool = False          # SSIM in alpha_self's reprojection loss
    match_aug: bool = False
    pc_net: str = "vgg19"           # vgg19 or resnet18
    use_mom: bool = False           # mirror occlusion mask


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer schedule (reference: options.py:176-206)."""

    learning_rate: float = 1e-4
    beta_1: float = 0.5
    beta_2: float = 0.999
    num_epochs: int = 50
    milestones: Tuple[int, ...] = (30, 40)
    lr_gamma: float = 0.5
    start_epoch: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Training configuration: the fields of the JAX ``TrainConfig`` that the
    training steps and the trainer read, with the same defaults."""

    model_name: str = "planedepth"
    log_dir: str = "./log"
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)

    batch_size: int = 8             # GLOBAL batch before flip_right halving
    seed: int = 1
    warp_type: str = "disp_warp"    # depth_warp | disp_warp | homography_warp
    novel_frame_ids: Tuple[int, ...] = ()
    no_stereo: bool = False
    flip_right: bool = False

    # checkpoint / logging
    load_weights_folder: Optional[str] = None
    models_to_load: Tuple[str, ...] = ("encoder", "depth")
    # restore the Adam state saved with the checkpoint when its shapes match
    # (reference trainer.py:905-913 restores adam.pth when present)
    restore_optimizer: bool = True
    # converted ImageNet weights (utils/pretrained.py): resnet{num_layers}.npz
    # for the encoder(s), vgg19.npz for the perceptual net (reference
    # resnet_encoder.py:35, layers.py:381)
    weights_dir: Optional[str] = None
    # explicitly allow training with a RANDOM perceptual net when alpha_pc > 0
    # (tests and ablations only; the reference always uses ImageNet features)
    allow_random_pc: bool = False
    log_frequency: int = 500
    log_img_frequency: int = 250
    # parallelism: () puts every rank on the data axis; (D, S) shards image
    # rows over S ranks of each of D data ranks (parallel/mesh.py)
    mesh_shape: Tuple[int, ...] = ()
    # bfloat16 networks, and bf16 operands of the sweep and the 2-D warp
    bf16: bool = True
    # sample the 2-D warp's and the oracle's plane stacks in bfloat16
    warp_sample_bf16: bool = False
    # recompute the oracle route's view synthesis and losses in the backward
    # pass (train/step.py:oracle_losses; the fused routes have no such segment)
    remat_warp: bool = False
    # checkpoint the perceptual net's pred-branch forward (same numbers)
    pc_remat: bool = True
    fused_sweep: bool = False

    def __post_init__(self):
        if self.loss.use_mom and not self.flip_right:
            # reference trainer.py:74-75 forces flip_right under use_mom
            object.__setattr__(self, "flip_right", True)
        if self.warp_type not in ("depth_warp", "disp_warp", "homography_warp"):
            raise ValueError(f"unknown warp_type {self.warp_type!r}")

    @property
    def per_step_batch(self) -> int:
        """Images loaded per optimizer step: halved under flip_right, then
        doubled by the flip (reference trainer.py:77-78,252-276)."""
        return self.batch_size // 2 if self.flip_right else self.batch_size

    @property
    def effective_batch(self) -> int:
        """Batch size the networks see."""
        return self.per_step_batch * (2 if self.flip_right else 1)

    @property
    def target_sides(self) -> Tuple:
        """Warping targets: stereo right + temporal neighbours
        (reference trainer.py:85-88)."""
        sides = () if self.no_stereo else ("r",)
        return sides + tuple(self.novel_frame_ids)

    @property
    def use_pose_net(self) -> bool:
        """The pose networks predict the temporal poses."""
        return len(self.novel_frame_ids) > 0 and not self.data.use_colmap

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_dict(d: dict) -> "TrainConfig":
        """Rebuild a TrainConfig from ``json.loads(cfg.to_json())`` (the
        opt.json / checkpoint-meta format); unknown keys are skipped."""
        return _dataclass_from_dict(TrainConfig, d)


def _dataclass_from_dict(cls, d: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        ftype = _FIELD_DATACLASSES.get((cls.__name__, f.name))
        if ftype is not None and isinstance(v, dict):
            kw[f.name] = _dataclass_from_dict(ftype, v)
        elif isinstance(v, list):
            kw[f.name] = tuple(v)
        elif v == "None":
            kw[f.name] = None
        else:
            kw[f.name] = v
    return cls(**kw)


# nested-dataclass fields for from_dict reconstruction
_FIELD_DATACLASSES = {
    ("TrainConfig", "model"): ModelConfig,
    ("TrainConfig", "loss"): LossConfig,
    ("TrainConfig", "data"): DataConfig,
    ("TrainConfig", "optim"): OptimConfig,
    ("ModelConfig", "planes"): PlaneConfig,
}


def stage1_config(**overrides) -> TrainConfig:
    """Stage 1: 640x192 stereo, 50 epochs, full feature set."""
    cfg = TrainConfig(
        model_name="stage1",
        fused_sweep=True,
        flip_right=True,
        batch_size=8,
        data=DataConfig(height=192, width=640),
        optim=OptimConfig(learning_rate=1e-4, num_epochs=50, milestones=(30, 40)),
    )
    return cfg.replace(**overrides) if overrides else cfg


def hr_finetune_config(**overrides) -> TrainConfig:
    """Stage 2: 1280x384 high-resolution finetune, 1 epoch, lr 2.5e-5."""
    cfg = TrainConfig(
        model_name="hr_finetune",
        fused_sweep=True,
        flip_right=True,
        batch_size=8,
        data=DataConfig(height=384, width=1280, no_crop=True),
        optim=OptimConfig(learning_rate=2.5e-5, num_epochs=1, milestones=()),
        models_to_load=("encoder", "depth"),
    )
    return cfg.replace(**overrides) if overrides else cfg


def self_distillation_config(**overrides) -> TrainConfig:
    """Stage 3: self-distillation with a frozen teacher, 10 epochs, lr 2e-5.

    The reference's stage-3 command drops ``--flip_right`` (reference
    README.md:56-74): the loaded batch is the full batch_size 4 with no flip
    doubling.
    """
    cfg = TrainConfig(
        model_name="self_distillation",
        fused_sweep=True,
        batch_size=4,
        loss=LossConfig(self_distillation=1.0),
        data=DataConfig(height=384, width=1280, no_crop=True),
        optim=OptimConfig(learning_rate=2e-5, num_epochs=10, milestones=(5,)),
        models_to_load=("encoder", "depth"),
    )
    return cfg.replace(**overrides) if overrides else cfg


def mono_config(**overrides) -> TrainConfig:
    """The monocular homography recipe at the stage-1 size (the JAX
    package's ``bench.py`` mono rung, reference options.py:94-112): the
    pose networks predict the motion to the temporal neighbours -1 and 1,
    each plane is warped by its homography to the sides ("r", -1, 1), with
    the automask, 640x192, batch 8 without flip doubling."""
    cfg = TrainConfig(
        model_name="mono",
        fused_sweep=True,
        batch_size=8,
        warp_type="homography_warp",
        novel_frame_ids=(-1, 1),
        loss=LossConfig(automask=True),
        data=DataConfig(height=192, width=640),
        optim=OptimConfig(learning_rate=1e-4),
    )
    return cfg.replace(**overrides) if overrides else cfg


STAGE_PRESETS = {
    "stage1": stage1_config,
    "hr_finetune": hr_finetune_config,
    "self_distillation": self_distillation_config,
}
