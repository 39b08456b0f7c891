"""Drive the PyTorch/CUDA port's inference path, stage-1 step, stage-2 -> stage-3 trainer, mono trainer, FalNet and PladeNet trainers, no-mixture recipes, KITTI entry points, the render_probability, yz-plane and alpha_self recipes, the sweep's image gradients, the oracle view synthesis, every recipe in bf16, the serving export, the API-parity networks, data parallelism, image rows over ranks and the rematerialisation switches on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: needs CUDA (exits non-zero without it) and prints the card's
     name and power limit as nvidia-smi gives them;
  2. build: compiles planedepth_tpu_torch/csrc/*.cu with nvcc for sm_90a,
     one nvcc process per source, all started together;
  3. kernel: disp_head (CUDA) against disp_head_plain on seeded inputs at
     the inference slice's shape (8, 63, 384, 1280), one row fully masked;
  4. slice: the eval recipe's model (ResNet-50, DenseASPP, 49+14 planes,
     mixture sigma, plane residual, 8-channel neural PE) at 384x1280 with
     seeded random weights, through predict_disparities(post_process=True)
     on make_stereo_batch(4, 384, 1280): 8 images through the net; the
     launch count of every kernel is read around that run; disp is checked
     against the plain head on the decoder's own tensors, the card's
     forward against the CPU's on a small input, and disp is scored with
     evaluate_disparities; forward and kernel times by CUDA events;
  5. sweep: the plane-sweep forward and backward kernels against
     plane_sweep_plain on odd shapes (W not a multiple of 4 nor of a warp,
     narrower than a warp, 1280 and 2048; N not a multiple of the planes a
     barrier; a fully masked row; shifts past the W edge and the clip), each
     with and without with_auto and with_disp, then at the stage-1 shape
     (8, 63, 192, 640) and the stage-3 student's (4, 63, 384, 1280) on
     seeded step-like inputs (row-constant vertical shifts up to ~320,
     per-row ground shifts): forward outputs, then d_logits, d_sigma, d_shift
     from autograd with seeded cotangents; two backward runs must be
     bit-identical; kernel (the backward alone and through autograd) and
     twin times by CUDA events at both shapes, with each kernel's bound,
     share of it, MUFU floor, registers and occupancy;
   5b. sweep_img (run after 5): the backward's image-gradient instance (src
     and tgt require grad; the mixture with the automask) against the
     twin's autograd: d_src, d_tgt, d_logits, d_sigma, d_shift under seeded
     cotangents on every output (nll_auto's too) on phase 5's odd shapes up
     to W = 1280 (wider rows must raise: they do not fit its staged rows),
     with and without the centre disparity, and at (8, 63, 192, 640); its
     head gradients against the head-only instance's (<= 1e-6 relative);
     the no-mixture and no-automask cases raise before any launch; the
     entry point once forward and backward with the counts zeroed (its
     launches in the kernels line); the kernel alone and through autograd
     beside the head-only backward, with its bound, MUFU floor, registers,
     spills and blocks an SM;
 6. train: stage1_config() (ResNet-50, DenseASPP, 49+14 planes, VGG19
     perceptual loss, Adam) at 640x192 with seeded random weights on
     make_stereo_batch(4, 192, 640) flipped to 8: 3 warm-up and 10 timed
     steps with every launch count read around them, the memory of one
     more step by aten op, one validation step (make_eval_step, which
     launches disp_head), and one step on the card held to the same step
     on the CPU at 64x192;
  7. epilogue: the head-epilogue forward and backward kernels against
     head_epilogue_plain at the stage-3 student's shape (4, 63, 384, 1280)
     with a row-constant mask and raw sigmas past both ends of the clip;
     kernel and twin times by CUDA events; then their N - 1 mode
     (render_probability: (8, 62, 192, 640) logits beside (8, 63, 192, 640)
     sigma) against the twin, timed beside the N mode at that shape with
     each one's byte bound;
  8. shift: the row-shift kernel against row_shift_plain at the stage-3
     shape (4, 63, 384, 1280) on seeded signed shifts (the teacher's +/-
     disparities, integers, beyond the clip at both ends); kernel, twin and
     F.grid_sample times by CUDA events;
  9. distill: a stage-2 Trainer (hr_finetune_config, 1280x384, batch 4
     flipped to 8) on synthetic samples takes 2 steps and saves last_models,
     and is freed; a stage-3 Trainer (self_distillation_config: 1280x384,
     batch 4, the frozen teacher on 8 images) restores encoder and depth
     from it and takes 3 warm-up and 10 timed steps and one validation
     pass, with the launch counts read around every step and around the
     run; the teacher must equal the restored student and stay unchanged,
     the student must move; the memory of one more step by aten op; one
     stage-3 step on the card is held to the CPU at 64x192; then 2 use_mom
     steps of stage1_config (6 row-shift launches a step);
 10. warp2d: the 2-D warp forward and backward kernels against warp2d_plain
     on odd shapes (W not a multiple of the block, boundary-partial and
     degenerate coordinates), at zooms up to 200 px, with planes of only
     degenerate samples, with B * N > 65535, and at the mono step's (8, 63,
     192, 640), then timed there (the backward kernel alone, and through
     autograd) with their twin and F.grid_sample on (B*N, 5, H, W);
     the backward kernel's registers and occupancy;
 11. disp_head_bwd: the disp-head backward kernel against autograd through
     disp_head_plain (row 5 fully masked) on odd shapes (W not a multiple of
     the tile, narrower than it; N = 94, 95, 127, 200) and at (8, 63, 192,
     640); two backward runs bit-identical; then timed there, with its
     registers, shared memory and occupancy;
 12. mono: mono_config() (ResNet-50, DenseASPP, 49+14 planes, ResNet-18 pose
     encoder + PoseDecoder, homography warp to the sides r, -1, 1, automask,
     VGG19 per side) through Trainer at 640x192, batch 8, on synthetic
     samples with temporal frames: 3 warm-up and 10 timed steps with every
     step's launch counts read, one validation batch, the memory of one
     more step by aten op, every network's parameters moved, one step on
     the card held to the CPU at 64x128; then 2 steps of the mixed
     disp_warp recipe for their launch counts;
 13. sweep_nomix: the no-mixture sweep kernels (sigma=None, B1') against
     plane_sweep_plain(sigma=None) on phase 5's odd shapes, with and without
     the centre disparity, at FalNet's (8, 49, 192, 640) without it and at
     the ResNet ablation's (8, 63, 192, 640) with it (there nll gets no
     cotangent, as in training): forward, d_logits and d_shift; two backward
     runs bit-identical; then timed at both as in phase 5;
 14. warp2d_nosigma: phase 10 for the warp without sigma, with F.grid_sample
     on (B*N, 4, H, W);
 15. falnet: stage1_config() with FalNet (49 fronto-parallel planes, no
     mixture, VGG19) through Trainer at 640x192, batch 4 flipped to 8: 3
     warm-up and 10 timed steps, each held to exactly one no-mixture sweep
     each way, one validation batch, the memory of one more step by aten
     op, every parameter moved, fal.pth saved, one step on the card held to
     the CPU at 64x192;
 16. pladenet: the same for PladeNet (49+14 planes, mixture, 8-channel PE,
     plane residuals; one mixture sweep each way a step; plade.pth);
 17. nomix: 2 steps each of the ResNet-50 stage-1 ablation, mono_config and
     its mixed disp_warp variant with use_mixture_loss=False, each step held
     to its launch counts, and one no-mixture mono step on the card held to
     the CPU at 64x128;
 18. kitti: writes a KITTI-shaped raw tree under a temporary directory
     (data/kitti_tree.py: the 697 frames of splits/eigen_raw/test_files.txt,
     both cameras, at each date's KITTI size, a 10000-point velodyne scan
     each, the dates' calibration files, and a 32-line train and 8-line val
     split of other frames, val with scans; each PNG row filtered by Sub,
     Up, Average or Paeth); times read_png on one of its frames and on the
     same frame with filter 0 and with Paeth rows, and with the numpy
     row unfilter in place of the compiled one; trains through
     cli.train.main (--stage stage1 --png: ResNet-50, 49+14 planes, VGG19,
     640x192, batch 4 flipped to 8) for 8 steps and one validation pass
     under torch.profiler, with the loader's host time a batch, each step's
     span (CUDA events), the device's busy time inside it (the trace) and
     the wait between steps; exports the eigen_raw ground truth under the
     tree; runs cli/evaluate.py's load (parse, checkpoint meta, restore) and
     evaluate over the 697 frames with post-processing and the tree's
     splits_dir (frames/s); the launch counts of both runs are held to what
     the path runs, the disparities and the seven metrics must be finite and
     the restored model's forward on the card is held to the CPU's;
 19. render: after stage1_config through Trainer as its baseline (13
     steps), stage1_config with render_probability (ResNet-50, DenseASPP,
     49+14 planes, 62 density planes, VGG19) through Trainer at 640x192,
     batch 4 flipped to 8: 3 warm-up and 10 timed steps, each held to one
     2-D warp (with sigma) and one head epilogue (its N - 1 mode) each way,
     no sweep and no disp head; one validation batch; the step time beside
     the baseline's; one step on the card held to the CPU at 64x192 on 49
     vertical planes (with ground planes the NeRF compositing is ill-posed:
     a plane of positive density at a negative distance from the one before
     makes alpha = 1 - exp(-relu(l) d) unbounded, and two float32
     evaluations part); the eval forward at 1280x384, batch 8, card against
     CPU (the epilogue's output, sigma and dists against the CPU forward;
     the compositing against a float64 recomputation from the card's own
     inputs on the well-posed pixels, finite on all);
 20. yz: stage1_config with yz_levels 8 (N = 71; no published recipe sets
     it, 8 is this script's choice) through Trainer as phase 19, the same
     launch counts, one step on the card held to the CPU at 64x192;
 21. self: stage1_config with alpha_self 0.1 and use_ssim through Trainer
     (13 steps, each one sweep and one head epilogue each way), its card
     step held to the CPU at 64x192, then 2 steps of mono_config with the
     same (each 3 warps, the disp head and the head epilogue each way);
     loss/self_loss printed;
 22. pladenet_render: 2 stage-1 steps of PladeNet (49+14 planes, mixture,
     PE 8, plane residuals) with render_probability, each one 2-D warp each
     way;
 23. oracle: stage1_config with fused_sweep=False (the oracle view
     synthesis, the JAX CLI's default) through Trainer at 640x192, batch 4
     flipped to 8: 3 warm-up and 10 timed steps, each held to the head
     epilogue and the disp head each way (no sweep, no warp), one validation
     batch, the Trainer's image panels built on the card (one eval forward);
     one step of the same weights and batch through the fused sweep, its
     losses held to the oracle's at rtol 2e-4; then 2 steps each of
     mono_config with use_mom (the oracle) and of stage 1 with the
     ResNet-18 perceptual net.
 24. export: the eval recipe's forward (ResNet-50, DenseASPP, 49+14 planes,
     mixture, residual, PE 8, seeded weights) at 1280x384 exported with
     torch.export in float32 and bf16, through cli.export.main at batch 1
     and export_forward at batch 8; each program loaded, held to the eager
     forward (float32 within 1e-6 of max |disp|, bf16 within 4.4e-4 of
     mean |disp|) and counted (one disp-head and one head-epilogue launch a
     call, from the custom ops' CUDA implementations); the CLI's float32
     program and the bf16 batch-8 one loaded and run again on the card by
     a fresh python3 that imports torch and planedepth_tpu_torch.ops
     alone; export seconds, bytes, the exported and eager forward's ms a
     batch and peak memory above the weights;
 25. a11: PladePoseNet (BatchNorm, PE 8) on image pairs, Monov2Decoder on
     ResNet-18 features and DepthDecoderContinuous (49 levels, mixture,
     DenseASPP) on ResNet-50 features at 640x192, batch 8, in float32 and
     bf16: a training forward and backward with finite outputs and
     gradients, no kernel launched, the card's eval forward held to the
     CPU's at 64x192, times;
 26. ddp: two gloo ranks on the one card against one process on the
     global batch (stage 1, bf16 and float32), and one NCCL rank through
     the train CLI;
 27. spatial: image rows over ranks, mesh_shape (1, 2): two gloo
     ranks on the one card, 192 of the 384 rows each, one hr_finetune step
     in bf16 and in float32 and one stage-3 step (the teacher and the row
     shift) against one process on the global batch: losses at rtol 2e-4,
     float32 gradients and weights by the C4 rule, the ranks' parameters
     bit-equal, the launches alike, rank 0's sweep kernels under
     torch.profiler, each rank's peak memory below the one process's;
 28. remat (last): the rematerialisation switches on the spatial phase's
     one-process runs, from their seeded weights and batches: hr_finetune
     (8 x 1280x384, ResNet-50, 49+14 planes, VGG19) in bf16 and float32
     under model.remat (the depth encoder's residual blocks recomputed in
     the backward pass), the oracle stage 1 (float32, 8 x 640x192) under
     remat_warp (its view synthesis and losses recomputed): the first step
     with the switch on (taken while the spatial ranks run) against the
     same step without it: losses, every BatchNorm buffer and the launches
     bit-equal, each gradient leaf bit-equal or within the spread of two
     steps without it; then 2 warm-up and 5 timed steps each way, with the
     peak memory allocated and one step's memory by aten op;
 bf16 (the JAX package's default arithmetic, TrainConfig.bf16):
  sweep_wide (after 5b): rows wider than one launch (W = 2560, 4096) in
     column segments: forward, head-only backward and image-gradient
     backward against the plain version, one launch a segment;
  sweep_bf16, warp2d_bf16: the bf16 instances of the sweep (both mixture
     modes, at (8, 63, 192, 640), (4, 63, 384, 1280) and FalNet's 49
     planes) and of the 2-D warp (with and without sigma, at (8, 63, 192,
     640) and a small shape with degenerate coordinates) against their
     plain versions with seeded cotangents: bf16 outputs within one bf16
     ulp plus the float32 instance's tolerance, float32 outputs at it (the
     sweep's gradients against the plain version anchored at the kernel's
     rounded reconstruction, which its backward reads); the warp also at W
     odd and W = 3 mod 4 with taps at the image's edges and on src and heads
     passed as views that end their allocation, both its entries over
     NaN-filled outputs; each kernel alone timed beside its float32
     instance, its bound in bf16 bytes, the sweep's with both instances'
     registers, blocks an SM and shared bytes, the warp's (with its
     forward's packing) beside F.grid_sample on bf16 operands;
  bf16_recipes (last): through the Trainer in bf16, stage 1 (13 steps),
     stage 2 -> stage 3 with the teacher (2 + 13), mono (13), mono without
     the mixture, FalNet and PladeNet (2 each), each step held to its bf16
     launch counts, with ms a step, peak memory and the card's idle share
     in 3 more steps (torch.profiler) beside the float32 runs of this call,
     and one step's losses from the same weights held to float32's; the
     eval forward at 1280x384 on 8 images in bf16 beside float32.
  The kitti phase runs the CLIs' default, bf16.
Each phase prints its wall time.  Then one JSON line of the kernels and,
last, the ok line.  ``python3 chip_smoke.py export a11`` runs the device and
build phases and then the named phases alone (any phase that takes only
the card), and prints no JSON line.  TF32 is off for convolutions and matmuls so that the
float32 phases compute in float32 throughout; they pass bf16=False
(``_float32``).
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from planedepth_tpu_torch.config import DataConfig, LossConfig, ModelConfig, PlaneConfig
from planedepth_tpu_torch import config as _config
from planedepth_tpu_torch.cli import evaluate as cli_evaluate
from planedepth_tpu_torch.cli import export as cli_export
from planedepth_tpu_torch.cli import train as cli_train
from planedepth_tpu_torch.cli.options import args_to_config, build_parser, parse_with_explicit
from planedepth_tpu_torch.data import native
from planedepth_tpu_torch.data import image_io
from planedepth_tpu_torch.data.image_io import png_decoder, read_png, write_png
from planedepth_tpu_torch.data.kitti import readlines, split_path
from planedepth_tpu_torch.data.kitti_tree import write_tree
from planedepth_tpu_torch.data.loader import BatchLoader
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.eval import evaluator as evaluator_module
from planedepth_tpu_torch.eval.evaluator import mirror_batch, predict_disparities
from planedepth_tpu_torch.eval.export_gt import export_eigen_raw_gt
from planedepth_tpu_torch.eval.metrics import evaluate_disparities
from planedepth_tpu_torch.geometry.pose import transformation_from_parameters
from planedepth_tpu_torch.models.depth_decoder import (
    DepthDecoderContinuous,
    mixture_reweight,
    render_probability_from_logits,
)
from planedepth_tpu_torch.models.factory import DepthModel, build_depth_model, init_weights_
from planedepth_tpu_torch.models.monov2_decoder import Monov2Decoder
from planedepth_tpu_torch.models.pose_net import PladePoseNet
from planedepth_tpu_torch.models.resnet import ResnetEncoder, encoder_channels
from planedepth_tpu_torch.ops import _build
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue, head_epilogue_plain
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain, shift_max
from planedepth_tpu_torch.ops.row_shift import row_shift, row_shift_plain, shift_limit
from planedepth_tpu_torch.ops.warp2d import fwd_scratch_bytes as warp2d_fwd_scratch_bytes
from planedepth_tpu_torch.ops.warp2d import scratch_bytes as warp2d_scratch_bytes
from planedepth_tpu_torch.ops.warp2d import warp2d, warp2d_plain
from planedepth_tpu_torch.train.distill import generate_post_process_disp
from planedepth_tpu_torch.train.state import make_optimizer
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    make_eval_step,
    make_train_step,
    process_batch,
    sweep_pad,
)
from planedepth_tpu_torch.train import trainer as trainer_module
from planedepth_tpu_torch.train.trainer import Trainer
from planedepth_tpu_torch.utils.checkpoint import load_checkpoint


def _float32(preset):
    """``preset`` computing in float32 unless asked for bf16: the float32
    phases stay float32 (TF32 off), comparable with their earlier records;
    the bf16 phases pass ``bf16=True``."""
    return lambda **kw: preset(**{"bf16": False, **kw})


stage1_config, hr_finetune_config, self_distillation_config, mono_config = map(
    _float32, (_config.stage1_config, _config.hr_finetune_config,
               _config.self_distillation_config, _config.mono_config))

SHAPE = (8, 63, 384, 1280)            # (B, N, H, W): eval batch 4, doubled
SWEEP_SHAPE = (8, 63, 192, 640)       # stage-1 batch 4, flipped to 8
SHIFT_SHAPE = (4, 63, 384, 1280)      # stage 3: batch 4, the teacher's half
FALNET_SHAPE = (8, 49, 192, 640)      # FalNet: stage-1 batch 4 flipped to 8, 49 planes
TOL = dict(rtol=1e-5, atol=1e-5)      # only the f32 summation order differs
# gradients: d_shift sums W terms in another order; relative to max |value|
GRAD_TOL = 1e-4
# cuDNN and CPU float32 convolutions through a ResNet: the tolerance at which
# tests/test_torch_models.py holds the CPU port to the JAX package
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-3, 1e-4
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                     # H100 SXM float32 outside the tensor cores
KERNELS = {
    "disp_head_fwd": ("planedepth_tpu_torch/csrc/disp_head.cu",
                      "planedepth_tpu/ops/pallas_disp.py:40"),
    "plane_sweep_fwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                        "planedepth_tpu/ops/pallas_sweep.py:376"),
    "plane_sweep_bwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                        "planedepth_tpu/ops/pallas_sweep.py:542"),
    "row_shift_fwd": ("planedepth_tpu_torch/csrc/row_shift.cu",
                      "planedepth_tpu/ops/pallas_shift.py:31"),
    "head_epilogue_fwd": ("planedepth_tpu_torch/csrc/head_epilogue.cu",
                          "planedepth_tpu/ops/pallas_relayout.py:36"),
    "head_epilogue_bwd": ("planedepth_tpu_torch/csrc/head_epilogue.cu",
                          "planedepth_tpu/ops/pallas_relayout.py:144"),
    "disp_head_bwd": ("planedepth_tpu_torch/csrc/disp_head.cu",
                      "planedepth_tpu/ops/pallas_disp.py:65"),
    "warp2d_fwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                   "planedepth_tpu/ops/pallas_warp2d.py:200"),
    "warp2d_bwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                   "planedepth_tpu/ops/pallas_warp2d.py:244"),
    "plane_sweep_nomix_fwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                              "planedepth_tpu/ops/pallas_sweep.py:376"),
    "plane_sweep_nomix_bwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                              "planedepth_tpu/ops/pallas_sweep.py:542"),
    "warp2d_nosigma_fwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                           "planedepth_tpu/ops/pallas_warp2d.py:200"),
    "warp2d_nosigma_bwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                           "planedepth_tpu/ops/pallas_warp2d.py:244"),
    "plane_sweep_img_bwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                            "planedepth_tpu/ops/pallas_sweep.py:542"),
    # bf16, the JAX package's default: the same kernels' bf16 instances
    "plane_sweep_bf16_fwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                             "planedepth_tpu/ops/pallas_sweep.py:376"),
    "plane_sweep_bf16_bwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                             "planedepth_tpu/ops/pallas_sweep.py:542"),
    "plane_sweep_nomix_bf16_fwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                                   "planedepth_tpu/ops/pallas_sweep.py:376"),
    "plane_sweep_nomix_bf16_bwd": ("planedepth_tpu_torch/csrc/plane_sweep.cu",
                                   "planedepth_tpu/ops/pallas_sweep.py:542"),
    "warp2d_bf16_fwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                        "planedepth_tpu/ops/pallas_warp2d.py:200"),
    "warp2d_bf16_bwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                        "planedepth_tpu/ops/pallas_warp2d.py:244"),
    "warp2d_nosigma_bf16_fwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                                "planedepth_tpu/ops/pallas_warp2d.py:200"),
    "warp2d_nosigma_bf16_bwd": ("planedepth_tpu_torch/csrc/warp2d.cu",
                                "planedepth_tpu/ops/pallas_warp2d.py:244"),
}


def only(**counts):
    """Launch counts that are 0 but for ``counts``."""
    unknown = set(counts) - set(KERNELS)
    if unknown:
        raise KeyError(f"no kernel {sorted(unknown)}")
    return {**{k: 0 for k in KERNELS}, **counts}


def nonzero(counts):
    """The launch counts that are not 0."""
    return {k: v for k, v in counts.items() if v}


# per stage-3 step: the teacher's 5 row shifts, disp head and head
# epilogue; the student's head epilogue and sweep, forward and backward
DISTILL_STEP = only(disp_head_fwd=1, plane_sweep_fwd=1, plane_sweep_bwd=1, row_shift_fwd=5,
                    head_epilogue_fwd=2, head_epilogue_bwd=1)
# per mono step: the 2-D warp of each of the sides r, -1, 1 forward and
# backward, the decoder's head epilogue and disp head forward and backward
MONO_STEP = only(disp_head_fwd=1, head_epilogue_fwd=1, head_epilogue_bwd=1,
                 disp_head_bwd=1, warp2d_fwd=3, warp2d_bwd=3)
# per mixed step: side r through the sweep, the sides -1, 1 through the warp
MIXED_STEP = dict(MONO_STEP, plane_sweep_fwd=1, plane_sweep_bwd=1, warp2d_fwd=2,
                  warp2d_bwd=2)
# per FalNet step: the no-mixture sweep each way, nothing else (no head
# epilogue, no disp head: FalNet's plane head is a plain 1x1 conv)
FALNET_STEP = only(plane_sweep_nomix_fwd=1, plane_sweep_nomix_bwd=1)
# per PladeNet step: the mixture sweep each way (its sigma clip and mixture
# reweight are plain tensor code)
PLADENET_STEP = only(plane_sweep_fwd=1, plane_sweep_bwd=1)
# per step of the ResNet ablation without the mixture: the head epilogue
# (logits only) and the no-mixture sweep with the centre disparity
NOMIX_STEREO_STEP = only(head_epilogue_fwd=1, head_epilogue_bwd=1,
                         plane_sweep_nomix_fwd=1, plane_sweep_nomix_bwd=1)
# per mono step without the mixture: the sigma-less warp of the sides r, -1,
# 1; the decoder's disp is a plain expectation (no disp head)
NOMIX_MONO_STEP = only(head_epilogue_fwd=1, head_epilogue_bwd=1, warp2d_nosigma_fwd=3,
                       warp2d_nosigma_bwd=3)
NOMIX_MIXED_STEP = dict(NOMIX_MONO_STEP, plane_sweep_nomix_fwd=1, plane_sweep_nomix_bwd=1,
                        warp2d_nosigma_fwd=2, warp2d_nosigma_bwd=2)


# the special-function unit (ex2, rcp): 16 operations a clock on each of the
# H100 SXM's 132 SMs at its 1.98 GHz boost clock (NVIDIA's Hopper white paper)
MUFU_OPS_PER_S = 16 * 132 * 1.98e9


def sweep_mufu(mix, with_disp, direction, with_auto=False):
    """MUFU operations a pixel-plane of the sweep kernels: forward, the
    online-softmax exp, 1/sigma, the Laplacian's exp (and the automask's),
    the centre disp head's exp and 1/sigma; backward, pi's exp, 1/sigma,
    the Laplacian's exp (and with the image gradients, ``with_auto``, the
    automask's), the centre's exp and 1/sigma."""
    ops = 2 + int(mix) + int(with_auto)
    return ops + (1 + int(mix) if with_disp else 0)


def mufu_floor_ms(pixel_planes, ops):
    """Least time in ms for ``ops`` MUFU operations on each of
    ``pixel_planes``: the sweep kernels' second floor, under the bytes."""
    return pixel_planes * ops / MUFU_OPS_PER_S * 1e3


def sweep_kernel_info(backward, mix, N, W, image_grads=False, bf16=False):
    """The compiler's and the occupancy calculator's view of the sweep
    kernel instance that a launch at (N, W) takes (``image_grads``: the
    backward's image-gradient instance; ``bf16``: the bf16 instance)."""
    out = (ctypes.c_int * 5)()
    lib = _build.load_library()
    rc = (lib.pdt_plane_sweep_kernel_info_bf16(int(backward), int(mix), N, W, out) if bf16
          else lib.pdt_plane_sweep_kernel_info(int(backward), int(mix), int(image_grads), N,
                                               W, out))
    if rc != 0:
        raise RuntimeError(f"pdt_plane_sweep_kernel_info: CUDA error {rc}")
    return dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm", "smem_bytes"),
                    out))


def bound(nbytes, flops):
    """Least time in ms for moving ``nbytes`` and doing ``flops`` on the card,
    and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def cuda_ms(fn, warmup=3, reps=10):
    """Median of ``reps`` single-call CUDA-event times, after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(fn, reps=20):
    """Mean CUDA-event time of ``reps`` back-to-back calls after one warm-up:
    the host's work for one call overlaps the device's for the one before,
    so a call's host overhead shows only where it exceeds its device time."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build():
    info = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"[build] nvcc sm_90a {info['seconds']:.1f} s "
          f"(cached={info['cached']}) -> {info['path']}")
    for ln in ptxas:
        print(f"[build] ptxas: {ln}")


def seeded_head_inputs(shape, seed, dev):
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = (torch.rand((B, H, N), generator=g, device=dev) > 0.2).float()
    mask[:, 5, :] = 0.0                                   # guarded row
    logits = 2.0 * torch.randn((B, N, H, W), generator=g, device=dev)
    logits *= mask.transpose(1, 2)[..., None]             # masked as the decoder does
    sigma = torch.rand((B, N, H, W), generator=g, device=dev) * 0.99 + 0.01
    disp_rows = torch.rand((B, H, N), generator=g, device=dev) * 298.0 + 2.0
    return logits, sigma, disp_rows.contiguous(), mask.contiguous()


def phase_kernel(card, shape=SHAPE, dev=torch.device("cuda")):
    inputs = seeded_head_inputs(shape, 0, dev)
    got = disp_head(*inputs)
    torch.cuda.synchronize(dev)
    want = disp_head_plain(*inputs)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **TOL)
    if not bool((got[:, :, 5] == 0).all()):
        raise AssertionError("fully masked row must give disp 0")
    ms = cuda_ms(lambda: disp_head(*inputs))
    plain_ms = cuda_ms(lambda: disp_head_plain(*inputs))
    gbytes = 2 * inputs[0].numel() * 4 / 1e9
    # each input read once, disp written once; ~10 flops a pixel-plane
    bound_ms, bound_by = bound(nbytes(*inputs, got), 10 * inputs[0].numel())
    print(f"[kernel] disp_head vs plain at {shape}: max_abs_err {err:.3e} "
          f"(rtol {TOL['rtol']}, atol {TOL['atol']}) | kernel {ms:.4f} ms "
          f"({gbytes / ms:.1f} TB/s of logits+sigma), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
          f"computes it | {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_slice(card, data=DataConfig(height=384, width=1280),
                dev=torch.device("cuda")):
    cfg = ModelConfig()                  # the eval recipe: ResNet-50, 49+14
    height, width = data.height, data.width
    model = init_weights_(DepthModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    batch = make_stereo_batch(4, height, width, seed=0)

    reset_launch_counts()
    t0 = time.perf_counter()
    disps, prob_max = predict_disparities(model, [batch], post_process=True,
                                          device=dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # each forward: the decoder's head epilogue, then its disp head
    n = launches["disp_head_fwd"]
    if n < 1 or launches != only(disp_head_fwd=n, head_epilogue_fwd=n):
        raise AssertionError(f"inference launches {launches}")
    if disps.shape != (4, height, width) or not np.isfinite(disps).all():
        raise AssertionError(f"bad disparities: shape {disps.shape}")
    if not ((prob_max > 0) & (prob_max <= 1)).all():
        raise AssertionError(f"prob_max out of (0, 1]: {prob_max}")

    # the same doubled batch as predict_disparities forwards it
    image, grid = mirror_batch(
        torch.from_numpy(batch["color_l"]).to(dev).permute(0, 3, 1, 2),
        torch.from_numpy(batch["grid"]).to(dev).permute(0, 3, 1, 2))
    with torch.inference_mode():
        out = model(image, grid)
        mask_rows = out["padding_mask"][..., 0].transpose(1, 2).contiguous()
        plain = disp_head_plain(out["logits"], out["sigma"], out["disp_rows"],
                                mask_rows)
        err = (out["disp"] - plain).abs().max().item()
        torch.testing.assert_close(out["disp"], plain, **TOL)
        fwd_ms = cuda_ms(lambda: model(image, grid))
    metrics = evaluate_disparities(disps, batch["depth_gt_l"][..., 0], width)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metric: {metrics}")
    small_err = check_against_cpu(model, dev)
    print(f"[slice] ResNet-{cfg.num_layers} {cfg.planes.disp_levels}+"
          f"{cfg.planes.xz_levels} planes {height}x{width}, post_process: "
          f"disp {disps.shape} in [{disps.min():.3f}, {disps.max():.3f}], "
          f"prob_max {[round(float(v), 4) for v in prob_max]}, launches {launches}, "
          f"decoder disp vs plain max_abs_err {err:.3e}, card vs CPU "
          f"forward at 64x192 max_abs_err {small_err:.3e}, "
          f"predict wall {wall:.2f} s (first call)")
    print(f"[slice] eigen metrics (random weights, shows the path runs): "
          f"{json.dumps(metrics)}")
    F32_RUNS["eval"] = (fwd_ms, None)
    print(f"[slice] forward {fwd_ms:.2f} ms/batch of 8 images at {height}x{width} "
          f"(CUDA events, 3 warm-up, median of 10, TF32 off for cudnn and "
          f"matmul) | {card}")
    return launches


def check_against_cpu(model, dev):
    """The card's forward against the same weights on the CPU, where the
    disp head takes its plain version and the tests hold the port to the JAX
    package, on a small seeded input; returns the largest disp error."""
    batch = make_stereo_batch(2, 64, 192, seed=1)
    image, grid = mirror_batch(
        torch.from_numpy(batch["color_l"]).permute(0, 3, 1, 2),
        torch.from_numpy(batch["grid"]).permute(0, 3, 1, 2))
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        want = cpu_model(image, grid)
        got = model(image.to(dev), grid.to(dev))
    for key in ("logits", "sigma", "probability", "disp"):
        torch.testing.assert_close(got[key].cpu(), want[key], msg=key, **MODEL_TOL)
    return (got["disp"].cpu() - want["disp"]).abs().max().item()


def quantile(err, q):
    """The ``q`` quantile of ``err``'s elements."""
    err = err.flatten()
    return float(err.kthvalue(max(1, int(q * err.numel()))).values)


def check_against_cpu_bf16(model, dev):
    """A bf16 model's card forward against the same weights in bf16 on the
    CPU, on a small seeded input.  cuDNN's and the CPU's float32 sums tip bf16
    roundings apart from layer to layer, as far as bf16 stands from float32,
    so the card's forward must stand no further from the CPU's bf16 forward
    than the CPU's bf16 forward stands from the float32 forward of the same
    weights, times a factor, on logits, sigma, probability and disp: twice
    on average, 2.5 times in the 99.9th percentile of the elements'
    distances (a localised fault, a wrong row or plane, shows there; 0.87-
    1.55 times measured on an H100), three times at the largest.  Returns
    each pair."""
    batch = make_stereo_batch(2, 64, 192, seed=1)
    image, grid = mirror_batch(
        torch.from_numpy(batch["color_l"]).permute(0, 3, 1, 2),
        torch.from_numpy(batch["grid"]).permute(0, 3, 1, 2))
    cpu_model = copy.deepcopy(model).cpu()
    f32 = build_depth_model(model.cfg, bf16=False).eval()
    f32.load_state_dict(cpu_model.state_dict())
    with torch.inference_mode():
        want, ref = cpu_model(image, grid), f32(image, grid)
        got = model(image.to(dev), grid.to(dev))
    out = {}
    for key in ("logits", "sigma", "probability", "disp"):
        e_card = (got[key].cpu().float() - want[key].float()).abs()
        e_bf16 = (want[key].float() - ref[key].float()).abs()
        d_card, d_bf16 = float(e_card.mean()), float(e_bf16.mean())
        q_card, q_bf16 = quantile(e_card, 0.999), quantile(e_bf16, 0.999)
        m_card, m_bf16 = float(e_card.max()), float(e_bf16.max())
        if not (d_card <= 2.0 * d_bf16 + 1e-6 and q_card <= 2.5 * q_bf16 + 1e-6
                and m_card <= 3.0 * m_bf16 + 1e-6):
            raise AssertionError(f"{key}: the card's bf16 forward from the CPU's (mean, "
                                 f"99.9th percentile, max) {d_card:.3e} {q_card:.3e} "
                                 f"{m_card:.3e}, the CPU's from float32 {d_bf16:.3e} "
                                 f"{q_bf16:.3e} {m_bf16:.3e}")
        out[key] = (d_card, d_bf16, q_card, q_bf16, m_card, m_bf16)
    return out


def seeded_sweep_inputs(shape, seed, dev):
    """Step-like sweep operands: 49/63 vertical planes with row-constant
    shifts up to ~320 and two beyond the clip (W - 1.5 and W + 40, both
    sampled at the clip, past the W edge for most x), ground planes with
    per-row shifts, row 5 fully masked; logits masked as the decoder masks
    them.  logits, sigma and shift require grad."""
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    nv = (49 * N) // 63
    rand = lambda *size: torch.rand(size, generator=g, device=dev)
    vert = (2.0 * (160.0 ** rand(B, 1, nv))).expand(B, H, nv).clone()
    vert[:, :, 0] = W - 1.5
    vert[0, :, 1] = W + 40.0
    ground = 40.0 * rand(B, 1, N - nv) + rand(B, 1, N - nv) * torch.arange(
        H, device=dev)[None, :, None] * (200.0 / H)
    shift = torch.cat([vert, ground], -1).contiguous()
    mask = (rand(B, H, N) > 0.2).float()
    mask[:, :, :nv] = 1.0
    mask[:, 5] = 0.0
    logits = 2.0 * torch.randn((B, N, H, W), generator=g, device=dev)
    logits *= mask.transpose(1, 2)[..., None]
    sigma = rand(B, N, H, W)
    src, tgt = rand(B, 3, H, W), rand(B, 3, H, W)
    for t in (logits, sigma, shift):
        t.requires_grad_()
    return [src, tgt, logits, sigma, shift, mask]


def sweep_bounds(inputs):
    """(bytes, bound) of the sweep forward and of its backward: each input
    read once, each output written once (stats: 7 maps); ~60 flops a
    pixel-plane forward, ~100 backward."""
    src, tgt, logits, sigma, shift, mask = inputs
    B, N, H, W = logits.shape
    row = B * H * W * 4
    fwd_bytes = nbytes(src, tgt, logits, sigma, shift, mask) + row * (3 + 1 + 1 + 7)
    bwd_bytes = (nbytes(src, tgt, logits, sigma, shift, mask) + row * (7 + 3 + 3 + 1 + 1)
                 + nbytes(logits, sigma, shift))
    return ((fwd_bytes, bound(fwd_bytes, 60 * logits.numel())),
            (bwd_bytes, bound(bwd_bytes, 100 * logits.numel())))


# odd shapes for the sweep kernels: W not a multiple of 4 (4-byte copies)
# nor of a warp, narrower than a warp, at 1280 (2 pixels a thread) and 2048
# (4); N not a multiple of the 2 planes a barrier (5, 7, 9, 63); row 5 fully
# masked; shifts past the W edge and, where W + 40 exceeds it, past the clip
SWEEP_SMALLS = ((2, 7, 8, 37), (1, 9, 6, 1501), (1, 5, 7, 18), (2, 63, 6, 100),
                (1, 14, 6, 1280), (1, 3, 6, 2048))
# (with_auto, with_disp); the mixture mode takes all four
SWEEP_FLAGS = ((False, True), (True, True), (True, False), (False, False))


def sweep_info(mix, N, W):
    """Registers, spills, block and occupancy of the forward/backward pair."""
    f, b = (sweep_kernel_info(d, mix, N, W) for d in (0, 1))
    return (f"registers {f['registers']}/{b['registers']} (spills {f['spill_bytes']}/"
            f"{b['spill_bytes']} B), {f['threads']} threads a block, {f['blocks_per_sm']}/"
            f"{b['blocks_per_sm']} blocks an SM, {f['smem_bytes']}/{b['smem_bytes']} B shared")


def backward_is_deterministic(inputs, pad, with_disp):
    """Two backward runs through autograd on the same forward and
    cotangents give bit-identical gradients."""
    outs = plane_sweep(*inputs, pad, False, with_disp)
    heads = [t for t in inputs[2:5] if t is not None]
    cts = [torch.randn_like(o) for o in outs]
    first = torch.autograd.grad(outs, heads, cts, retain_graph=True)
    second = torch.autograd.grad(outs, heads, cts)
    return all(torch.equal(a, b) for a, b in zip(first, second))


def print_sweep_times(tag, at, t, card):
    share = lambda d: t[f"{d}_bound"][0] / t[f"{d}_ms"]
    print(f"[{tag}] at {at}: forward kernel alone {t['fwd_ms']:.4f} ms (bound "
          f"{t['fwd_bound'][0]:.4f} ms of {t['fwd_bytes'] / 1e6:.0f} MB, {share('fwd'):.1%} of "
          f"it; MUFU floor {t['fwd_mufu_ms']:.4f} ms; through the wrapper "
          f"{t['wrapper_ms']:.4f} ms), backward kernel alone "
          f"{t['bwd_ms']:.4f} ms (bound {t['bwd_bound'][0]:.4f} ms of "
          f"{t['bwd_bytes'] / 1e6:.0f} MB, {share('bwd'):.1%} of it; MUFU floor "
          f"{t['bwd_mufu_ms']:.4f} ms), through autograd {t['autograd_ms']:.4f} ms; twin "
          f"forward {t['plain_fwd_ms']:.2f} ms, backward {t['plain_bwd_ms']:.2f} ms; "
          f"{t['info']}; no single PyTorch call computes either | {card}")


def sweep_fields(held, main, extra):
    """The kernels line's entries of a sweep pair, timed at ``main``; the
    times at ``extra`` (shape -> times) beside them."""
    more = lambda d: {"at": [{"shape": list(at), "ms": t[f"{d}_ms"],
                              "bound_ms": t[f"{d}_bound"][0], "mufu_floor_ms": t[f"{d}_mufu_ms"]}
                             for at, t in extra.items()]}
    return ({"max_abs_err": held.fwd, "ms": main["fwd_ms"], "wrapper_ms": main["wrapper_ms"],
             "plain_ms": main["plain_fwd_ms"],
             "bound_ms": main["fwd_bound"][0], "bound_by": main["fwd_bound"][1],
             "library_ms": None, "mufu_floor_ms": main["fwd_mufu_ms"], **more("fwd")},
            {**held.bwd_fields(), "ms": main["bwd_ms"], "autograd_ms": main["autograd_ms"],
             "plain_ms": main["plain_bwd_ms"], "bound_ms": main["bwd_bound"][0],
             "bound_by": main["bwd_bound"][1], "library_ms": None,
             "mufu_floor_ms": main["bwd_mufu_ms"], "bit_identical": True, **more("bwd")})


def phase_sweep(card, shape=SWEEP_SHAPE, dev=torch.device("cuda"),
                hr_shape=SHIFT_SHAPE, smalls=SWEEP_SMALLS):
    """The mixture sweep kernels against their twin on odd shapes with every
    flag, at the stage-1 shape and at the stage-3 student's (where the TPU
    runs its quad kernels, ops/pallas_sweep_quad.py), with seeded
    cotangents on every output; two backward runs bit-identical; then timed
    at both shapes.  Returns the JSON fields of both kernels."""
    held = Held()
    pad = sweep_pad(stage1_config())
    names = ("d_logits", "d_sigma", "d_shift")
    for i, small in enumerate(smalls):
        for with_auto, with_disp in SWEEP_FLAGS:
            inputs = seeded_sweep_inputs(small, 60 + i, dev)
            held.hold(plane_sweep(*inputs, pad, with_auto, with_disp),
                      plane_sweep_plain(*inputs, pad, with_auto, with_disp),
                      inputs, (2, 3, 4), names, i)
    timed = {}
    for at, seed in ((shape, 1), (hr_shape, 4)):
        inputs = seeded_sweep_inputs(at, seed, dev)
        for with_auto in (True, False):
            got = plane_sweep(*inputs, pad, with_auto, True)
            if not bool((got[-1][:, 5] == 0).all()):
                raise AssertionError("a fully masked row must give disp 0")
            held.hold(got, plane_sweep_plain(*inputs, pad, with_auto, True), inputs,
                      (2, 3, 4), names, 9)
            del got
            free_cache()
        if not backward_is_deterministic(inputs, pad, True):
            raise AssertionError(f"two backward runs at {at} differ")
        timed[at] = time_sweep(inputs, pad, True)
        del inputs
        free_cache()
    print(f"[sweep] plane_sweep vs plain on {', '.join(map(str, smalls))} (each with "
          f"(with_auto, with_disp) in {SWEEP_FLAGS}), at {shape} and {hr_shape} (with and "
          f"without automask), pad {pad}: {held.describe()}; two backward runs bit-identical "
          f"at both | {card}")
    for at, t in timed.items():
        print_sweep_times("sweep", at, t, card)
    fwd, bwd = sweep_fields(held, timed[shape], {hr_shape: timed[hr_shape]})
    return {"plane_sweep_fwd": fwd, "plane_sweep_bwd": bwd}


def image_grad_inputs(shape, seed, dev):
    """:func:`seeded_sweep_inputs` with src and tgt requiring grad too."""
    inputs = seeded_sweep_inputs(shape, seed, dev)
    for t in inputs[:2]:
        t.requires_grad_()
    return inputs


def head_grads_of_both_instances(inputs, pad):
    """d_logits, d_sigma, d_shift under the same seeded cotangents from the
    image-gradient instance (images require grad) and from the head-only
    instance (images detached); the automask NLL's cotangent reaches only
    the images, so the two must agree."""
    out = []
    for images in (True, False):
        args = [t.detach().requires_grad_(i in (2, 3, 4) or (images and i < 2))
                for i, t in enumerate(inputs)]
        outs = plane_sweep(*args, pad, True, True)
        g = torch.Generator(device=args[2].device).manual_seed(7)
        cts = [torch.randn(o.shape, generator=g, device=o.device) for o in outs]
        live = [i for i, o in enumerate(outs) if o.requires_grad]
        out.append(torch.autograd.grad([outs[i] for i in live], args[2:5],
                                       [cts[i] for i in live]))
    return out


# the image-gradient backward's timed shapes: stage 1, the stage-3 student,
# and a row wider than 1280 (4 pixels a thread)
SWEEP_IMG_TIMED = (SWEEP_SHAPE, SHIFT_SHAPE, (2, 63, 96, 2048))
# its cases against the twin: (shape, input seed, cotangent seed,
# with_disp); every SWEEP_SMALLS shape with and without the centre
# disparity, then the stage-3 student's and stage 1's shapes (the last,
# whose inputs phase 5b's later checks take)
SWEEP_IMG_HELD = (*((small, 70 + i, i, with_disp) for i, small in enumerate(SWEEP_SMALLS)
                    for with_disp in (True, False)),
                  (SHIFT_SHAPE, 3, 9, True), (SWEEP_SHAPE, 2, 9, True))


def image_grads_repeat(inputs, pad):
    """Two backward runs of the image-gradient instance on the same forward
    and cotangents give bit-identical d_src, d_tgt and head gradients."""
    outs = plane_sweep(*inputs, pad, True, True)
    live = [o for o in outs if o.requires_grad]
    cts = [torch.randn_like(o) for o in live]
    first = torch.autograd.grad(live, inputs[:5], cts, retain_graph=True)
    second = torch.autograd.grad(live, inputs[:5], cts)
    return all(torch.equal(a, b) for a, b in zip(first, second))


def nomix_image_cotangents(inputs, pad):
    """The no-mixture sweep on images that require grad: launch counts of
    one forward and backward, and whether src and tgt got no cotangent
    (``fused_plane_sweep_nomix`` returns zeros for them)."""
    args = [None if i == 3 else t.detach().requires_grad_(i in (0, 1, 2, 4))
            for i, t in enumerate(inputs)]
    reset_launch_counts()
    outs = plane_sweep(*args, pad, False, True)
    grads = torch.autograd.grad(sum(o.sum() for o in outs), [args[i] for i in (0, 1, 2, 4)],
                                allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    zero = all(not bool(g.any()) for g in grads[:2])
    live = all(bool(g.any()) for g in grads[2:])
    return launch_counts(), zero and live


def phase_sweep_img(card, shape=SWEEP_SHAPE, dev=torch.device("cuda"), cases=SWEEP_IMG_HELD,
                    timed=SWEEP_IMG_TIMED):
    """The backward's image-gradient instance (src and tgt require grad; the
    mixture with the automask) against ``plane_sweep_plain``'s autograd:
    d_src, d_tgt, d_logits, d_sigma, d_shift under seeded cotangents on
    every output, on ``cases``: phase 5's odd shapes (W up to 2048) with and
    without the centre disparity, and the stage-3 and stage-1 shapes; two
    runs bit-identical at each; its head gradients bit-identical to the
    head-only instance's; the mixture without the automask refused before
    any launch; the no-mixture mode's images without a cotangent through its
    head-only backward; then the entry point once with the counts zeroed,
    and the kernel timed alone and through autograd beside the head-only
    backward at each of ``timed``, with its bound, MUFU floor, registers,
    occupancy and shared memory.  Returns (the JSON fields, the launch
    count)."""
    held = Held()
    pad = sweep_pad(stage1_config())
    names = ("d_src", "d_tgt", "d_logits", "d_sigma", "d_shift")
    for at, seed, ct_seed, with_disp in cases:
        free_cache()
        inputs = image_grad_inputs(at, seed, dev)
        held.hold(plane_sweep(*inputs, pad, True, with_disp),
                  plane_sweep_plain(*inputs, pad, True, with_disp), inputs, (0, 1, 2, 3, 4),
                  names, ct_seed)
        if not image_grads_repeat(inputs, pad):
            raise AssertionError(f"two image-gradient backward runs at {at} differ")
    free_cache()
    img, plain = head_grads_of_both_instances(inputs, pad)
    head_rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(img, plain))
    if not all(torch.equal(a, b) for a, b in zip(img, plain)):
        raise AssertionError(f"head gradients of the two instances differ by {head_rel:.3e}")
    del img, plain
    reset_launch_counts()
    try:
        plane_sweep(*inputs, pad, False, True)
    except ValueError:
        pass
    else:
        raise AssertionError("image gradients without the automask must raise ValueError")
    if nonzero(launch_counts()):
        raise AssertionError(f"a refused call launched {nonzero(launch_counts())}")
    nomix, nomix_zero = nomix_image_cotangents(inputs, pad)
    if nomix != only(plane_sweep_nomix_fwd=1, plane_sweep_nomix_bwd=1) or not nomix_zero:
        raise AssertionError(f"no-mixture sweep on images that require grad: launches "
                             f"{nonzero(nomix)}, zero image cotangents {nomix_zero}")

    # the main path: the entry point forward and backward, counts zeroed
    reset_launch_counts()
    outs = plane_sweep(*inputs, pad, True, True)
    torch.autograd.grad(sum(o.sum() for o in outs), inputs[:5])
    launches = launch_counts()
    if launches != only(plane_sweep_fwd=1, plane_sweep_img_bwd=1):
        raise AssertionError(f"image-gradient sweep launches {launches}")
    del outs, inputs
    times = {}
    for at in timed:
        free_cache()
        inputs = image_grad_inputs(at, 2, dev)
        times[at] = time_sweep_img(inputs, pad, plain=at == shape)
        del inputs
    free_cache()
    print(f"[sweep_img] plane_sweep with image gradients vs plain on "
          f"{', '.join(dict.fromkeys(str(c[0]) for c in cases))} (the small ones with and "
          f"without disp), pad {pad}: {held.describe()}; two backward runs bit-identical at "
          f"each; head gradients bit-identical to the head-only instance's; no-automask "
          f"image gradients refused before any launch; no-mixture images without a "
          f"cotangent (launches {nonzero(nomix)}); main path launches {nonzero(launches)} | "
          f"{card}")
    for at, t in times.items():
        share = t["bound"][0] / t["ms"]
        plain = (f"; twin backward {t['plain_ms']:.2f} ms" if "plain_ms" in t else "")
        print(f"[sweep_img] at {at}: image-gradient backward alone {t['ms']:.4f} ms (bound "
              f"{t['bound'][0]:.4f} ms of {t['bytes'] / 1e6:.1f} MB, {share:.1%} of it; MUFU "
              f"floor {t['mufu_ms']:.4f} ms), through autograd {t['autograd_ms']:.4f} ms; the "
              f"head-only backward alone {t['heads_ms']:.4f} ms in the same call{plain}; "
              f"{t['info']}; no single PyTorch call computes it | {card}")
    t = times[shape]
    fields = {**held.bwd_fields(), "ms": t["ms"], "autograd_ms": t["autograd_ms"],
              "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
              "library_ms": None, "mufu_floor_ms": t["mufu_ms"],
              "head_only_bwd_ms": t["heads_ms"], "head_grads_rel_diff": head_rel,
              "head_grads_bit_identical": True, "bit_identical": True,
              "kernel_info": t["kernel_info"], "shape": list(shape),
              "at": [{"shape": list(at), "ms": x["ms"], "head_only_bwd_ms": x["heads_ms"],
                      "bound_ms": x["bound"][0], "mufu_floor_ms": x["mufu_ms"],
                      "kernel_info": x["kernel_info"]}
                     for at, x in times.items() if at != shape]}
    return {"plane_sweep_img_bwd": fields}, launches["plane_sweep_img_bwd"]


def time_sweep_img(inputs, pad, plain=True):
    """The image-gradient backward alone (the library entry point on the
    forward's statistics) and through autograd, the head-only backward
    alone on the same operands, the twin's backward (``plain``), the bound
    (the mixture backward's bytes plus g_nll_auto read and d_src, d_tgt
    written), the MUFU floor, and both instances' registers, blocks an SM
    and shared memory."""
    src, tgt, logits, sigma, shift, mask = inputs
    B, N, H, W = logits.shape
    limit = shift_max(pad)
    with torch.no_grad():
        new = lambda *size: torch.empty(size, device=logits.device)
        rgb, nll, nll_auto, disp, stats = (new(B, 3, H, W), new(B, H, W), new(B, H, W),
                                           new(B, H, W), new(B, 7, H, W))
        _build.launch("pdt_plane_sweep_fwd", src, tgt, logits, sigma, shift, mask, rgb, nll,
                      nll_auto, disp, stats, B, N, H, W, limit, 1, 1, 1)
        g_rgb, g_nll, g_auto, g_disp = (torch.randn_like(x) for x in (rgb, nll, nll_auto, disp))
        heads = (torch.empty_like(logits), torch.empty_like(sigma), torch.empty_like(shift))
        images = (torch.empty_like(src), torch.empty_like(tgt))
        common = (src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll)
        ms = launch_ms("pdt_plane_sweep_bwd_img", (*common, g_auto, g_disp, *images, *heads),
                       B, N, H, W, limit, 1)
        heads_ms = launch_ms("pdt_plane_sweep_bwd", (*common, g_disp, *heads),
                             B, N, H, W, limit, 1, 1)
        del rgb, nll, nll_auto, disp, stats, g_rgb, g_nll, g_auto, g_disp, heads, images
    out = plane_sweep(*inputs, pad, True, True)
    cts = [torch.randn_like(o) for o in out]
    wrt = inputs[:5]
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(out, wrt, cts, retain_graph=True))
    row = B * H * W * 4
    moved = sweep_bounds(inputs)[1][0] + row + nbytes(src, tgt)
    info = sweep_kernel_info(1, True, N, W, image_grads=True)
    head_info = sweep_kernel_info(1, True, N, W)
    got = {"ms": ms, "heads_ms": heads_ms, "autograd_ms": autograd_ms, "bytes": moved,
           "bound": bound(moved, 120 * logits.numel()),
           "mufu_ms": mufu_floor_ms(logits.numel(), sweep_mufu(True, True, "bwd", True)),
           "kernel_info": info, "head_only_kernel_info": head_info,
           "info": (f"registers {info['registers']} (spills {info['spill_bytes']} B), "
                    f"{info['threads']} threads a block, {info['blocks_per_sm']} blocks an SM "
                    f"({info['blocks_per_sm'] * info['threads'] // 32} warps), "
                    f"{info['smem_bytes']} B shared; the head-only instance "
                    f"{head_info['registers']} registers, {head_info['blocks_per_sm']} blocks "
                    f"an SM, {head_info['smem_bytes']} B")}
    if plain:
        twin = lambda: plane_sweep_plain(*inputs, pad, True, True)
        with torch.no_grad():
            plain_fwd_ms = cuda_ms(twin, warmup=1, reps=3)
        got["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(twin(), wrt, cts),
                                  warmup=1, reps=3) - plain_fwd_ms
    return got


# each kernel's counter: (the wrapper that counts, its attribute)
COUNTERS = {"disp_head_fwd": (disp_head, "launches"),
            "plane_sweep_fwd": (plane_sweep, "fwd_launches"),
            "plane_sweep_bwd": (plane_sweep, "bwd_launches"),
            "row_shift_fwd": (row_shift, "launches"),
            "head_epilogue_fwd": (head_epilogue, "fwd_launches"),
            "head_epilogue_bwd": (head_epilogue, "bwd_launches"),
            "disp_head_bwd": (disp_head, "bwd_launches"),
            "warp2d_fwd": (warp2d, "fwd_launches"),
            "warp2d_bwd": (warp2d, "bwd_launches"),
            "plane_sweep_nomix_fwd": (plane_sweep, "nomix_fwd_launches"),
            "plane_sweep_nomix_bwd": (plane_sweep, "nomix_bwd_launches"),
            "warp2d_nosigma_fwd": (warp2d, "nosigma_fwd_launches"),
            "warp2d_nosigma_bwd": (warp2d, "nosigma_bwd_launches"),
            "plane_sweep_img_bwd": (plane_sweep, "img_bwd_launches"),
            "plane_sweep_bf16_fwd": (plane_sweep, "bf16_fwd_launches"),
            "plane_sweep_bf16_bwd": (plane_sweep, "bf16_bwd_launches"),
            "plane_sweep_nomix_bf16_fwd": (plane_sweep, "bf16_nomix_fwd_launches"),
            "plane_sweep_nomix_bf16_bwd": (plane_sweep, "bf16_nomix_bwd_launches"),
            "warp2d_bf16_fwd": (warp2d, "bf16_fwd_launches"),
            "warp2d_bf16_bwd": (warp2d, "bf16_bwd_launches"),
            "warp2d_nosigma_bf16_fwd": (warp2d, "bf16_nosigma_fwd_launches"),
            "warp2d_nosigma_bf16_bwd": (warp2d, "bf16_nosigma_bwd_launches")}

# float32 runs of this call (model name -> (ms a step, peak GB allocated)),
# which the bf16 phase prints beside its own
F32_RUNS = {}


def launch_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


# the Trainer's image panels since the last reset: how many were built (one
# eval-mode forward each; only where a TensorBoard writer exists) and their
# launches, which the trainer phases add to what their runs must launch
PANELS = {"built": 0, "launches": {}}


def reset_launch_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    PANELS.update(built=0, launches={})


def count_panels():
    """Wrap ``Trainer.log_images`` so that :data:`PANELS` counts the panels
    it builds and their launches."""
    log_images = Trainer.log_images

    def counted(self, mode, batch, step=None):
        built = self.logger.has_writer(mode)
        before = launch_counts()
        log_images(self, mode, batch, step)
        PANELS["built"] += int(built)
        for k, v in launch_counts().items():
            if v != before[k]:
                PANELS["launches"][k] = PANELS["launches"].get(k, 0) + v - before[k]

    Trainer.log_images = counted


def with_panels(want, eval_forward):
    """``want`` plus the panels' launches, each panel held to one eval
    forward's launches ``eval_forward``."""
    per = nonzero(eval_forward)
    if PANELS["launches"] != nonzero({k: v * PANELS["built"] for k, v in per.items()}):
        raise AssertionError(f"{PANELS['built']} panels launched {PANELS['launches']}, "
                             f"want {per} each")
    return {k: v + PANELS["launches"].get(k, 0) for k, v in want.items()}


class PeakByOp(TorchDispatchMode):
    """Device memory around every aten op while it is active: the bytes
    allocated before and after the op and the allocator's peak inside it
    (its peak statistic reset at the op's start).  Inside minus the larger
    of before and after is the op's own transient: cuDNN's workspace and
    the op's temporaries.  A peak between two ops the mode does not see is
    kept too, as "between ops"."""

    def __init__(self, dev):
        super().__init__()
        self.dev = dev
        self.peak = (0, "", 0)            # (bytes, op, its transient)
        self.boundary = 0                 # most bytes live between ops
        self.conv_transient = (0, "")     # largest transient of a convolution
        self.ops = self.backward_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dev = self.dev
        gap = torch.cuda.max_memory_allocated(dev)
        if gap > self.peak[0]:
            self.peak = (gap, "between ops", 0)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = func(*args, **(kwargs or {}))
        inside = torch.cuda.max_memory_allocated(dev)
        after = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        name = str(func.overloadpacket.__name__)
        transient = inside - max(before, after)
        self.ops += 1
        self.backward_ops += int("backward" in name)
        self.boundary = max(self.boundary, before, after)
        if inside > self.peak[0]:
            self.peak = (inside, name, transient)
        if "conv" in name and transient > self.conv_transient[0]:
            self.conv_transient = (transient, name)
        return out


def memory_by_op(step, dev):
    """Run ``step()`` once under :class:`PeakByOp`; returns its summary in GB."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with PeakByOp(dev) as mode:
        step()
    torch.cuda.synchronize(dev)
    peak, op, transient = mode.peak
    return {"peak_gb": peak / 1e9, "peak_op": op, "peak_op_transient_gb": transient / 1e9,
            "most_live_between_ops_gb": mode.boundary / 1e9,
            "largest_conv_transient_gb": mode.conv_transient[0] / 1e9,
            "largest_conv_transient_op": mode.conv_transient[1],
            "aten_ops": mode.ops, "backward_ops": mode.backward_ops}


def free_cache():
    """Return the memory of freed tensors to the card, so that the next
    phase's reserved memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """The stage-1 step on the card; returns the launch counts of its run."""
    free_cache()
    cfg = stage1_config(allow_random_pc=True)       # seeded random VGG19
    bundle = ModelBundle(cfg, dev)
    optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 1000)
    train_step = make_train_step(bundle, optimizer, scheduler)
    batch = batch_to_tensors(make_stereo_batch(cfg.per_step_batch, cfg.data.height,
                                               cfg.data.width, seed=0), dev)
    first = {k: p.detach().clone() for k, p in bundle.model.named_parameters()}

    reset_launch_counts()
    times, losses = [], []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = train_step(batch)
        torch.cuda.synchronize(dev)               # the losses stay on the device
        times.append(time.perf_counter() - t0)
        losses.append(host_losses(out))
    launches = launch_counts()
    n = warmup + steps
    want = only(plane_sweep_fwd=n, plane_sweep_bwd=n, head_epilogue_fwd=n,
                head_epilogue_bwd=n)
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    reserved_gb = torch.cuda.max_memory_reserved(dev) / 1e9
    check_losses(losses, cfg)
    moved = sum(int(not torch.equal(p, first[k]))
                for k, p in bundle.model.named_parameters())
    if moved < len(first) // 2:
        raise AssertionError(f"only {moved} of {len(first)} parameters changed")
    memory = memory_by_op(lambda: train_step(batch), dev)

    reset_launch_counts()
    metrics = make_eval_step(bundle)(batch)
    eval_launches = launch_counts()
    if (eval_launches["disp_head_fwd"] != 1 or eval_launches["head_epilogue_fwd"] != 1
            or not all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"validation: launches {eval_launches}, metrics {metrics}")

    step_ms = statistics.median(times[warmup:]) * 1e3
    cpu = check_step_against_cpu(stage1_config(data=DataConfig(height=64, width=192)), dev)
    print(f"[train] stage1_config ResNet-{cfg.model.num_layers} DenseASPP "
          f"{cfg.model.planes.disp_levels}+{cfg.model.planes.xz_levels} planes VGG19 "
          f"alpha_pc {cfg.loss.alpha_pc} at {cfg.data.width}x{cfg.data.height}, batch "
          f"{cfg.per_step_batch} flipped to {cfg.effective_batch}: {warmup}+{steps} steps, "
          f"launches {launches}, {moved}/{len(first)} parameter tensors moved, "
          f"first/last losses {json.dumps(losses[0])} {json.dumps(losses[-1])}")
    print(f"[train] validation step: launches {eval_launches}, metrics "
          f"{json.dumps(metrics)}")
    print(f"[train] card vs CPU at 64x192 (same weights, one step): {json.dumps(cpu)}")
    print(f"[train] step {step_ms:.2f} ms median of {steps} (host clock around "
          f"synchronised steps, after {warmup} warm-up), "
          f"{cfg.effective_batch / step_ms * 1e3:.2f} imgs/s, peak device memory "
          f"{peak_gb:.2f} GB allocated, {reserved_gb:.2f} GB reserved; float32, TF32 "
          f"off for cudnn and matmul | {card}")
    print(f"[train] memory of one more step by aten op: {json.dumps(memory)} | {card}")
    return launches


def distinct_teacher(bundle, seed):
    """Under ``self_distillation``, a frozen teacher for ``bundle`` with
    seeded weights of its own."""
    if bundle.cfg.loss.self_distillation <= 0:
        return False
    init_weights_(bundle.freeze_teacher(), torch.Generator().manual_seed(seed))
    return True


def step_batch(cfg, seed):
    """A synthetic batch for one step of ``cfg``, with its temporal frames.
    Under a 2-D warp the stereo pose is turned slightly off the pure
    x-translation, whose integer y coordinates make the bilinear y-gradient
    a subgradient that two devices may take on either side."""
    batch = make_stereo_batch(cfg.per_step_batch, cfg.data.height, cfg.data.width,
                              seed=seed, novel_frame_ids=cfg.novel_frame_ids)
    if cfg.warp_type != "disp_warp":
        jitter = transformation_from_parameters(torch.tensor([[[0.002, -0.001, 0.003]]]),
                                                torch.tensor([[[0.001, 0.004, 0.002]]]))
        batch["Rt_r"] = (torch.from_numpy(batch["Rt_r"]) @ jitter).numpy()
    return batch


def check_step_against_cpu(cfg, dev, seed=1):
    """One training step of ``cfg`` on the card and on the CPU (plain twin)
    from the same weights, batch and dropout masks; returns the worst errors.

    - losses at rtol 1e-3;
    - gradients, each leaf of the depth model and the pose nets against the
      float64 gradient of the same step on the CPU: relative L2 error <= 0.1.
      Float32 rounding through train-mode BatchNorm over few pixels is
      amplified (the CPU's own float32 error is printed beside the card's),
      and cuDNN's convolutions round differently again, so the bound is one
      an error of the method, not of rounding, would exceed;
    - post-Adam parameters at atol 1e-4 wherever the step's direction is
      fixed: the first Adam step is ~lr * sign(g), so elements whose float64
      gradient is under the card's and the CPU's largest float32 error on
      their leaf may differ by one step each way (2 * lr), and are held to
      that.

    Under ``self_distillation`` every bundle's teacher gets weights of its
    own (seed + 1), so the step is held with a teacher that is not the
    student.
    """
    batch = step_batch(cfg, seed)
    cpu_dev = torch.device("cpu")
    bundles = (ModelBundle(cfg, dev), ModelBundle(cfg, cpu_dev))
    for bundle in bundles:
        distinct_teacher(bundle, cfg.seed + 1)
    losses = []
    for bundle in bundles:
        opt, sched = make_optimizer(cfg, bundle.parameters(), 1000)
        losses.append(host_losses(make_train_step(bundle, opt, sched)(
            batch_to_tensors(batch, bundle.device))))
    for k, v in losses[1].items():
        if not math.isclose(losses[0][k], v, rel_tol=STEP_LOSS_RTOL, abs_tol=1e-7):
            raise AssertionError(f"{k}: card {losses[0][k]} vs CPU {v}")

    ref = ModelBundle(cfg, cpu_dev)               # float64, same first-step masks
    for net in ref.nets().values():
        net.double()
    if ref.pc is not None:
        ref.pc.double()
    if distinct_teacher(ref, cfg.seed + 1):
        ref.teacher.double()
    out = process_batch(ref.train(), {k: v.double() for k, v in
                                      batch_to_tensors(batch, cpu_dev).items()},
                        torch.Generator().manual_seed(cfg.seed << 32))
    out["loss/total_loss"].backward()
    g64 = {k: p.grad for k, p in ref.named_parameters()}
    card, cpu = (dict(b.named_parameters()) for b in bundles)
    after = [{k: v.detach().double().cpu() for k, v in b.named_parameters()}
             for b in bundles]
    lr = cfg.optim.learning_rate
    worst = {"grad_l2_rel_card": 0.0, "grad_l2_rel_cpu": 0.0, "param_err": 0.0}
    checked = total = 0
    for k, g in g64.items():
        e_card = card[k].grad.cpu().double() - g
        e_cpu = cpu[k].grad.double() - g
        if g.abs().max().item() > 1e-6:    # else mathematically zero (bias under BN)
            for name, e in (("card", e_card), ("cpu", e_cpu)):
                rel = (e.norm() / g.norm()).item()
                worst[f"grad_l2_rel_{name}"] = max(worst[f"grad_l2_rel_{name}"], rel)
                if rel > 0.1:
                    raise AssertionError(f"{k}: {name} gradient off float64 by {rel:.3e} (L2)")
        err = (after[0][k] - after[1][k]).abs()
        fixed = g.abs() > e_card.abs().max() + e_cpu.abs().max() + 1e-9
        fixed_err = err[fixed].max().item() if bool(fixed.any()) else 0.0
        if fixed_err > STEP_PARAM_ATOL or err.max().item() > 2 * lr + STEP_PARAM_ATOL:
            raise AssertionError(f"{k}: post-Adam parameters differ by {err.max().item():.3e}")
        worst["param_err"] = max(worst["param_err"], fixed_err)
        checked += int(fixed.sum())
        total += g.numel()
    if checked < total // 2:
        raise AssertionError(f"only {checked} of {total} weights have a fixed direction")
    worst["loss_rel_err"] = max(abs(losses[0][k] / v - 1) for k, v in losses[1].items())
    worst["share_of_weights_held_at_atol"] = checked / total
    return worst


def phase_epilogue(card, shape=SHIFT_SHAPE, dev=torch.device("cuda")):
    """The head-epilogue kernels against their twin; returns the JSON
    fields of both."""
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(5)
    raw_l = 2.0 * torch.randn(shape, generator=g, device=dev)
    raw_s = 16.0 * torch.rand(shape, generator=g, device=dev) - 8.0
    raw_s[:, 0, :2] = 40.0                     # sigmoid rounds to 1
    raw_s[:, 1, :2] = -40.0                    # clipped to 0.01
    mask = (torch.rand((B, N, H, 1), generator=g, device=dev) > 0.2).float()
    mask[:, :(49 * N) // 63] = 1.0             # vertical planes are never masked
    heads = [raw_l.requires_grad_(), raw_s.requires_grad_()]
    cts = [torch.randn(shape, generator=g, device=dev) for _ in range(2)]
    got = head_epilogue(*heads, mask)
    torch.cuda.synchronize(dev)
    want = head_epilogue_plain(*heads, mask)
    fwd_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    for name, a, b in zip(("logits", "sigma"), got, want):
        torch.testing.assert_close(a, b, msg=name, **TOL)
    d_got = torch.autograd.grad(got, heads, cts, retain_graph=True)
    torch.cuda.synchronize(dev)
    d_want = torch.autograd.grad(want, heads, cts, retain_graph=True)
    bwd_err = max((a - b).abs().max().item() for a, b in zip(d_got, d_want))
    for name, a, b in zip(("d_raw_logits", "d_raw_sigma"), d_got, d_want):
        torch.testing.assert_close(a, b, msg=name, **TOL)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: head_epilogue(*heads, mask))
        plain_fwd_ms = cuda_ms(lambda: head_epilogue_plain(*heads, mask))
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(got, heads, cts, retain_graph=True))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(head_epilogue_plain(*heads, mask),
                                                   heads, cts))
    # each input read once, each output written once; ~6 flops a
    # pixel-plane each way (the mask product, the sigmoid, the clip)
    fwd_bytes = nbytes(raw_l, raw_s, mask, *got)
    bwd_bytes = nbytes(*cts, got[1], mask, *d_got)
    fwd_bound = bound(fwd_bytes, 6 * raw_l.numel())
    bwd_bound = bound(bwd_bytes, 6 * raw_l.numel())
    del heads, cts, got, want, d_got, d_want
    free_cache()
    trim = epilogue_n_minus_1(card, SWEEP_SHAPE, dev)
    print(f"[epilogue] head_epilogue vs plain at {shape}, row-constant mask: forward "
          f"max_abs_err {fwd_err:.3e}, backward {bwd_err:.3e} (rtol {TOL['rtol']}, atol "
          f"{TOL['atol']}) | {card}")
    print(f"[epilogue] forward kernel {fwd_ms:.4f} ms ({fwd_bytes / fwd_ms / 1e9:.2f} TB/s "
          f"of {fwd_bytes / 1e6:.1f} MB, {fwd_bound[0] / fwd_ms:.1%} of the bound "
          f"{fwd_bound[0]:.4f} ms), backward kernel {bwd_ms:.4f} ms "
          f"({bwd_bytes / bwd_ms / 1e9:.2f} TB/s of {bwd_bytes / 1e6:.1f} MB, "
          f"{bwd_bound[0] / bwd_ms:.1%} of the bound {bwd_bound[0]:.4f} ms); twin "
          f"forward {plain_fwd_ms:.4f} ms, forward+backward {plain_ms:.4f} ms; no "
          f"single PyTorch call computes either | {card}")
    print(f"[epilogue] render_probability's N - 1 logit planes: {json.dumps(trim)} | {card}")
    return {
        "head_epilogue_fwd": {"max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms,
                              "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                              "library_ms": None},
        "head_epilogue_bwd": {"max_abs_err": bwd_err, "ms": bwd_ms,
                              # the twin's backward: its forward+backward less its forward
                              "plain_ms": plain_ms - plain_fwd_ms,
                              "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                              "library_ms": None},
    }


def epilogue_n_minus_1(card, shape, dev):
    """The head-epilogue kernels in their N - 1 mode (render_probability:
    ``(B, N - 1, H, W)`` logits beside ``(B, N, H, W)`` sigma and the
    row-constant mask) against their plain version at the render step's
    ``shape``, then timed beside the N mode at the same shape with each
    one's byte bound; returns what the phase prints."""
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(6)
    raw_l = 2.0 * torch.randn((B, N - 1, H, W), generator=g, device=dev)
    raw_s = 16.0 * torch.rand(shape, generator=g, device=dev) - 8.0
    raw_s[:, 0, :2] = 40.0
    raw_s[:, 1, :2] = -40.0
    mask = (torch.rand((B, N, H, 1), generator=g, device=dev) > 0.2).float()
    heads = [raw_l.requires_grad_(), raw_s.requires_grad_()]
    cts = [torch.randn(t.shape, generator=g, device=dev) for t in heads]
    got = head_epilogue(*heads, mask)
    want = head_epilogue_plain(*heads, mask)
    torch.cuda.synchronize(dev)
    out = {"shape": [B, N - 1, H, W], "sigma_shape": list(shape)}
    out["fwd_max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(got, want))
    for name, a, b in zip(("logits", "sigma"), got, want):
        torch.testing.assert_close(a, b, msg=name, **TOL)
    d_got = torch.autograd.grad(got, heads, cts, retain_graph=True)
    d_want = torch.autograd.grad(want, heads, cts, retain_graph=True)
    torch.cuda.synchronize(dev)
    out["bwd_max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(d_got, d_want))
    for name, a, b in zip(("d_raw_logits", "d_raw_sigma"), d_got, d_want):
        torch.testing.assert_close(a, b, msg=name, **TOL)
    full_l = torch.randn(shape, generator=g, device=dev).requires_grad_()
    full_got = head_epilogue(full_l, heads[1], mask)
    full_cts = [torch.randn(shape, generator=g, device=dev), cts[1]]
    for mode, (heads_m, got_m, cts_m) in (("n_minus_1", (heads, got, cts)),
                                           ("n", ([full_l, heads[1]], full_got, full_cts))):
        with torch.no_grad():
            out[f"{mode}_fwd_ms"] = cuda_ms(lambda: head_epilogue(*heads_m, mask))
        out[f"{mode}_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(got_m, heads_m, cts_m,
                                                                    retain_graph=True))
        # each input read once, each output written once
        out[f"{mode}_fwd_bound_ms"] = bound(nbytes(*heads_m, mask, *got_m), 0)[0]
        out[f"{mode}_bwd_bound_ms"] = bound(nbytes(*cts_m, got_m[1], mask, *heads_m), 0)[0]
    with torch.no_grad():
        out["plain_fwd_ms"] = cuda_ms(lambda: head_epilogue_plain(*heads, mask))
    return out


def seeded_shift_inputs(shape, pad, seed, dev):
    """The teacher's row-shift operands: maps in [0, 1) and signed shifts,
    +/- the disparities of 49/63 row-constant vertical planes up to ~320 and
    of ground planes that vary by row, with one plane at an integer shift
    and two beyond the clip at either end."""
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *size: torch.rand(size, generator=g, device=dev)
    nv = (49 * N) // 63
    vert = (2.0 * (160.0 ** rand(B, 1, nv))).expand(B, H, nv)
    ground = 40.0 * rand(B, 1, N - nv) + rand(B, 1, N - nv) * torch.arange(
        H, device=dev)[None, :, None] * (200.0 / H)
    sign = torch.where(rand(B, 1, N) < 0.5, -1.0, 1.0)
    shift = (torch.cat([vert, ground], -1) * sign).contiguous()
    lim = shift_limit(pad)
    shift[:, :, 0] = torch.round(shift[:, :, 0])
    shift[:, :, 1] = lim + 50.25
    shift[:, :, 2] = -(lim + 80.5)
    return rand(B, N, H, W), shift


def phase_shift(card, shape=SHIFT_SHAPE, dev=torch.device("cuda")):
    """The row-shift kernel against its twin; returns its JSON fields."""
    pad = sweep_pad(self_distillation_config())
    maps, shift = seeded_shift_inputs(shape, pad, 3, dev)
    got = row_shift(maps, shift, pad)
    torch.cuda.synchronize(dev)
    want = row_shift_plain(maps, shift, pad)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **TOL)
    ms = cuda_ms(lambda: row_shift(maps, shift, pad))
    plain_ms = cuda_ms(lambda: row_shift_plain(maps, shift, pad), warmup=1, reps=5)

    # the library call: the same 2-tap filter through F.grid_sample on
    # (B*N, 1, H, W), the grid built outside the timed region
    B, N, H, W = shape
    lim = shift_limit(pad)
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    gx = (xs + shift.clamp(-lim, lim).transpose(1, 2)[..., None]) * (2.0 / (W - 1)) - 1.0
    gy = (torch.arange(H, device=dev, dtype=torch.float32) * (2.0 / (H - 1)) - 1.0)
    grid = torch.stack([gx, gy[None, None, :, None].expand_as(gx)], -1).view(B * N, H, W, 2)
    flat = maps.view(B * N, 1, H, W)
    sample = lambda: F.grid_sample(flat, grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=True)
    lib_err = (sample().view(shape) - got).abs().max().item()
    library_ms = cuda_ms(sample)
    del grid, flat

    moved = nbytes(maps, shift, got)
    bound_ms, bound_by = bound(moved, 3 * maps.numel())
    print(f"[shift] row_shift vs plain at {shape}, pad {pad} (clip +/-{lim:.0f}), signed "
          f"shifts: max_abs_err {err:.3e} (rtol {TOL['rtol']}, atol {TOL['atol']}); "
          f"F.grid_sample vs kernel max_abs_err {lib_err:.3e} | {card}")
    print(f"[shift] kernel {ms:.4f} ms ({moved / ms / 1e9:.2f} TB/s of "
          f"{moved / 1e6:.1f} MB moved, {bound_ms / ms:.1%} of the bound {bound_ms:.4f} ms, "
          f"{bound_by}); twin {plain_ms:.3f} ms; F.grid_sample {library_ms:.3f} ms "
          f"(CUDA events, median) | {card}")
    return {"row_shift_fwd": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": library_ms}}


class SyntheticStereo:
    """Unbatched synthetic stereo samples in the trainer's dataset protocol
    (``__len__``, ``getitem(index, epoch)``) at one size, with the temporal
    frames ``novel_frame_ids``."""

    def __init__(self, n, height, width, novel_frame_ids=()):
        self.n, self.height, self.width = n, height, width
        self.novel_frame_ids = novel_frame_ids

    def __len__(self):
        return self.n

    def getitem(self, index, epoch=0):
        batch = make_stereo_batch(1, self.height, self.width, seed=index,
                                  novel_frame_ids=self.novel_frame_ids)
        return {k: v[0] for k, v in batch.items()}


def host_losses(losses):
    """A step's losses as floats: ``make_train_step`` returns them on the
    device, so reading them waits for the step."""
    return {k: float(v) for k, v in losses.items()}


def check_losses(losses, cfg):
    for ls in losses:
        if not all(math.isfinite(v) for v in ls.values()):
            raise AssertionError(f"non-finite loss: {ls}")
        total = (ls["loss/ph_loss"] + cfg.loss.alpha_pc * ls["loss/pc_loss"]
                 + cfg.loss.alpha_smooth * ls["loss/smooth_loss"]
                 + cfg.loss.alpha_self * ls.get("loss/self_loss", 0.0)
                 + cfg.loss.self_distillation * ls.get("loss/disp_loss", 0.0))
        if (cfg.loss.alpha_self > 0) != ("loss/self_loss" in ls):
            raise AssertionError(f"loss/self_loss present iff alpha_self > 0: {ls}")
        if not math.isclose(ls["loss/total_loss"], total, rel_tol=1e-5, abs_tol=1e-6):
            raise AssertionError(f"total {ls['loss/total_loss']} != {total}")


def phase_distill(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """Stage 2 -> stage 3 through the Trainer at full width; returns the
    launch counts of the stage-3 run."""
    free_cache()
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_") as log_dir:
        cfg2 = hr_finetune_config(log_dir=log_dir, allow_random_pc=True)
        h, w = cfg2.data.height, cfg2.data.width
        stage2 = Trainer(cfg2, datasets=(SyntheticStereo(2 * cfg2.per_step_batch, h, w),
                                         SyntheticStereo(cfg2.per_step_batch, h, w)),
                         device=dev)
        reset_launch_counts()
        stage2.train()
        stage2.close()
        s2_launches = launch_counts()
        want = with_panels(only(disp_head_fwd=1, plane_sweep_fwd=2, plane_sweep_bwd=2,
                                head_epilogue_fwd=3, head_epilogue_bwd=2),   # 2 steps + val
                           {"disp_head_fwd": 1, "head_epilogue_fwd": 1})
        if s2_launches != want:
            raise AssertionError(f"stage-2 launches {s2_launches}, want {want}")
        del stage2                      # its model, VGG and Adam leave the card
        free_cache()
        ckpt = os.path.join(log_dir, cfg2.model_name, "last_models")
        payload = load_checkpoint(ckpt)
        saved = {f"{name}.{k}": v for name in ("encoder", "depth")
                 for k, v in payload[name].items() if torch.is_tensor(v)}

        cfg = self_distillation_config(log_dir=log_dir, load_weights_folder=ckpt,
                                       allow_random_pc=True, optim=dataclasses.replace(
                                           self_distillation_config().optim, num_epochs=1))
        b = cfg.per_step_batch
        trainer = Trainer(cfg, datasets=(SyntheticStereo(b * (warmup + steps), h, w),
                                         SyntheticStereo(b, h, w)), device=dev)
        teacher, student = trainer.bundle.teacher, trainer.bundle.model
        for name, module in (("teacher", teacher), ("student", student)):
            if any(not torch.equal(v.cpu(), saved[k]) for k, v in module.state_dict().items()):
                raise AssertionError(f"the {name} is not the restored stage-2 model")

        times, losses, val = [], [], {}
        step_fn, val_fn = trainer.train_step, trainer.val

        def timed_step(batch):
            if len(times) == warmup:
                torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts()
            t0 = time.perf_counter()
            out = step_fn(batch)
            torch.cuda.synchronize(dev)           # the losses stay on the device
            times.append(time.perf_counter() - t0)
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != DISTILL_STEP:
                raise AssertionError(f"stage-3 step launches {delta}, want {DISTILL_STEP}")
            losses.append(host_losses(out))
            return out

        trainer.train_step = timed_step
        trainer.val = lambda epoch: val.setdefault("metrics", val_fn(epoch))
        reset_launch_counts()
        trainer.train()
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        reserved_gb = torch.cuda.max_memory_reserved(dev) / 1e9
        trainer.close()
        n = warmup + steps
        want = {k: v * n for k, v in DISTILL_STEP.items()}
        want["disp_head_fwd"] += 1                      # the validation batch
        want["head_epilogue_fwd"] += 1
        want = with_panels(want, {"disp_head_fwd": 1, "head_epilogue_fwd": 1})
        if launches != want or len(times) != n:
            raise AssertionError(f"stage-3 run launches {launches} in {len(times)} "
                                 f"steps, want {want} in {n}")
        check_losses(losses, cfg)
        if not val.get("metrics") or not all(math.isfinite(v) for v in val["metrics"].values()):
            raise AssertionError(f"validation metrics {val}")
        if any(not torch.equal(v.cpu(), saved[k]) for k, v in teacher.state_dict().items()):
            raise AssertionError("the teacher changed during training")
        moved = sum(int(not torch.equal(v.cpu(), saved[k]))
                    for k, v in student.state_dict().items() if v.is_floating_point())
        n_float = sum(int(v.is_floating_point()) for v in student.state_dict().values())
        if moved < n_float // 2:
            raise AssertionError(f"only {moved} of {n_float} student tensors moved")

        batch = batch_to_tensors(make_stereo_batch(b, h, w, seed=0), dev)
        memory = memory_by_op(lambda: step_fn(batch), dev)
        with torch.no_grad():
            teacher_ms = cuda_ms(lambda: generate_post_process_disp(
                teacher, batch["color_aug_l"], batch["grid"], sweep_pad(cfg)),
                warmup=1, reps=5)
        del trainer, teacher, student, batch
        free_cache()
    step_ms = statistics.median(times[warmup:]) * 1e3
    cpu = check_step_against_cpu(self_distillation_config(
        data=DataConfig(height=64, width=192)), dev)
    print(f"[distill] stage 2 (hr_finetune_config {w}x{h}, batch {cfg2.per_step_batch} "
          f"flipped to {cfg2.effective_batch}): 2 steps, launches {s2_launches}, saved "
          f"last_models; stage 3 (self_distillation_config ResNet-{cfg.model.num_layers} "
          f"DenseASPP {cfg.model.planes.disp_levels}+{cfg.model.planes.xz_levels} planes "
          f"VGG19 alpha_pc {cfg.loss.alpha_pc}, {w}x{h}, batch {b}, teacher on {2 * b} "
          f"images) restored encoder+depth: {warmup}+{steps} steps, launches {launches} "
          f"(per step {DISTILL_STEP}, + 1 disp head and 1 head epilogue for "
          f"validation), teacher unchanged, "
          f"{moved}/{n_float} student tensors moved, first/last losses "
          f"{json.dumps(losses[0])} {json.dumps(losses[-1])}")
    print(f"[distill] validation metrics {json.dumps(val['metrics'])}")
    print(f"[distill] card vs CPU at 64x192 (stage-3 step, teacher of its own): "
          f"{json.dumps(cpu)}")
    F32_RUNS["self_distillation"] = (step_ms, peak_gb)
    print(f"[distill] stage-3 step {step_ms:.2f} ms median of {steps} (host clock around "
          f"synchronised steps, after {warmup} warm-up), {b / step_ms * 1e3:.2f} imgs/s "
          f"(student images), peak device memory {peak_gb:.2f} GB allocated, "
          f"{reserved_gb:.2f} GB reserved; teacher pass (forward on {2 * b} images + 5 "
          f"row shifts) {teacher_ms:.2f} ms = {teacher_ms / step_ms:.1%} of the step; "
          f"float32, TF32 off | {card}")
    print(f"[distill] memory of one more stage-3 step by aten op: {json.dumps(memory)} "
          f"| {card}")
    return launches


def phase_mom(card, dev=torch.device("cuda"), steps=2):
    """use_mom at the stage-1 size: 6 row-shift launches a step."""
    cfg = stage1_config(loss=LossConfig(use_mom=True))
    per_step = only(plane_sweep_fwd=1, plane_sweep_bwd=1, row_shift_fwd=6,
                    head_epilogue_fwd=1, head_epilogue_bwd=1)
    losses, _, _ = steps_held(cfg, per_step, dev, steps)
    print(f"[mom] stage1_config use_mom at {cfg.data.width}x{cfg.data.height}, batch "
          f"{cfg.per_step_batch} flipped to {cfg.effective_batch}: {steps} steps, launches "
          f"per step {nonzero(per_step)}, losses {json.dumps(losses[-1])} | {card}")


def seeded_warp_inputs(shape, seed, dev, degenerate=False, zoom=30.0, dead_plane=False,
                       edges=False):
    """2-D warp operands like a mono step's: per plane a zoom about the
    image centre (up to ``zoom`` px at the edges: ~30, the near planes under
    forward motion) plus a shift and sub-pixel noise, so that samples leave
    the image on both sides and run boundary-partial; with ``degenerate`` 5%
    of the samples at 1e12 / -3e9 and a row of NaN, as a near-singular
    homography gives them; with ``dead_plane`` the last plane of the first
    image wholly at 1e12 and the first half of the rows of the last plane
    of the last image NaN (bands of only degenerate samples); with
    ``edges`` (H >= 4) the samples of rows 0 to 3 of every plane moved to
    x in (W - 1, W), x in (-1, 0), y in (H - 1, H) and y in (-1, 0): taps at
    x0 = W - 1 and -1, y0 = H - 1 and -1, each with one tap pair outside.
    logits and sigma require grad, as do dx, dy."""
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *size: torch.rand(size, generator=g, device=dev)
    xs = torch.linspace(-1.0, 1.0, W, device=dev)
    ys = torch.linspace(-1.0, 1.0, H, device=dev)[:, None]
    zoom = zoom * rand(B, N, 1, 1) ** 2
    dx = zoom * xs + 8.0 * (rand(B, N, 1, 1) - 0.5) + 0.5 * rand(B, N, H, W)
    dy = 0.3 * zoom * ys + 2.0 * (rand(B, N, 1, 1) - 0.5) + 0.5 * rand(B, N, H, W)
    if degenerate:
        blow = rand(B, N, H, W) < 0.05
        dx = torch.where(blow, torch.full_like(dx, 1e12), dx)
        dy = torch.where(blow, torch.full_like(dy, -3e9), dy)
        dx[0, 0, H // 2] = float("nan")
    if dead_plane:
        dx[0, N - 1] = 1e12
        dy[B - 1, N - 1, : (H + 1) // 2] = float("nan")
    mask = (rand(B, N, H, W) > 0.1).float()
    src = rand(B, 3, H, W)
    logits = 2.0 * torch.randn((B, N, H, W), generator=g, device=dev)
    sigma = 0.01 + 0.99 * rand(B, N, H, W)
    if edges:
        u = 0.05 + 0.9 * rand(B, N, 4, W)                       # in (0.05, 0.95)
        x = torch.arange(W, device=dev, dtype=torch.float32)
        dx[:, :, 0] = W - 1 + u[:, :, 0] - x
        dx[:, :, 1] = u[:, :, 1] - 1 - x
        dy[:, :, 2] = H - 1 + u[:, :, 2] - 2
        dy[:, :, 3] = u[:, :, 3] - 1 - 3
    return [src, logits.requires_grad_(), sigma.requires_grad_(),
            dx.contiguous().requires_grad_(), dy.contiguous().requires_grad_(), mask]


class Held:
    """The worst errors of a kernel pair against its plain version over
    every shape it was held at: the forward's max abs error, and per
    gradient the max abs error and that error over the gradient's largest
    magnitude, with the case that set the latter (the shape of the largest
    input held, the sweep's logits)."""

    def __init__(self):
        self.fwd, self.abs, self.rel, self.worst_at = 0.0, {}, {}, {}

    def hold(self, kernel_out, plain_out, inputs, diff, names, seed, no_cotangent=()):
        """Forward outputs at TOL; the gradients of ``inputs[i] for i in
        diff`` under seeded cotangents (zero on the outputs ``no_cotangent``)
        at GRAD_TOL of each gradient's largest magnitude.  Consumes both
        autograd graphs."""
        for a, b in zip(kernel_out, plain_out):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"non-finite output at {tuple(a.shape)}")
            torch.testing.assert_close(a, b, **TOL)
            self.fwd = max(self.fwd, (a - b).abs().max().item())
        g = torch.Generator(device=a.device).manual_seed(seed)
        cts = [torch.randn(o.shape, generator=g, device=o.device) for o in kernel_out]
        for i in no_cotangent:
            cts[i].zero_()
        wrt = [inputs[i] for i in diff]
        at = tuple(max(wrt, key=lambda t: t.numel()).shape)
        # outputs with no gradient (the sweep's automask NLL) take none
        live = [i for i, o in enumerate(kernel_out) if o.requires_grad]
        pick = lambda seq: [seq[i] for i in live]
        d_got = torch.autograd.grad(pick(kernel_out), wrt, pick(cts))
        torch.cuda.synchronize()
        d_want = torch.autograd.grad(pick(plain_out), wrt, pick(cts))
        for name, a, b in zip(names, d_got, d_want):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: non-finite gradient at {tuple(a.shape)}")
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            if err > GRAD_TOL * scale:
                raise AssertionError(f"{name} at {tuple(a.shape)}: max err {err:.3e} > "
                                     f"{GRAD_TOL} x {scale:.3e}")
            self.abs[name] = max(err, self.abs.get(name, 0.0))
            rel = err / max(scale, 1e-30)
            if rel >= self.rel.get(name, 0.0):
                self.rel[name], self.worst_at[name] = rel, at

    def bwd_fields(self):
        return {"max_abs_err": max(self.abs.values()), "max_rel_err": max(self.rel.values())}

    def describe(self):
        fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})
        return (f"forward max_abs_err {self.fwd:.3e} (rtol {TOL['rtol']}, atol {TOL['atol']}); "
                f"grads max_abs_err {fmt(self.abs)}, over max |value| {fmt(self.rel)} "
                f"(<= {GRAD_TOL}), the latter worst at {json.dumps(self.worst_at)}")


def launch_ms(fn, tensors, *sizes):
    """CUDA-event time of the library entry point ``fn`` alone, on
    ``tensors`` and ``sizes`` as its wrapper passes them: no allocation, no
    autograd, no launch count."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return cuda_ms(lambda: _build.launch(fn, *ptrs, *sizes))


def warp_kernel_info(with_sigma, bf16=False, forward=False):
    """Registers, spills, block and occupancy of the warp backward kernel
    (``bf16``: of the bf16 instance's scatter kernel; ``forward``: of the
    forward kernel)."""
    out = (ctypes.c_int * 4)()
    name = f"pdt_warp2d_{'fwd' if forward else 'bwd'}_kernel_info" + ("_bf16" if bf16 else "")
    rc = getattr(_build.load_library(), name)(int(with_sigma), out)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm"), out))


def disp_kernel_info(N, W):
    """Registers, spills, block, occupancy, shared memory and chunk of the
    disp-head backward kernel at (N, W)."""
    out = (ctypes.c_int * 6)()
    rc = _build.load_library().pdt_disp_head_bwd_kernel_info(N, W, out)
    if rc != 0:
        raise RuntimeError(f"pdt_disp_head_bwd_kernel_info: CUDA error {rc}")
    return dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm", "smem_bytes",
                     "planes_a_chunk"), out))


def grid_sample_ms(src, heads, dx, dy):
    """The library call beside the 2-D warp: F.grid_sample on (B*N, C, H,
    W) [rgb | logit (| sigma)] with a prebuilt normalised grid, both built
    outside the timed region, in src's dtype (grid_sample takes one dtype,
    so under bf16 a bf16 grid); its backward also computes the rgb input's
    gradient, which the kernel skips.  Returns the forward's ms and the
    forward+backward's."""
    B, N, H, W = dx.shape
    channels = 3 + len(heads)
    with torch.no_grad():
        x = torch.arange(W, device=dx.device, dtype=torch.float32)
        y = torch.arange(H, device=dx.device, dtype=torch.float32)[:, None]
        grid = torch.stack([(dx + x) * (2.0 / (W - 1)) - 1.0,
                            (dy + y) * (2.0 / (H - 1)) - 1.0], -1).view(B * N, H, W, 2)
        grid = grid.to(src.dtype)
        stack = torch.cat([src[:, None].expand(B, N, 3, H, W),
                           *(t[:, :, None] for t in heads)], 2).view(B * N, channels, H, W)
    grid.requires_grad_()
    stack.requires_grad_()
    sample = lambda: F.grid_sample(stack, grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=True)
    with torch.no_grad():
        fwd_ms = cuda_ms(sample)
    ct = torch.randn_like(sample())
    total_ms = cuda_ms(lambda: torch.autograd.grad(sample(), (stack, grid), ct))
    del grid, stack, ct
    return fwd_ms, total_ms


def phase_warp2d(card, shape=SWEEP_SHAPE, dev=torch.device("cuda"), with_sigma=True):
    """The 2-D warp kernels against their twin on small odd shapes and at
    the mono step's shape, then timed there; returns the JSON fields of
    both.  ``with_sigma=False`` holds and times the instances without sigma
    (the recipes without the mixture)."""
    held = Held()
    # the gradients held: of logits, sigma, dx, dy (inputs 1-4), or without sigma
    diff = (1, 2, 3, 4) if with_sigma else (1, 3, 4)
    names = ("d_logits", "d_sigma", "d_dx", "d_dy") if with_sigma else ("d_logits", "d_dx", "d_dy")

    def warp_inputs(at, seed, degenerate=False, **kw):
        inputs = seeded_warp_inputs(at, seed, dev, degenerate, **kw)
        if not with_sigma:
            inputs[2] = None
        return inputs

    # W not a multiple of the 128-thread block, a row narrower than it
    smalls = ((2, 5, 7, 200), (1, 3, 16, 130), (2, 4, 9, 64))
    for i, small in enumerate(smalls):
        for degenerate in (False, True):
            inputs = warp_inputs(small, 10 + i, degenerate)
            held.hold(warp2d(*inputs), warp2d_plain(*inputs), inputs, diff, names, i)
    # zooms up to 200 px at the edges (taps far from the sample's own row and
    # column); planes and half-planes of only degenerate samples; more planes
    # than the grid's z axis takes (B * N > 65535: launches of whole images);
    # the bf16 forward's edge cases, and src and the heads as views ending
    # their allocation
    extras = (((2, 3, 96, 330), dict(zoom=200.0)),
              ((2, 3, 24, 100), dict(degenerate=True, dead_plane=True)),
              ((2, 33000, 2, 5), {})) + WARP_FWD_EDGES + (WARP_VIEW_CASE,)
    for i, (small, kw) in enumerate(extras):
        inputs = warp_inputs(small, 15 + i, **kw)
        if (small, kw) == WARP_VIEW_CASE:
            inputs[:3] = [None if t is None else at_allocation_end(t) for t in inputs[:3]]
        held.hold(warp2d(*inputs), warp2d_plain(*inputs), inputs, diff, names, 5 + i)
    del inputs
    free_cache()
    # the main path's shape, where the atomic scatter meets the most contention
    inputs = warp_inputs(shape, 20)
    held.hold(warp2d(*inputs), warp2d_plain(*inputs), inputs, diff, names, 3)
    free_cache()

    B, N, H, W = shape
    src, logits, sigma, dx, dy, mask = inputs
    out = warp2d(*inputs)
    cts = [torch.randn_like(o) for o in out]
    wrt = [inputs[i] for i in diff]
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: warp2d(*inputs))
        plain_fwd_ms = cuda_ms(lambda: warp2d_plain(*inputs), warmup=1, reps=3)
        # the backward kernel alone, on buffers zeroed once (its atomics add
        # into them; the values do not change the time)
        d_bufs = [None if t is None else torch.zeros_like(t) for t in (logits, sigma, dx, dy)]
        g_sigma = cts[2] if with_sigma else None
        bwd_ms = launch_ms("pdt_warp2d_bwd", (*inputs, cts[0], cts[1], g_sigma, *d_bufs),
                           B, N, H, W, int(with_sigma))
        del d_bufs, g_sigma
    # the wrapper's backward through autograd: the kernel, the zeroing of
    # the scatter buffers and autograd's own work
    autograd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, wrt, cts, retain_graph=True))
    autograd_loop_ms = loop_ms(lambda: torch.autograd.grad(out, wrt, cts, retain_graph=True))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(warp2d_plain(*inputs), wrt, cts),
                       warmup=1, reps=3)
    fwd_bytes = nbytes(*inputs, *out)
    bwd_bytes = nbytes(*inputs, *cts, *wrt)
    fwd_bound = bound(fwd_bytes, 60 * dx.numel())
    bwd_bound = bound(bwd_bytes, 100 * dx.numel())
    del out, cts

    heads = [logits] + ([sigma] if with_sigma else [])
    channels = 3 + len(heads)
    lib_fwd_ms, lib_ms = grid_sample_ms(src, heads, dx, dy)
    del inputs, wrt, heads
    free_cache()
    tag = "warp2d" if with_sigma else "warp2d_nosigma"
    info = warp_kernel_info(with_sigma)
    fwd_info = warp_kernel_info(with_sigma, forward=True)
    print(f"[{tag}] warp2d vs plain on {', '.join(map(str, smalls))}, each with and "
          f"without degenerate coordinates, on {extras[0][0]} at zoom 200, {extras[1][0]} "
          f"with degenerate planes, {extras[2][0]} (B * N > 65535), "
          f"{', '.join(str(at) for at, _ in extras[3:])} with taps at the image's edges (the "
          f"last with src and heads as views ending their allocation), and at {shape}: "
          f"{held.describe()}; {'d_logits and d_sigma sum' if with_sigma else 'd_logits sums'}"
          f" by float atomics{' (neighbouring lanes combined)' if with_sigma else ''} in no "
          f"fixed order | {card}")
    for what, i in (("forward", fwd_info), ("backward", info)):
        print(f"[{tag}] {what} kernel: {i['registers']} registers (spills "
              f"{i['spill_bytes']} B), {i['threads']} threads a block, "
              f"{i['blocks_per_sm']} blocks an SM, no shared memory | {card}")
    print(f"[{tag}] at {shape}: forward kernel {fwd_ms:.4f} ms ({fwd_bytes / fwd_ms / 1e9:.2f} "
          f"TB/s of {fwd_bytes / 1e6:.0f} MB, {fwd_bound[0] / fwd_ms:.1%} of the bound "
          f"{fwd_bound[0]:.4f} ms), backward kernel alone {bwd_ms:.4f} ms ("
          f"{bwd_bytes / bwd_ms / 1e9:.2f} TB/s of {bwd_bytes / 1e6:.0f} MB, "
          f"{bwd_bound[0] / bwd_ms:.1%} of the bound {bwd_bound[0]:.4f} ms), backward "
          f"through autograd {autograd_bwd_ms:.4f} ms (with zeroing the scatter buffers; "
          f"{autograd_loop_ms:.4f} ms a call in a run of 20); "
          f"twin forward {plain_fwd_ms:.2f} ms, forward+backward {plain_ms:.2f} ms; "
          f"F.grid_sample on (B*N, {channels}, H, W) forward {lib_fwd_ms:.4f} ms, "
          f"forward+backward {lib_ms:.4f} ms (its backward also computes the rgb input's "
          f"gradient) | {card}")
    return {
        f"{tag}_fwd": {"max_abs_err": held.fwd, "ms": fwd_ms, "plain_ms": plain_fwd_ms,
                       "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                       "library_ms": lib_fwd_ms, "kernel_info": fwd_info},
        f"{tag}_bwd": {**held.bwd_fields(), "ms": bwd_ms, "autograd_ms": autograd_bwd_ms,
                       "autograd_loop_ms": autograd_loop_ms, "kernel_info": info,
                       # the twin's and the library's backward: forward+backward less forward
                       "plain_ms": plain_ms - plain_fwd_ms,
                       "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
                       "library_ms": lib_ms - lib_fwd_ms},
    }


def phase_disp_head_bwd(card, shape=SWEEP_SHAPE, dev=torch.device("cuda")):
    """The disp-head backward kernel against autograd through the plain
    head on small shapes and at the mono step's shape, then timed there;
    returns its JSON fields."""
    held = Held()
    names = ("d_logits", "d_sigma", "d_disp_rows")
    # W not a multiple of the 128-pixel tile, narrower than it and not a
    # multiple of 4 (4-byte copies); N = 94, 95 (in one chunk of staged
    # planes) and 127, 200 (two and three chunks)
    smalls = ((2, 63, 8, 200), (1, 7, 6, 1280), (1, 94, 7, 129), (1, 95, 6, 300),
              (1, 127, 6, 200), (2, 63, 6, 37), (1, 200, 6, 70))
    # the main path's shape last, where each row's d_disp_rows sums 640 terms
    for i, at in enumerate((*smalls, shape)):
        logits, sigma, rows, mask = seeded_head_inputs(at, 30 + i, dev)
        inputs = [logits.requires_grad_(), sigma.requires_grad_(), rows.requires_grad_(),
                  mask]
        held.hold((disp_head(*inputs),), (disp_head_plain(*inputs),), inputs, (0, 1, 2),
                  names, i)
        d = torch.autograd.grad(disp_head(*inputs), inputs[:3],
                                torch.ones((at[0], 1, at[2], at[3]), device=dev))
        if any(bool((t[:, :, 5] != 0).any()) for t in d[:2]) or bool((d[2][:, 5] != 0).any()):
            raise AssertionError("a fully masked row must get zero adjoints")
        del d
    free_cache()

    B, N, H, W = shape
    out = disp_head(*inputs)
    ct = torch.randn_like(out)
    first = torch.autograd.grad(out, inputs[:3], ct, retain_graph=True)
    second = torch.autograd.grad(out, inputs[:3], ct, retain_graph=True)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"two disp-head backward runs at {shape} differ")
    del first, second
    info = disp_kernel_info(N, W)
    with torch.no_grad():
        grads = [torch.empty_like(t) for t in inputs[:3]]
        scratch = torch.empty(_build.load_library().pdt_disp_head_bwd_scratch_floats(
            B, N, H, W), device=dev)
        ms = launch_ms("pdt_disp_head_bwd", (*inputs, ct, *grads, scratch), B, N, H, W)
        plain_fwd_ms = cuda_ms(lambda: disp_head_plain(*inputs))
        del grads, scratch
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(out, inputs[:3], ct, retain_graph=True))
    autograd_loop_ms = loop_ms(lambda: torch.autograd.grad(out, inputs[:3], ct,
                                                           retain_graph=True))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(disp_head_plain(*inputs), inputs[:3], ct))
    moved = nbytes(logits, sigma, rows, mask, ct, logits, sigma, rows)
    bound_ms, bound_by = bound(moved, 30 * logits.numel())
    del out, ct, inputs, logits, sigma, rows, mask
    free_cache()
    print(f"[disp_head_bwd] backward kernel vs autograd through the plain head on "
          f"{', '.join(map(str, smalls))} and {shape}, row 5 fully masked: "
          f"{held.describe()}; two backward runs bit-identical at {shape} | {card}")
    print(f"[disp_head_bwd] kernel at N={N}, W={W}: {info['registers']} registers (spills "
          f"{info['spill_bytes']} B), {info['threads']} threads a block, "
          f"{info['blocks_per_sm']} blocks an SM, {info['smem_bytes']} B shared, "
          f"{info['planes_a_chunk']} planes a chunk | {card}")
    print(f"[disp_head_bwd] at {shape}: kernel alone {ms:.4f} ms ({moved / ms / 1e9:.2f} TB/s "
          f"of {moved / 1e6:.0f} MB, {bound_ms / ms:.1%} of the bound {bound_ms:.4f} ms, "
          f"{bound_by}), through autograd {autograd_ms:.4f} ms ({autograd_loop_ms:.4f} ms a "
          f"call in a run of 20); twin backward "
          f"(forward+backward {plain_ms:.3f} less forward {plain_fwd_ms:.3f}) "
          f"{plain_ms - plain_fwd_ms:.3f} ms; no single PyTorch call computes it | {card}")
    return {"disp_head_bwd": {**held.bwd_fields(), "ms": ms, "autograd_ms": autograd_ms,
                              "autograd_loop_ms": autograd_loop_ms,
                              "plain_ms": plain_ms - plain_fwd_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None,
                              "bit_identical": True, "kernel_info": info}}


def seeded_nomix_inputs(shape, seed, dev):
    """:func:`seeded_sweep_inputs` without the sigma operand."""
    inputs = seeded_sweep_inputs(shape, seed, dev)
    inputs[3] = None
    return inputs


def sweep_nomix_bounds(inputs, with_disp):
    """(bytes, bound) of the no-mixture forward and backward: each input read
    once, each output written once (stats: 4 maps, 7 with disp); ~40 flops a
    pixel-plane forward, ~70 backward."""
    src, tgt, logits, _, shift, mask = inputs
    B, N, H, W = logits.shape
    row = B * H * W * 4
    nst = 7 if with_disp else 4
    ins = nbytes(src, tgt, logits, shift, mask)
    fwd_bytes = ins + row * (3 + 1 + with_disp + nst)
    bwd_bytes = ins + row * (nst + 3 + 3 + 1 + with_disp) + nbytes(logits, shift)
    return ((fwd_bytes, bound(fwd_bytes, 40 * logits.numel())),
            (bwd_bytes, bound(bwd_bytes, 70 * logits.numel())))


def time_sweep(inputs, pad, with_disp):
    """Kernel, twin, bound and MUFU-floor times of the sweep on ``inputs``
    (the no-mixture mode where sigma is None), with the kernels' registers
    and occupancy."""
    src, tgt, logits, sigma, shift, mask = inputs
    B, N, H, W = logits.shape
    mix = sigma is not None
    run = lambda: plane_sweep(*inputs, pad, False, with_disp)
    plain = lambda: plane_sweep_plain(*inputs, pad, False, with_disp)
    with torch.no_grad():
        wrapper_ms = cuda_ms(run)
        plain_fwd_ms = cuda_ms(plain, warmup=1, reps=3)
        # each kernel alone, the backward on the statistics and rgb of the
        # forward's direct launches (not counted: no wrapper runs)
        new = lambda *size: torch.empty(size, device=logits.device)
        rgb, nll, stats = new(B, 3, H, W), new(B, H, W), new(B, 7 if with_disp else 4, H, W)
        disp = new(B, H, W) if with_disp else None
        limit = shift_max(pad)
        fwd_ms = launch_ms("pdt_plane_sweep_fwd", (src, tgt, logits, sigma, shift, mask, rgb,
                                                   nll, None, disp, stats),
                           B, N, H, W, limit, 0, int(with_disp), int(mix))
        g = [torch.randn_like(t) for t in (rgb, nll)] + ([torch.randn_like(disp)]
                                                         if with_disp else [None])
        grads = (torch.empty_like(logits), torch.empty_like(logits) if mix else None,
                 torch.empty_like(shift))
        bwd_ms = launch_ms("pdt_plane_sweep_bwd", (src, tgt, logits, sigma, shift, mask, stats,
                                                   rgb, *g, *grads),
                           B, N, H, W, limit, int(with_disp), int(mix))
        del rgb, nll, stats, disp, g, grads
    out = run()
    cts = [torch.randn_like(o) for o in out]
    heads = [t for t in (logits, sigma, shift) if t is not None]
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(out, heads, cts, retain_graph=True))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(plain(), heads, cts), warmup=1, reps=3)
    (fwd_bytes, fwd_bound), (bwd_bytes, bwd_bound) = (
        sweep_bounds(inputs) if mix else sweep_nomix_bounds(inputs, with_disp))
    mufu = {d: mufu_floor_ms(logits.numel(), sweep_mufu(mix, with_disp, d))
            for d in ("fwd", "bwd")}
    return {"fwd_ms": fwd_ms, "wrapper_ms": wrapper_ms, "plain_fwd_ms": plain_fwd_ms,
            "bwd_ms": bwd_ms,
            "autograd_ms": autograd_ms, "plain_bwd_ms": plain_ms - plain_fwd_ms,
            "fwd_bytes": fwd_bytes, "fwd_bound": fwd_bound, "bwd_bytes": bwd_bytes,
            "bwd_bound": bwd_bound, "fwd_mufu_ms": mufu["fwd"], "bwd_mufu_ms": mufu["bwd"],
            "info": sweep_info(mix, N, W)}


def phase_sweep_nomix(card, dev=torch.device("cuda"), shape=FALNET_SHAPE,
                      ablation_shape=SWEEP_SHAPE, smalls=SWEEP_SMALLS):
    """The no-mixture sweep kernels (B1') against their twin on the odd
    shapes of phase 5, at FalNet's shape without the centre disparity and
    at the ResNet ablation's with it; two backward runs bit-identical; then
    timed at both; returns the JSON fields.

    On the odd shapes every output gets a seeded cotangent.  At the main
    path's shapes nll gets none, as in the no-mixture recipes (their L1 is
    taken from rgb outside the kernel): through nll's adjoint d_shift hinges
    on sign(c - tgt) at the L1's kinks, which two float32 evaluations of the
    samples may take on either side at a few of the 75k (row, plane) sums."""
    held = Held()
    pad = sweep_pad(stage1_config())
    names = ("d_logits", "d_shift")
    for i, small in enumerate(smalls):
        for with_disp in (False, True):
            inputs = seeded_nomix_inputs(small, 40 + i, dev)
            held.hold(plane_sweep(*inputs, pad, False, with_disp),
                      plane_sweep_plain(*inputs, pad, False, with_disp),
                      inputs, (2, 4), names, i)
    timed = {}
    for at, with_disp in ((shape, False), (ablation_shape, True)):
        inputs = seeded_nomix_inputs(at, 50, dev)
        got = plane_sweep(*inputs, pad, False, with_disp)
        if not bool((got[0][:, :, 5] == 0).all()):
            raise AssertionError("a fully masked row must composite to 0")
        held.hold(got, plane_sweep_plain(*inputs, pad, False, with_disp), inputs, (2, 4),
                  names, 9, no_cotangent=(1,))
        del got
        free_cache()
        if not backward_is_deterministic(inputs, pad, with_disp):
            raise AssertionError(f"two no-mixture backward runs at {at} differ")
        timed[at] = time_sweep(inputs, pad, with_disp)
        del inputs
        free_cache()
    print(f"[sweep_nomix] no-mixture plane_sweep vs plain on {', '.join(map(str, smalls))} "
          f"(each with and without disp), at {shape} without disp and {ablation_shape} with "
          f"it (no nll cotangent there, as in training), pad {pad}: {held.describe()}; two "
          f"backward runs bit-identical at both | {card}")
    for at, t in timed.items():
        print_sweep_times("sweep_nomix", at, t, card)
    fwd, bwd = sweep_fields(held, timed[shape], {ablation_shape: timed[ablation_shape]})
    return {"plane_sweep_nomix_fwd": {**fwd, "shape": list(shape)},
            "plane_sweep_nomix_bwd": {**bwd, "shape": list(shape)}}


def trainer_run(cfg, dev, warmup, steps, per_step, after_val, panels=False):
    """``cfg`` through the Trainer on synthetic samples: ``warmup + steps``
    steps, each held to the launch counts ``per_step``, and one validation
    pass, whose launches must be ``after_val``; then the memory of one more
    step by aten op.  With ``panels`` the Trainer's image panels of a batch
    are built once more on the card, held to one eval forward's launches
    (``after_val``'s) and checked finite in [0, 1].  Returns what the
    phases print."""
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_") as log_dir:
        # seeded random weights throughout: no ImageNet files in the checkout
        cfg = cfg.replace(log_dir=log_dir, allow_random_pc=True,
                          optim=dataclasses.replace(cfg.optim, num_epochs=1))
        b, h, w = cfg.per_step_batch, cfg.data.height, cfg.data.width
        novel = cfg.novel_frame_ids
        trainer = Trainer(cfg, datasets=(SyntheticStereo(b * (warmup + steps), h, w, novel),
                                         SyntheticStereo(b, h, w, novel)), device=dev)
        start = {k: p.detach().clone() for k, p in trainer.bundle.named_parameters()}
        times, event_ms, losses, val = [], [], [], {}
        step_fn, val_fn = trainer.train_step, trainer.val

        def timed_step(batch):
            if len(times) == warmup:
                torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = step_fn(batch)
            end.record()
            end.synchronize()                     # the losses stay on the device
            times.append(time.perf_counter() - t0)
            event_ms.append(start.elapsed_time(end))
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != per_step:
                raise AssertionError(f"{cfg.model_name} step launches {delta}, want {per_step}")
            losses.append(host_losses(out))
            return out

        trainer.train_step = timed_step
        trainer.val = lambda epoch: val.setdefault("metrics", val_fn(epoch))
        reset_launch_counts()
        trainer.train()
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        reserved_gb = torch.cuda.max_memory_reserved(dev) / 1e9
        trainer.close()
        n = warmup + steps
        want = with_panels({k: v * n + after_val.get(k, 0) for k, v in per_step.items()},
                           after_val)
        if launches != want or len(times) != n:
            raise AssertionError(f"{cfg.model_name} run launches {launches} in {len(times)} "
                                 f"steps, want {want} in {n}")
        check_losses(losses, cfg)
        if not val.get("metrics") or not all(math.isfinite(v) for v in val["metrics"].values()):
            raise AssertionError(f"validation metrics {val}")
        moved = {}
        for k, p in trainer.bundle.named_parameters():
            net = k.split(".", 1)[0]
            moved.setdefault(net, [0, 0])
            moved[net][0] += int(not torch.equal(p.detach(), start[k]))
            moved[net][1] += 1
        saved = sorted(os.listdir(os.path.join(log_dir, cfg.model_name, "last_models")))
        panel_launches, panel_images = {}, []
        if panels:
            reset_launch_counts()
            images = trainer.panels(step_batch(cfg, 0))
            panel_launches = nonzero(launch_counts())
            if panel_launches != nonzero(after_val) or not all(
                    np.isfinite(im).all() and im.min() >= 0.0 and im.max() <= 1.0
                    for im in images.values()):
                raise AssertionError(f"panels: launches {panel_launches}, images "
                                     f"{sorted(images)}")
            panel_images = sorted(images)
            del images
        batch = batch_to_tensors(step_batch(cfg, 0), dev)
        memory = memory_by_op(lambda: step_fn(batch), dev)
        del trainer, start, batch
        free_cache()
    if not cfg.bf16:
        F32_RUNS[cfg.model_name] = (statistics.median(times[warmup:]) * 1e3, peak_gb)
    return {"cfg": cfg, "launches": launches, "losses": losses, "val": val["metrics"],
            "moved": moved, "saved": saved, "memory": memory, "peak_gb": peak_gb,
            "reserved_gb": reserved_gb, "step_ms": statistics.median(times[warmup:]) * 1e3,
            "event_ms": statistics.median(event_ms[warmup:]), "warmup": warmup, "steps": steps,
            "panels": panel_launches, "panel_images": panel_images}


def print_trainer_run(tag, what, run, cpu, cpu_shape, card):
    cfg, b = run["cfg"], run["cfg"].per_step_batch
    print(f"[{tag}] {what}, {cfg.data.width}x{cfg.data.height}, batch {b}"
          f"{f' flipped to {cfg.effective_batch}' if cfg.flip_right else ''}: "
          f"{run['warmup']}+{run['steps']} steps through Trainer, launches {run['launches']}; "
          f"parameter tensors moved per network {json.dumps(run['moved'])}; saved "
          f"{run['saved']}; first/last losses {json.dumps(run['losses'][0])} "
          f"{json.dumps(run['losses'][-1])}")
    print(f"[{tag}] validation metrics {json.dumps(run['val'])}")
    if cpu is not None:
        print(f"[{tag}] card vs CPU at {cpu_shape} (one step): {json.dumps(cpu)}")
    print(f"[{tag}] step {run['step_ms']:.2f} ms median of {run['steps']} (host clock around "
          f"synchronised steps, after {run['warmup']} warm-up; CUDA events around them "
          f"{run['event_ms']:.2f} ms), "
          f"{cfg.effective_batch / run['step_ms'] * 1e3:.2f} imgs/s, peak device memory "
          f"{run['peak_gb']:.2f} GB allocated, {run['reserved_gb']:.2f} GB reserved; float32, "
          f"TF32 off | {card}")
    print(f"[{tag}] memory of one more step by aten op: {json.dumps(run['memory'])} | {card}")


FALNET_MODEL = ModelConfig(net_type="FalNet", use_mixture_loss=False, plane_residual=False,
                           planes=PlaneConfig(xz_levels=0))
PLADENET_MODEL = ModelConfig(net_type="PladeNet", num_ep=8, use_mixture_loss=True,
                             plane_residual=True)


def phase_falnet(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """FalNet stereo training through the Trainer at full width: stage 1's
    data, optimiser, flip and VGG19 loss, 49 fronto-parallel planes, the
    no-mixture sweep; returns the launch counts of the run."""
    free_cache()
    cfg = stage1_config(model_name="falnet", model=FALNET_MODEL)
    run = trainer_run(cfg, dev, warmup, steps, FALNET_STEP, {})
    if any(m != t for m, t in run["moved"].values()):
        raise AssertionError(f"every FalNet parameter must move: {run['moved']}")
    if "fal.pth" not in run["saved"]:
        raise AssertionError(f"no fal.pth in the checkpoint: {run['saved']}")
    cpu = check_step_against_cpu(cfg.replace(data=DataConfig(height=64, width=192)), dev)
    print_trainer_run("falnet", f"FalNet {cfg.model.planes.disp_levels} planes "
                      f"({cfg.model.planes.disp_min}-{cfg.model.planes.disp_max} px), no "
                      f"mixture, VGG19 alpha_pc {cfg.loss.alpha_pc}", run, cpu, "64x192", card)
    return run["launches"]


def phase_pladenet(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """PladeNet stereo training (mixture, 8-channel PE, plane residuals,
    49+14 planes) through the Trainer at full width; returns the launch
    counts of the run."""
    free_cache()
    cfg = stage1_config(model_name="pladenet", model=PLADENET_MODEL)
    run = trainer_run(cfg, dev, warmup, steps, PLADENET_STEP, {})
    if any(m != t for m, t in run["moved"].values()):
        raise AssertionError(f"every PladeNet parameter must move: {run['moved']}")
    if "plade.pth" not in run["saved"]:
        raise AssertionError(f"no plade.pth in the checkpoint: {run['saved']}")
    cpu = check_step_against_cpu(cfg.replace(data=DataConfig(height=64, width=192)), dev)
    planes = cfg.model.planes
    print_trainer_run("pladenet", f"PladeNet {planes.disp_levels}+{planes.xz_levels} planes, "
                      f"mixture, PE {cfg.model.num_ep}, plane residual, VGG19 alpha_pc "
                      f"{cfg.loss.alpha_pc}", run, cpu, "64x192", card)
    return run["launches"]


def phase_nomix(card, dev=torch.device("cuda"), steps=2):
    """The recipes without the mixture: 2 steps each of the ResNet-50
    ablation of stage1_config, of mono_config and of its mixed disp_warp
    variant, each held to its per-step launch counts; one mono step on the
    card held to the CPU.  Returns the launch counts of the three runs."""
    nomix = ModelConfig(use_mixture_loss=False)
    random_pc = dict(model=nomix, allow_random_pc=True)
    total = only()
    lines = []
    for name, cfg, per_step in (
            ("stage1 ResNet-50 ablation", stage1_config(**random_pc), NOMIX_STEREO_STEP),
            ("mono homography", mono_config(**random_pc), NOMIX_MONO_STEP),
            ("mixed disp_warp", mono_config(warp_type="disp_warp", **random_pc),
             NOMIX_MIXED_STEP)):
        free_cache()
        losses, _, _ = steps_held(cfg, per_step, dev, steps)
        total = {k: v + steps * per_step[k] for k, v in total.items()}
        lines.append(f"[nomix] {name} without the mixture at {cfg.data.width}x"
                     f"{cfg.data.height}, batch {cfg.effective_batch}: {steps} steps, launches "
                     f"per step {nonzero(per_step)}, losses {json.dumps(losses[-1])} | {card}")
    free_cache()
    cpu = check_step_against_cpu(mono_config(model=nomix, batch_size=4,
                                             data=DataConfig(height=64, width=128)), dev)
    for line in lines:
        print(line)
    print(f"[nomix] card vs CPU, mono without the mixture at 64x128 (batch 4, one step): "
          f"{json.dumps(cpu)}")
    return total


def phase_mono(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """The monocular homography recipe through the Trainer at full width,
    then 2 mixed disp_warp steps; returns the launch counts of the mono run."""
    free_cache()
    cfg = mono_config()
    # the validation batch: one disp head and one head epilogue
    run = trainer_run(cfg, dev, warmup, steps, MONO_STEP,
                      {"disp_head_fwd": 1, "head_epilogue_fwd": 1})
    if any(m < t // 2 for m, t in run["moved"].values()):
        raise AssertionError(f"parameter tensors moved per network: {run['moved']}")
    cpu = check_step_against_cpu(mono_config(data=DataConfig(height=64, width=128),
                                             batch_size=4), dev)
    print_trainer_run(
        "mono", f"mono_config ResNet-{cfg.model.num_layers} DenseASPP "
        f"{cfg.model.planes.disp_levels}+{cfg.model.planes.xz_levels} planes, pose "
        f"ResNet-{cfg.model.pose_num_layers} + PoseDecoder (PE {cfg.model.pose_num_ep}), "
        f"{cfg.warp_type} to sides {cfg.target_sides}, automask, VGG19 alpha_pc "
        f"{cfg.loss.alpha_pc} (per step {MONO_STEP}, + 1 disp head and 1 head epilogue for "
        f"validation)", run, cpu, "64x128 (batch 4)", card)
    w, h, b = cfg.data.width, cfg.data.height, cfg.per_step_batch

    mixed = mono_config(warp_type="disp_warp")
    mixed_losses, _, _ = steps_held(mixed, MIXED_STEP, dev)
    print(f"[mono] mixed disp_warp (side r through the sweep, -1 and 1 through the 2-D "
          f"warp) at {w}x{h}, batch {b}: 2 steps, launches per step {nonzero(MIXED_STEP)}, "
          f"losses {json.dumps(mixed_losses[-1])} | {card}")
    return run["launches"]


# per step of the disp_warp recipes that the 2-D warp rescues (render
# probability, yz side planes): one warp with sigma each way and the head
# epilogue each way (N - 1 logit planes under render_probability); no sweep,
# no disp head (their probability is not the disp head's softmax)
RESCUE_STEP = only(warp2d_fwd=1, warp2d_bwd=1, head_epilogue_fwd=1, head_epilogue_bwd=1)
# per PladeNet step with render_probability: the warp each way, nothing else
PLADENET_RENDER_STEP = only(warp2d_fwd=1, warp2d_bwd=1)
RENDER_MODEL = ModelConfig(render_probability=True)
# yz side planes: no published recipe sets yz_levels (the reference defaults
# it to 0); 8 (two half-sets of 4, N = 71) is this script's choice
YZ_MODEL = ModelConfig(planes=PlaneConfig(yz_levels=8))
SELF_LOSS = LossConfig(alpha_self=0.1, use_ssim=True)


def rescue_phase_line(tag, run, stage1):
    """The step time and peak memory beside stage 1's sweep step through
    the same Trainer (``stage1``: its trainer_run)."""
    loss = run["losses"][-1].get("loss/self_loss")
    return (f"[{tag}] step {run['event_ms']:.2f} ms (CUDA events, through Trainer) against "
            f"stage 1's sweep step through Trainer {stage1['event_ms']:.2f} ms "
            f"({run['event_ms'] / stage1['event_ms']:.2f}x), peak {run['peak_gb']:.2f} GB "
            f"allocated against {stage1['peak_gb']:.2f} GB"
            + (f", last loss/self_loss {loss:.6f}" if loss is not None else ""))


STAGE1_STEP = only(plane_sweep_fwd=1, plane_sweep_bwd=1, head_epilogue_fwd=1,
                   head_epilogue_bwd=1)


def phase_stage1_trainer(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """stage1_config through the Trainer as phases 19-21 run their recipes:
    the baseline their step times stand beside; returns its run."""
    free_cache()
    run = trainer_run(stage1_config(model_name="stage1"), dev, warmup, steps, STAGE1_STEP,
                      {"disp_head_fwd": 1, "head_epilogue_fwd": 1})
    print(f"[stage1_trainer] stage1_config through Trainer: {warmup}+{steps} steps, "
          f"launches per step {nonzero(STAGE1_STEP)}, "
          f"step {run['event_ms']:.2f} ms (CUDA events; {run['step_ms']:.2f} host clock), "
          f"peak {run['peak_gb']:.2f} GB allocated | {card}")
    return run


# per oracle stage-1 step: the decoder's head epilogue and disp head each
# way (disp feeds the smoothness loss); the view synthesis is plain gathers
ORACLE_STEP = only(head_epilogue_fwd=1, head_epilogue_bwd=1, disp_head_fwd=1, disp_head_bwd=1)
# with use_mom (which forces flip_right): the 4 row shifts of the mirror
# occlusion mask over the synthesised right-view probability
ORACLE_MOM_STEP = dict(ORACLE_STEP, row_shift_fwd=4)
ORACLE_LOSS_RTOL = 2e-4            # tests/test_fused_train.py: the JAX fused step vs its oracle


def fused_vs_oracle(cfg, dev, seed=0):
    """One step of ``cfg`` through the fused sweep and one through the
    oracle view synthesis, from the same seeded weights (each bundle from
    the config's seed, the oracle's state copied into the fused one) and
    batch; returns both loss dicts and each step's launches."""
    batch = batch_to_tensors(step_batch(cfg, seed), dev)
    out, weights = {}, None
    for name, c in (("oracle", cfg.replace(fused_sweep=False)),
                    ("fused", cfg.replace(fused_sweep=True))):
        bundle = ModelBundle(c, dev)
        if weights is None:
            weights = {k: v.clone() for k, v in bundle.model.state_dict().items()}
        else:
            bundle.model.load_state_dict(weights)
        optimizer, scheduler = make_optimizer(c, bundle.parameters(), 1000)
        reset_launch_counts()
        losses = host_losses(make_train_step(bundle, optimizer, scheduler)(batch))
        out[name] = (losses, nonzero(launch_counts()))
        del bundle, optimizer, scheduler
        free_cache()
    return out


def phase_oracle(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """The oracle view synthesis (``fused_sweep`` off, the JAX CLI's
    default): stage1_config through the Trainer at full width, each step
    held to its launches, its panels on the card; one step of the same
    weights and batch through the fused sweep held to the oracle's losses;
    then 2 steps each of mono_config with use_mom (the oracle too: the 2-D
    warp route leaves use_mom out, as in the JAX package) and of stage 1
    with the ResNet-18 perceptual net."""
    free_cache()
    cfg = stage1_config(model_name="oracle", fused_sweep=False)
    eval_forward = {"disp_head_fwd": 1, "head_epilogue_fwd": 1}
    run = trainer_run(cfg, dev, warmup, steps, ORACLE_STEP, eval_forward, panels=True)
    pair = fused_vs_oracle(stage1_config(allow_random_pc=True), dev)
    (oracle, oracle_launches), (fused, fused_launches) = pair["oracle"], pair["fused"]
    gap = {k: abs(fused[k] / v - 1) for k, v in oracle.items()}
    if set(fused) != set(oracle) or max(gap.values()) > ORACLE_LOSS_RTOL:
        raise AssertionError(f"fused step {fused} vs oracle step {oracle}")
    if oracle_launches != nonzero(ORACLE_STEP) or fused_launches != nonzero(STAGE1_STEP):
        raise AssertionError(f"launches oracle {oracle_launches}, fused {fused_launches}")
    mono = mono_config(model_name="mono_mom", loss=dataclasses.replace(
        mono_config().loss, use_mom=True), allow_random_pc=True)
    mono_losses, mono_ms, mono_peak = steps_held(mono, ORACLE_MOM_STEP, dev)
    resnet = stage1_config(model_name="pc_resnet18", allow_random_pc=True,
                           loss=dataclasses.replace(stage1_config().loss, pc_net="resnet18"))
    resnet_losses, resnet_ms, resnet_peak = steps_held(resnet, STAGE1_STEP, dev)
    print_trainer_run("oracle", f"stage1_config with fused_sweep=False (the oracle view "
                      f"synthesis), ResNet-{cfg.model.num_layers} DenseASPP "
                      f"{cfg.model.planes.disp_levels}+{cfg.model.planes.xz_levels} planes VGG19",
                      run, None, None, card)
    print(f"[oracle] panels (train and val, one eval-mode forward each): launches "
          f"{json.dumps(run['panels'])}, images {run['panel_images']} | {card}")
    print(f"[oracle] the same weights and batch, one step each: oracle {json.dumps(oracle)} "
          f"(launches {oracle_launches}), fused sweep {json.dumps(fused)} (launches "
          f"{fused_launches}); relative gap per loss {json.dumps(gap)} (<= "
          f"{ORACLE_LOSS_RTOL}) | {card}")
    print(f"[oracle] mono_config with use_mom ({mono.warp_type}, sides {mono.target_sides}, "
          f"the oracle; batch {mono.per_step_batch} flipped to {mono.effective_batch}): 2 "
          f"steps, launches per step {nonzero(ORACLE_MOM_STEP)}, "
          f"{[round(t, 2) for t in mono_ms]} ms (CUDA events), peak {mono_peak:.2f} GB, losses "
          f"{json.dumps(mono_losses[-1])} | {card}")
    print(f"[oracle] stage1_config with pc_net resnet18 (the fused sweep): 2 steps, launches "
          f"per step {nonzero(STAGE1_STEP)}, {[round(t, 2) for t in resnet_ms]} ms (CUDA "
          f"events), peak {resnet_peak:.2f} GB, losses {json.dumps(resnet_losses[-1])} | {card}")
    return run


def well_posed_pixels(logits, dists):
    """Pixels whose NeRF alphas all lie in [0, 1]: no plane of positive
    density at a negative distance from the plane before it.  Elsewhere
    ``1 - exp(-relu(l) * d)`` grows without bound and the compositing and
    the mixture's plane sum cancel, so two float32 evaluations part."""
    N = logits.shape[1]
    return (torch.relu(logits[:, :N - 1]) * dists >= 0).all(1, keepdim=True)


def check_render_eval(dev, height=384, width=1280):
    """The render_probability eval forward (ResNet-50, 49+14 planes) on a
    mirrored batch of 8 at ``height`` x ``width`` on the card against the
    CPU: the head epilogue's output, sigma and dists elementwise at
    MODEL_TOL against the CPU's float32 forward; the compositing (pi,
    probability, disp: plain tensor code on both) recomputed in float64 on
    the CPU from the card's own logits, sigma and dists, held at MODEL_TOL
    on the well-posed pixels (:func:`well_posed_pixels`) and finite on all.
    Returns what the phase prints."""
    model = init_weights_(DepthModel(RENDER_MODEL), torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    batch = make_stereo_batch(4, height, width, seed=0)
    image, grid = mirror_batch(torch.from_numpy(batch["color_l"]).permute(0, 3, 1, 2),
                               torch.from_numpy(batch["grid"]).permute(0, 3, 1, 2))
    reset_launch_counts()
    with torch.inference_mode():
        out = model(image.to(dev), grid.to(dev))
        torch.cuda.synchronize(dev)
        launches = launch_counts()
        if launches != only(head_epilogue_fwd=1):
            raise AssertionError(f"render eval launches {launches}")
        fwd_ms = cuda_ms(lambda: model(image.to(dev), grid.to(dev)), warmup=1, reps=5)
    keys = ("logits", "sigma", "dists", "pi", "probability", "disp", "disp_layered",
            "padding_mask")
    got = {k: out[k].cpu() for k in keys}
    del out
    free_cache()
    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        want = cpu_model(image, grid)
    report = {"forward_ms": fwd_ms, "launches": nonzero(launches)}
    for key in ("logits", "sigma", "dists"):
        torch.testing.assert_close(got[key], want[key], msg=key, **MODEL_TOL)
        report[f"{key}_max_abs_err"] = (got[key] - want[key]).abs().max().item()
    del want
    d = {k: got[k].double() for k in keys}
    N = d["logits"].shape[1]
    pi = render_probability_from_logits(d["logits"][:, :N - 1], d["dists"])
    prob = mixture_reweight(pi, d["sigma"], d["padding_mask"])
    ref = {"pi": pi, "probability": prob,
           "disp": (prob * d["disp_layered"]).sum(1, keepdim=True)}
    ok = well_posed_pixels(d["logits"], d["dists"])
    report["well_posed_share"] = ok.double().mean().item()
    for key, r in ref.items():
        g = d[key]
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"render eval: non-finite {key}")
        sel = ok.expand_as(g)
        torch.testing.assert_close(g[sel], r[sel], msg=key, **MODEL_TOL)
        report[f"{key}_max_abs_err_well_posed"] = (g[sel] - r[sel]).abs().max().item()
        report[f"{key}_max_abs"] = g.abs().max().item()
    return report


def phase_render(card, stage1, dev=torch.device("cuda"), warmup=3, steps=10):
    """stage1_config with render_probability through the Trainer at full
    width: every side through the 2-D warp (the disp_warp rescue); one card
    step held to the CPU on the 49 vertical planes (with the recipe's ground
    planes the compositing is ill-posed, :func:`well_posed_pixels`); the
    eval forward at 1280x384, batch 8, card against CPU.  Returns the launch
    counts of the run."""
    free_cache()
    cfg = stage1_config(model_name="render", model=RENDER_MODEL)
    run = trainer_run(cfg, dev, warmup, steps, RESCUE_STEP, {"head_epilogue_fwd": 1})
    if any(m < t // 2 for m, t in run["moved"].values()):
        raise AssertionError(f"parameter tensors moved per network: {run['moved']}")
    cpu = check_step_against_cpu(stage1_config(
        model=dataclasses.replace(RENDER_MODEL, planes=PlaneConfig(xz_levels=0)),
        data=DataConfig(height=64, width=192)), dev)
    free_cache()
    evaluation = check_render_eval(dev)
    free_cache()
    planes = cfg.model.planes
    print_trainer_run("render", f"stage1_config with render_probability, ResNet-"
                      f"{cfg.model.num_layers} DenseASPP {planes.disp_levels}+"
                      f"{planes.xz_levels} planes ({planes.all_levels - 1} density planes), "
                      f"VGG19 alpha_pc {cfg.loss.alpha_pc} (per step {RESCUE_STEP}, + 1 head "
                      f"epilogue for validation)", run, cpu,
                      "64x192, 49 vertical planes", card)
    print(rescue_phase_line("render", run, stage1) + f" | {card}")
    print(f"[render] eval forward at 1280x384, batch 8 (4 mirrored), card vs CPU: "
          f"{json.dumps(evaluation)} | {card}")
    return run["launches"]


def phase_yz(card, stage1, dev=torch.device("cuda"), warmup=3, steps=10):
    """stage1_config with yz side planes (yz_levels 8, N = 71) through the
    Trainer at full width, every side through the 2-D warp; one card step
    held to the CPU.  Returns the launch counts of the run."""
    free_cache()
    cfg = stage1_config(model_name="yz", model=YZ_MODEL)
    run = trainer_run(cfg, dev, warmup, steps, RESCUE_STEP, {"head_epilogue_fwd": 1})
    if any(m < t // 2 for m, t in run["moved"].values()):
        raise AssertionError(f"parameter tensors moved per network: {run['moved']}")
    cpu = check_step_against_cpu(stage1_config(model=YZ_MODEL,
                                               data=DataConfig(height=64, width=192)), dev)
    planes = cfg.model.planes
    print_trainer_run("yz", f"stage1_config with yz_levels {planes.yz_levels} (our choice: "
                      f"no published recipe sets it), ResNet-{cfg.model.num_layers} DenseASPP "
                      f"{planes.disp_levels}+{planes.xz_levels}+{planes.yz_levels} planes, "
                      f"VGG19 alpha_pc {cfg.loss.alpha_pc} (per step {RESCUE_STEP}, + 1 head "
                      f"epilogue for validation)", run, cpu, "64x192", card)
    print(rescue_phase_line("yz", run, stage1) + f" | {card}")
    return run["launches"]


def steps_held(cfg, per_step, dev, steps=2):
    """``steps`` training steps of ``cfg`` outside the Trainer, each held to
    the launch counts ``per_step``; returns the loss dicts and the event
    times."""
    bundle = ModelBundle(cfg, dev)
    optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 1000)
    train_step = make_train_step(bundle, optimizer, scheduler)
    batch = batch_to_tensors(step_batch(cfg, 0), dev)
    losses, event_ms = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(steps):
        before = launch_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = train_step(batch)
        end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
        losses.append(host_losses(out))
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        if delta != per_step:
            raise AssertionError(f"{cfg.model_name} step launches {delta}, want {per_step}")
    check_losses(losses, cfg)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    del bundle, optimizer, scheduler, train_step, batch
    free_cache()
    return losses, event_ms, peak_gb


def phase_self(card, stage1, dev=torch.device("cuda"), warmup=3, steps=10):
    """alpha_self 0.1 with SSIM: stage1_config through the Trainer at full
    width (the self-reconstruction reads the sweep's disparity), then 2
    steps of mono_config (it reads the disp head's); returns the launch
    counts of the Trainer run."""
    free_cache()
    cfg = stage1_config(model_name="self", loss=SELF_LOSS)
    run = trainer_run(cfg, dev, warmup, steps, STAGE1_STEP,
                      {"disp_head_fwd": 1, "head_epilogue_fwd": 1})
    if any(m < t // 2 for m, t in run["moved"].values()):
        raise AssertionError(f"parameter tensors moved per network: {run['moved']}")
    cpu = check_step_against_cpu(stage1_config(loss=SELF_LOSS,
                                               data=DataConfig(height=64, width=192)), dev)
    print_trainer_run("self", f"stage1_config with alpha_self {cfg.loss.alpha_self}, "
                      f"use_ssim (per step {STAGE1_STEP}, + 1 disp head and 1 head epilogue "
                      f"for validation)", run, cpu, "64x192", card)
    print(rescue_phase_line("self", run, stage1) + f" | {card}")
    mono = mono_config(loss=dataclasses.replace(mono_config().loss, alpha_self=0.1,
                                                use_ssim=True))
    losses, event_ms, peak_gb = steps_held(mono, MONO_STEP, dev)
    print(f"[self] mono_config with alpha_self 0.1, use_ssim at {mono.data.width}x"
          f"{mono.data.height}, batch {mono.effective_batch}: 2 steps, launches per step "
          f"{nonzero(MONO_STEP)}, last step {event_ms[-1]:.2f} ms "
          f"(CUDA events), peak {peak_gb:.2f} GB allocated, losses {json.dumps(losses[-1])} "
          f"| {card}")
    return run["launches"]


def phase_pladenet_render(card, dev=torch.device("cuda"), steps=2):
    """PladeNet (49+14 planes, mixture, PE 8, plane residuals) with
    render_probability: 2 stage-1 steps through the 2-D warp."""
    free_cache()
    cfg = stage1_config(model_name="pladenet_render", allow_random_pc=True,
                        model=dataclasses.replace(PLADENET_MODEL, render_probability=True))
    losses, event_ms, peak_gb = steps_held(cfg, PLADENET_RENDER_STEP, dev, steps)
    print(f"[pladenet_render] PladeNet with render_probability at {cfg.data.width}x"
          f"{cfg.data.height}, batch {cfg.effective_batch}: {steps} steps, launches per step "
          f"{nonzero(PLADENET_RENDER_STEP)}, last step "
          f"{event_ms[-1]:.2f} ms (CUDA events), peak {peak_gb:.2f} GB allocated, losses "
          f"{json.dumps(losses[-1])} | {card}")


# the kitti phase's tree: the eigen_raw test frames with a scan each, and a
# stereo train/val split of frames outside it (val with scans)
KITTI_SCAN_POINTS = 10000             # a real scan has ~120k (PERF.md: the cut)
KITTI_DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"
KITTI_TRAIN = [f"{KITTI_DRIVE} {i} l" for i in range(10000, 10032)]
KITTI_VAL = [f"{KITTI_DRIVE} {i} l" for i in range(10100, 10108)]


def decode_ms(path, reps=5, compiled=True):
    """Median ms of ``read_png(path)`` on the host, with the row unfilter
    that it runs or (``compiled=False``) its numpy version."""
    unfilter = image_io.png_unfilter_library()
    times = []
    try:
        if not compiled:
            image_io._unfilter_state["fn"] = None
        for _ in range(reps):
            t0 = time.perf_counter()
            read_png(path)
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        image_io._unfilter_state["fn"] = unfilter
    return statistics.median(times)


KITTI_STEP = "kitti_train_step"        # the record_function range of a training step


def step_device_busy(prof, label):
    """For each ``record_function(label)`` range of a profiler trace: its
    span on the host's clock and the time the device was busy inside it
    (the union of the kernels and copies that start in it), both in ms."""
    windows, device = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # kernels and copies, not the device annotations of ranges
            if e.name != label and not getattr(e, "is_user_annotation", False):
                device.append((e.time_range.start, e.time_range.end))
        elif e.name == label:
            windows.append((e.time_range.start, e.time_range.end))
    device.sort()
    out = []
    for start, end in sorted(windows):
        busy, reach = 0.0, start
        for a, b in device:
            if start <= a < end and b > reach:
                busy += b - max(a, reach)
                reach = b
        out.append(((end - start) / 1e3, busy / 1e3))
    return out


MARKER = "spin_kernel"                 # torch.cuda._sleep's kernel


def device_step_windows(prof):
    """The device's side of steps that run ahead of the card, each bounded
    by a ``torch.cuda._sleep`` marker kernel before and after its launches:
    each step's window on the device's clock (first marker's start to the
    second's end) and the ms the device was busy in it (the union of its
    other kernels and copies), and the card's idle share of the wall from
    the second window's start to the last's end, inside the windows and
    between them."""
    markers, device = [], []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):   # kernels and copies
            span = (e.time_range.start, e.time_range.end)
            (markers if MARKER in e.name else device).append(span)
    markers.sort()
    device.sort()
    windows = [(markers[i][0], markers[i + 1][1]) for i in range(0, len(markers) - 1, 2)]

    def busy(start, end):
        total, reach = 0.0, start
        for a, b in device:
            if a >= end:
                break
            if b > reach:
                total += min(b, end) - max(a, reach)
                reach = min(b, end)
        return total

    out = {"markers": len(markers), "busy": [busy(a, b) / 1e3 for a, b in windows],
           "idle_in": 0.0, "idle_between": 0.0}
    if len(windows) > 1:
        wall = windows[-1][1] - windows[1][0]
        out["idle_in"] = sum(b - a - busy(a, b) for a, b in windows[1:]) / wall
        out["idle_between"] = sum(max(0.0, b - a) - busy(a, b) for a, b in
                                  zip((w[1] for w in windows[1:-1]),
                                      (w[0] for w in windows[2:]))) / wall
    return out


def phase_kitti(card, dev=torch.device("cuda")):
    """The KITTI entry points on a KITTI-shaped tree: ``cli.train.main``
    (stage 1 at full width, 8 steps and one validation through the split's
    reader), the eigen_raw ground truth, and the evaluate CLI's
    config-and-restore part then ``evaluate`` over the 697 eigen_raw frames
    with post-processing, the ground truth under the temporary tree; returns
    the launch counts of the two runs."""
    free_cache()
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_kitti_") as tmp:
        root, split = os.path.join(tmp, "kitti"), os.path.join(tmp, "split")
        splits_dir, log_dir = os.path.join(tmp, "splits"), os.path.join(tmp, "log")
        test_lines = readlines(split_path("eigen_raw", "test"))
        t0 = time.perf_counter()
        write_tree(root, test_lines + KITTI_VAL, scan_points=KITTI_SCAN_POINTS)
        tree_bytes = write_tree(root, KITTI_TRAIN)
        write_s = time.perf_counter() - t0
        os.makedirs(split)
        for name, lines in (("train", KITTI_TRAIN), ("val", KITTI_VAL)):
            with open(os.path.join(split, f"{name}_files.txt"), "w") as f:
                f.write("".join(f"{ln}\n" for ln in lines))
        frame = os.path.join(root, KITTI_DRIVE, "image_02", "data", "0000010000.png")
        pixels = read_png(frame)
        decode = {"the tree's (Sub/Up/Average/Paeth rows)": decode_ms(frame),
                  "the tree's, numpy unfilter": decode_ms(frame, compiled=False)}
        for name, filters in (("filter 0", 0), ("Paeth", 4)):
            write_png(os.path.join(tmp, "one.png"), pixels, filter_type=filters)
            decode[name] = decode_ms(os.path.join(tmp, "one.png"))

        # training through the CLI, its loader and steps timed
        batch_s, steps = [], []
        make_batch, make_step = BatchLoader._make_batch, trainer_module.make_train_step

        def timed_batch(self, *args):
            t = time.perf_counter()
            out = make_batch(self, *args)
            if self.dataset.is_train:
                batch_s.append(time.perf_counter() - t)
            return out

        def timed_make_train_step(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def timed(batch):
                # no wait here: the Trainer reads the losses on log steps only;
                # a marker kernel before and after the step's launches bounds
                # its window on the device's clock
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                t = time.perf_counter()
                with torch.profiler.record_function(KITTI_STEP):
                    torch.cuda._sleep(1)
                    start.record()
                    out = step(batch)
                    end.record()
                    torch.cuda._sleep(1)
                steps.append((t, time.perf_counter(), start, end, out))
                return out
            return timed

        argv = ["--stage", "stage1", "--data_path", root, "--split", split, "--png",
                "--allow_random_pc", "--num_epochs", "1", "--log_dir", log_dir,
                "--model_name", "kitti"]
        BatchLoader._make_batch = timed_batch
        trainer_module.make_train_step = timed_make_train_step
        activities = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=activities) as prof:
                trainer = cli_train.main(argv)
                torch.cuda.synchronize(dev)
            train_s = time.perf_counter() - t0
            train_launches = launch_counts()
        finally:
            BatchLoader._make_batch, trainer_module.make_train_step = make_batch, make_step
        cfg = trainer.cfg
        n_steps, n_val = len(KITTI_TRAIN) // cfg.per_step_batch, -(-len(KITTI_VAL) // cfg.per_step_batch)
        # the CLI's default is bf16, as the JAX CLI's: the sweep's bf16 instances
        want = with_panels(only(plane_sweep_bf16_fwd=n_steps, plane_sweep_bf16_bwd=n_steps,
                                head_epilogue_fwd=n_steps + n_val, head_epilogue_bwd=n_steps,
                                disp_head_fwd=n_val),
                           {"disp_head_fwd": 1, "head_epilogue_fwd": 1})
        if train_launches != want or len(steps) != n_steps or trainer.step_count != n_steps:
            raise AssertionError(f"kitti training: launches {train_launches} in {len(steps)} "
                                 f"steps, want {want} in {n_steps}")
        losses = [host_losses(s[4]) for s in steps]
        check_losses(losses, cfg)
        ckpt = os.path.join(log_dir, cfg.model_name, "last_models")
        saved = sorted(os.listdir(ckpt))
        if cfg.model_name != "kitti_ResNet" or saved != ["adam.pth", "depth.pth", "encoder.pth"]:
            raise AssertionError(f"kitti checkpoint {cfg.model_name}: {saved}")
        if not os.path.isdir(os.path.join(log_dir, cfg.model_name, "best_models")):
            raise AssertionError("validation saved no best_models")
        del trainer
        free_cache()
        step_ms = [s[2].elapsed_time(s[3]) for s in steps]
        traced = device_step_windows(prof)
        del prof
        if traced["markers"] != 2 * n_steps or not all(traced["busy"]):
            raise AssertionError(f"kitti training: the trace has {traced} for {n_steps} steps")
        waits = [steps[i][0] - steps[i - 1][1] for i in range(1, len(steps))]

        # ground truth, then the evaluate CLI's first part and evaluate
        os.makedirs(os.path.join(splits_dir, "eigen_raw"))
        t0 = time.perf_counter()
        gt_path = export_eigen_raw_gt(root, os.path.dirname(split_path("eigen_raw", "test")),
                                      os.path.join(splits_dir, "eigen_raw", "gt_depths.npz"))
        export_s = time.perf_counter() - t0
        args, ecfg, model = cli_evaluate.load(
            ["--eval_stereo", "--eval_split", "eigen_raw", "--post_process", "--png",
             "--data_path", root, "--load_weights_folder", ckpt])
        kwargs = dict(cli_evaluate.evaluate_kwargs(args), splits_dir=splits_dir,
                      save_pred_disps=os.path.join(tmp, "disps.npy"))
        predict = evaluator_module.predict_split_disparities
        predict_s = []

        def timed_predict(*a, **kw):
            t = time.perf_counter()
            out = predict(*a, **kw)
            predict_s.append(time.perf_counter() - t)
            return out

        evaluator_module.predict_split_disparities = timed_predict
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            metrics = evaluator_module.evaluate(ecfg, model, **kwargs)
            eval_s = time.perf_counter() - t0
            eval_launches = launch_counts()
        finally:
            evaluator_module.predict_split_disparities = predict
        n_frames = len(test_lines)
        n_batches = -(-n_frames // 4)
        if eval_launches != only(disp_head_fwd=n_batches, head_epilogue_fwd=n_batches):
            raise AssertionError(f"evaluate launches {eval_launches}, want {n_batches} each of "
                                 f"the disp head and the head epilogue")
        disps = np.load(kwargs["save_pred_disps"])
        if disps.shape != (n_frames, ecfg.data.height, ecfg.data.width) \
                or not np.isfinite(disps).all():
            raise AssertionError(f"bad disparities {disps.shape}")
        names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
        if sorted(metrics) != sorted(names) or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"evaluate metrics {metrics}")
        small_err = check_against_cpu_bf16(model, dev)
        del model
        free_cache()
    print(f"[kitti] tree: {n_frames} eigen_raw frames (both cameras, a {KITTI_SCAN_POINTS}-point "
          f"scan each) over {len(set(ln.split()[0] for ln in test_lines))} drives at each "
          f"date's KITTI size, {len(KITTI_TRAIN)} train and {len(KITTI_VAL)} val lines (val "
          f"with scans): {tree_bytes / 1e6:.1f} MB written in {write_s:.1f} s; native "
          f"data library {'loaded' if native.available() else 'missing: numpy fallbacks ran'}; "
          f"PNG row unfilter: {png_decoder()}")
    print(f"[kitti] read_png of a {pixels.shape[1]}x{pixels.shape[0]} RGB frame on the host: "
          f"{json.dumps({k: round(v, 2) for k, v in decode.items()})} ms (median of 5)")
    print(f"[kitti] cli.train.main {' '.join(argv[:2])} (ResNet-{cfg.model.num_layers}, "
          f"DenseASPP, {cfg.model.planes.disp_levels}+{cfg.model.planes.xz_levels} planes, "
          f"VGG19, {cfg.data.width}x{cfg.data.height}, batch {cfg.per_step_batch} flipped to "
          f"{cfg.effective_batch}): {n_steps} steps and {n_val} validation batches in "
          f"{train_s:.1f} s, launches {train_launches} (want {want}); first/last losses "
          f"{json.dumps(losses[0])} {json.dumps(losses[-1])}; saved {saved}")
    print(f"[kitti] loader host ms per batch of {cfg.per_step_batch} (decode + resize + "
          f"augmentation, {cfg.data.num_workers} threads): median "
          f"{statistics.median(batch_s) * 1e3:.2f}, all {[round(b * 1e3, 1) for b in batch_s]}; "
          f"under torch.profiler, the steps unsynchronised (device prefetch, losses read on "
          f"log steps): step span ms (CUDA events around the step's launches) median "
          f"{statistics.median(step_ms):.2f}, all {[round(t, 1) for t in step_ms]}; "
          f"device busy ms in each step's device window (between marker kernels before "
          f"and after its launches; kernels and copies) median "
          f"{statistics.median(traced['busy']):.2f}, all "
          f"{[round(b, 1) for b in traced['busy']]}; host gap between the steps' launches "
          f"median {statistics.median(waits) * 1e3:.2f} ms; the card's idle share of steps "
          f"2-{n_steps}'s device wall {traced['idle_in'] + traced['idle_between']:.4f} = "
          f"{traced['idle_in']:.4f} inside the steps + {traced['idle_between']:.4f} between "
          f"them | {card}")
    print(f"[kitti] export_eigen_raw_gt: {n_frames} frames in {export_s:.1f} s -> {gt_path}")
    print(f"[kitti] evaluate (cli.evaluate.load + evaluate, eigen_raw, post_process, batch 4 "
          f"doubled to 8, {ecfg.data.width}x{ecfg.data.height}): {n_frames} frames in "
          f"{eval_s:.2f} s = {n_frames / eval_s:.2f} frames/s, prediction alone "
          f"{predict_s[0]:.2f} s = {n_frames / predict_s[0]:.2f} frames/s; launches "
          f"{eval_launches}; bf16 (the CLI's default) card vs CPU forward at 64x192, "
          f"|card - CPU| beside the CPU's |bf16 - float32|, mean, 99.9th percentile, max: "
          f"{json.dumps({k: [float(f'{x:.3e}') for x in v] for k, v in small_err.items()})}"
          f" | {card}")
    print(f"[kitti] eigen_raw metrics (random weights, shows the path runs): "
          f"{json.dumps(metrics)}")
    return {"train": train_launches, "evaluate": eval_launches}


# ---------------------------------------------------------------------------
# bf16, the JAX package's default arithmetic (TrainConfig.bf16): the sweep's
# and the 2-D warp's bf16 instances, the sweep's column segments (C10), and
# the recipes in bf16 beside their float32 runs
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# rows wider than the sweep's widest launch (csrc/plane_sweep.cu:kMaxW), which
# run in column segments
WIDE_SHAPES = ((1, 63, 8, 2560), (1, 63, 8, 4096))


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    a = x.detach().float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def as_bf16(inputs, float_idx):
    """The operands in bf16 but for the float32 ones at ``float_idx`` (the
    sweep's shift and mask, the warp's dx, dy and mask), each a fresh leaf
    that requires grad where the float32 one did."""
    return [None if t is None else
            (t.detach() if i in float_idx else t.detach().to(BF16)).requires_grad_(
                t.requires_grad) for i, t in enumerate(inputs)]


class HeldBf16:
    """The worst errors of a bf16 kernel pair against its plain version:
    every bf16 output (forward, and the heads' gradients) within one bf16
    ulp of the plain value plus the float32 instance's tolerance (TOL
    forward, GRAD_TOL of the gradient's scale), every float32 output at the
    float32 instance's tolerance; the worst error in ulps of the value and
    in absolute terms.  ``plain_grad_out``: the plain outputs whose
    gradients are compared, where they are not ``plain_out`` (the sweep's
    plain version anchored at the kernel's rounded reconstruction).
    ``segmented``: the row ran in column segments, whose overlapping bf16
    gradient windows are added and rounded once more, so a bf16 gradient
    may be one more ulp of its largest magnitude away."""

    def __init__(self):
        self.fwd, self.fwd_ulps, self.abs, self.rel, self.ulps = 0.0, 0.0, {}, {}, {}

    def hold(self, kernel_out, plain_out, inputs, diff, names, seed, no_cotangent=(),
             plain_grad_out=None, segmented=False):
        for a, b in zip(kernel_out, plain_out):
            if a.dtype != b.dtype or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"output {a.dtype} vs plain {b.dtype}, finite "
                                     f"{bool(torch.isfinite(a).all())}")
            a, b = a.detach(), b.detach()
            err = (a.float() - b.float()).abs()
            tol = TOL["atol"] + TOL["rtol"] * b.float().abs()
            if a.dtype == BF16:
                over = err - bf16_ulp(b) - tol
                # ulps beyond the float32 tolerance: at most 1
                self.fwd_ulps = max(self.fwd_ulps,
                                    float(((err - tol).clamp_min(0) / bf16_ulp(b)).max()))
            else:
                over = err - tol
            if float(over.max()) > 0:
                raise AssertionError(f"{a.dtype} output at {tuple(a.shape)}: over its bound "
                                     f"by {float(over.max()):.3e}")
            self.fwd = max(self.fwd, float(err.max()))
        g = torch.Generator(device=a.device).manual_seed(seed)
        cts = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype)
               for o in kernel_out]
        for i in no_cotangent:
            cts[i].zero_()
        wrt = [inputs[i] for i in diff]
        live = [i for i, o in enumerate(kernel_out) if o.requires_grad]
        pick = lambda seq: [seq[i] for i in live]
        d_got = torch.autograd.grad(pick(kernel_out), wrt, pick(cts))
        torch.cuda.synchronize()
        d_want = torch.autograd.grad(pick(plain_out if plain_grad_out is None
                                          else plain_grad_out), wrt, pick(cts))
        for name, a, b in zip(names, d_got, d_want):
            if a.dtype != b.dtype or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: {a.dtype} vs {b.dtype}")
            scale = float(b.float().abs().max())
            err = (a.float() - b.float()).abs()
            ulp = bf16_ulp(b) if a.dtype == BF16 else torch.zeros_like(err)
            if segmented and a.dtype == BF16:
                ulp = ulp + float(bf16_ulp(torch.tensor(scale)))
            over = float((err - ulp).max()) - GRAD_TOL * scale
            if over > 0:
                raise AssertionError(f"{name} ({a.dtype}) at {tuple(a.shape)}: over one bf16 "
                                     f"ulp + {GRAD_TOL} x {scale:.3e} by {over:.3e}")
            self.abs[name] = max(float(err.max()), self.abs.get(name, 0.0))
            self.rel[name] = max(float(err.max()) / max(scale, 1e-30), self.rel.get(name, 0.0))
            if a.dtype == BF16:
                beyond = (err - GRAD_TOL * scale).clamp_min(0) / bf16_ulp(b)
                self.ulps[name] = max(float(beyond.max()), self.ulps.get(name, 0.0))

    def describe(self):
        fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})
        return (f"forward max_abs_err {self.fwd:.3e} (bf16 outputs: worst {self.fwd_ulps:.2f} "
                f"ulps beyond the float32 tolerance); grads max_abs_err {fmt(self.abs)}, over "
                f"max |value| {fmt(self.rel)}, bf16 gradients' worst ulps beyond the float32 "
                f"tolerance {fmt(self.ulps)} (bound: 1)")


def sweep_bytes(inputs, with_disp):
    """Bytes of the sweep forward and backward (``with_auto`` off), each
    input read once and each output written once, at the operands' own
    element sizes: the reconstruction and the heads' gradients in their
    dtype, the NLL, disp, statistics and d_shift float32."""
    src, tgt, logits, sigma, shift, mask = inputs
    B, N, H, W = logits.shape
    row, es = B * H * W * 4, logits.element_size()
    rows_out = 1 + int(with_disp)                        # nll, disp
    stats = 7 if with_disp else 4
    fwd = nbytes(*inputs) + 3 * B * H * W * es + row * (rows_out + stats)
    bwd = (nbytes(*inputs) + row * stats + 2 * 3 * B * H * W * es + row * rows_out
           + nbytes(logits, sigma, shift))
    return fwd, bwd


def time_sweep_bf16(inputs32, inputs16, pad):
    """The bf16 sweep kernels alone beside the float32 ones on the same
    values, their plain version, and the bounds in the bf16 instance's
    bytes (the disp on, the automask off, as the stage-1 and FalNet steps
    launch them)."""
    times = {"info": {}}
    for tag, inputs in (("f32", inputs32), ("bf16", inputs16)):
        src, tgt, logits, sigma, shift, mask = inputs
        B, N, H, W = logits.shape
        mix = sigma is not None
        suffix = "_bf16" if tag == "bf16" else ""
        times["info"][tag] = {d: sweep_kernel_info(d == "bwd", mix, N, W, bf16=bool(suffix))
                              for d in ("fwd", "bwd")}
        with torch.no_grad():
            rgb = torch.empty((B, 3, H, W), dtype=logits.dtype, device=logits.device)
            new = lambda *size: torch.empty(size, device=logits.device)
            nll, disp, stats = new(B, H, W), new(B, H, W), new(B, 7, H, W)
            limit = shift_max(pad)
            times[f"{tag}_fwd_ms"] = launch_ms(
                f"pdt_plane_sweep_fwd{suffix}",
                (src, tgt, logits, sigma, shift, mask, rgb, nll, None, disp, stats),
                B, N, H, W, limit, 0, 1, int(mix))
            g = (torch.randn_like(rgb), torch.randn_like(nll), torch.randn_like(disp))
            grads = (torch.empty_like(logits), torch.empty_like(logits) if mix else None,
                     torch.empty_like(shift))
            times[f"{tag}_bwd_ms"] = launch_ms(
                f"pdt_plane_sweep_bwd{suffix}",
                (src, tgt, logits, sigma, shift, mask, stats, rgb, *g, *grads),
                B, N, H, W, limit, 1, int(mix))
            del rgb, nll, disp, stats, g, grads
    heads = [t for t in inputs16[2:5] if t is not None]
    plain = lambda: plane_sweep_plain(*inputs16, pad, False, True)
    with torch.no_grad():
        times["plain_fwd_ms"] = cuda_ms(plain, warmup=1, reps=3)
    out = plain()
    cts = [torch.randn_like(o) for o in out]
    times["plain_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(plain(), heads, cts),
                                    warmup=1, reps=3) - times["plain_fwd_ms"]
    del out, cts
    fwd_bytes, bwd_bytes = sweep_bytes(inputs16, True)
    n = inputs16[2].numel()
    times.update(fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes,
                 fwd_bound=bound(fwd_bytes, 60 * n), bwd_bound=bound(bwd_bytes, 100 * n))
    return times


def bf16_fields(held, t, extra=None):
    """The kernels line's entries of a bf16 pair, timed as ``t``; the times
    at other shapes (``extra``) beside them."""
    more = lambda d: {"at": [{"shape": list(at), "ms": x[f"bf16_{d}_ms"],
                              "float32_ms": x[f"f32_{d}_ms"], "bound_ms": x[f"{d}_bound"][0]}
                             for at, x in (extra or {}).items()]}
    info = lambda d: ({"kernel_info": t["info"]["bf16"][d],
                       "float32_kernel_info": t["info"]["f32"][d]}
                      if d in t.get("info", {}).get("bf16", {}) else {})
    fwd = {"max_abs_err": held.fwd, "max_ulps": held.fwd_ulps, "ms": t["bf16_fwd_ms"],
           "float32_ms": t["f32_fwd_ms"], "plain_ms": t["plain_fwd_ms"],
           "bound_ms": t["fwd_bound"][0], "bound_by": t["fwd_bound"][1],
           "library_ms": t.get("lib_fwd_ms"), **info("fwd"), **more("fwd")}
    bwd = {"max_abs_err": max(held.abs.values()), "max_rel_err": max(held.rel.values()),
           "max_ulps": max(held.ulps.values()), "ms": t["bf16_bwd_ms"],
           "float32_ms": t["f32_bwd_ms"], "plain_ms": t["plain_bwd_ms"],
           "bound_ms": t["bwd_bound"][0], "bound_by": t["bwd_bound"][1],
           "library_ms": t.get("lib_bwd_ms"), **info("bwd"), **more("bwd")}
    return fwd, bwd


def print_bf16_times(tag, at, t, card):
    for d in ("fwd", "bwd"):
        b = t[f"{d}_bound"][0]
        lib = (f"F.grid_sample on bf16 ({'forward' if d == 'fwd' else 'forward+backward less '
               'forward, also the rgb gradient'}) {t[f'lib_{d}_ms']:.4f} ms"
               if f"lib_{d}_ms" in t else "no single PyTorch call computes it")
        info = ""
        if d in t.get("info", {}).get("bf16", {}):
            i16, i32 = t["info"]["bf16"][d], t["info"]["f32"][d]
            info = (f"; bf16 instance {i16['registers']} registers (spills "
                    f"{i16['spill_bytes']} B), {i16['blocks_per_sm']} blocks an SM, "
                    f"{i16.get('smem_bytes', 0)} B shared, float32 {i32['registers']} / "
                    f"{i32['spill_bytes']} B / {i32['blocks_per_sm']} / "
                    f"{i32.get('smem_bytes', 0)} B")
            if d == "bwd" and "scratch_bytes" in t:
                info += f"; scratch {t['scratch_bytes']} B (float32 tap sums)"
            if d == "fwd" and "fwd_scratch_bytes" in t:
                info += f"; scratch {t['fwd_scratch_bytes']} B (src pixel-interleaved)"
        print(f"[{tag}] at {at}: {d} kernel alone bf16 {t[f'bf16_{d}_ms']:.4f} ms beside "
              f"float32 {t[f'f32_{d}_ms']:.4f} ms in this call (bf16 bound {b:.4f} ms of "
              f"{t[f'{d}_bytes'] / 1e6:.0f} MB, {b / t[f'bf16_{d}_ms']:.1%} of it); plain "
              f"{t[f'plain_{d}_ms']:.2f} ms; {lib}{info} | {card}")


def phase_sweep_bf16(card, shapes=(SWEEP_SHAPE, SHIFT_SHAPE), dev=torch.device("cuda")):
    """The sweep's bf16 instances (images, heads, rgb and the heads'
    gradients bf16) against their plain version in both mixture modes, at
    the stage-1 and the stage-3 student's shapes (the no-mixture mode at
    FalNet's 49 planes too), with seeded cotangents; then each timed beside
    its float32 instance.  Returns the kernels line's four entries."""
    pad = sweep_pad(stage1_config())
    fields = {}
    for mix in (True, False):
        held, timed = HeldBf16(), {}
        names = ("d_logits", "d_sigma", "d_shift") if mix else ("d_logits", "d_shift")
        diff = (2, 3, 4) if mix else (2, 4)
        cases = shapes if mix else shapes + (FALNET_SHAPE,)
        for i, at in enumerate(cases):
            inputs32 = seeded_sweep_inputs(at, 80 + i, dev)
            if not mix:
                inputs32[3] = None
            inputs16 = as_bf16(inputs32, (4, 5))
            with_auto = mix
            got = plane_sweep(*inputs16, pad, with_auto, True)
            # the backward reads the reconstruction as rounded (A = U (G .
            # rgb)): where the kernel's and the plain version's float32 sums
            # straddle a bf16 rounding point the two round it one ulp apart,
            # which d_shift sums over the row; so the gradients are held to
            # the plain version anchored at the kernel's rounded rgb
            held.hold(got, plane_sweep_plain(*inputs16, pad, with_auto, True), inputs16, diff,
                      names, 90 + i, plain_grad_out=plane_sweep_plain(
                          *inputs16, pad, with_auto, True, rounded_rgb=got[0]))
            del got
            free_cache()
            timed[at] = time_sweep_bf16(inputs32, inputs16, pad)
            del inputs32, inputs16
            free_cache()
        tag = "sweep_bf16" if mix else "sweep_nomix_bf16"
        print(f"[{tag}] plane_sweep on bf16 images and heads vs plain at {', '.join(map(str, cases))} "
              f"(automask {mix}, disp on): {held.describe()} | {card}")
        for at, t in timed.items():
            print_bf16_times(tag, at, t, card)
        main = shapes[0] if mix else FALNET_SHAPE
        fwd, bwd = bf16_fields(held, timed[main], {a: x for a, x in timed.items() if a != main})
        name = "plane_sweep_bf16" if mix else "plane_sweep_nomix_bf16"
        fields[f"{name}_fwd"], fields[f"{name}_bwd"] = fwd, bwd
    return fields


# the bf16 warp's held cases beside the mono shape: odd shapes with degenerate
# coordinates (W odd: the rounding one pixel a thread), planes of only
# degenerate samples, a zoom of 200 px, more planes than a launch's grid
# takes (B * N > 65535: launches in whole images)
WARP_BF16_HELD = (((2, 5, 7, 200), dict(degenerate=True)),
                  ((2, 63, 9, 97), dict(degenerate=True)),
                  ((2, 3, 24, 100), dict(degenerate=True, dead_plane=True)),
                  ((2, 3, 48, 200), dict(zoom=200.0)), ((2, 33000, 2, 5), {}))


# the bf16 forward's edge cases beside WARP_BF16_HELD (whose (2, 63, 9, 97)
# has W odd): W odd (61: the last thread of a row has one column) and W = 3
# mod 4 (99), with taps at x0 = W - 1 and -1, y0 = H - 1 and -1
WARP_FWD_EDGES = (((2, 5, 7, 61), dict(edges=True)),
                  ((2, 4, 6, 99), dict(edges=True, degenerate=True)))
# src, logits and sigma passed as views whose last element ends their allocation
WARP_VIEW_CASE = ((2, 3, 8, 131), dict(edges=True))


def at_allocation_end(t):
    """``t``'s values in a view of a buffer one element longer, at storage
    offset 1, so that its last element ends the buffer (in bf16 2 bytes off
    a 4-byte boundary); a leaf that requires grad where ``t`` does."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.detach().flatten()
    return buf[1:].view(t.shape).detach().requires_grad_(t.requires_grad)


def fwd_writes_every_element(inputs16, got, with_sigma):
    """The bf16 forward's entry point on outputs filled with NaN and a
    scratch of garbage: no NaN left, and every output the autograd
    wrapper's ``got`` bit for bit."""
    B, N, H, W = inputs16[3].shape
    ops = [None if t is None else t.detach() for t in inputs16]
    outs = [torch.full_like(o, float("nan")) for o in got]
    scratch = torch.full((warp2d_fwd_scratch_bytes(B, H, W),), 0xA5, dtype=torch.uint8,
                         device=ops[3].device)
    _build.launch("pdt_warp2d_fwd_bf16", *ops, *(outs + [None] * (3 - len(outs))), scratch,
                  B, N, H, W, int(with_sigma))
    torch.cuda.synchronize()
    for a, b in zip(outs, got):
        if bool(torch.isnan(a).any()) or not torch.equal(a.view(torch.int16),
                                                         b.detach().view(torch.int16)):
            raise AssertionError(f"bf16 warp forward at {(B, N, H, W)}: an element not "
                                 "written, or not the wrapper's")


def writes_every_element(inputs16, got, with_sigma):
    """The bf16 backward's entry point on outputs filled with NaN and a
    scratch of garbage, under seeded cotangents: no NaN left in d_logits,
    d_sigma, d_dx and d_dy, and d_dx, d_dy equal to those the autograd
    wrapper's launch gives for the same cotangents."""
    B, N, H, W = inputs16[3].shape
    g = torch.Generator(device=got[0].device).manual_seed(7)
    cts = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype) for o in got]
    wrt = [t for t in inputs16[1:5] if t is not None]
    want = torch.autograd.grad(got, wrt, cts, retain_graph=True)
    nan = lambda t: torch.full_like(t, float("nan"))                  # noqa: E731
    ops = [None if t is None else t.detach() for t in inputs16]
    outs = [nan(ops[1]), nan(ops[2]) if with_sigma else None, nan(ops[3]), nan(ops[4])]
    scratch = torch.full((warp2d_scratch_bytes(B, N, H, W, with_sigma),), 0xA5,
                         dtype=torch.uint8, device=ops[3].device)
    _build.launch("pdt_warp2d_bwd_bf16", *ops, *(cts + [None] * (3 - len(cts))), *outs,
                  scratch, B, N, H, W, int(with_sigma))
    torch.cuda.synchronize()
    outs = [o for o in outs if o is not None]
    if any(bool(torch.isnan(o).any()) for o in outs):
        raise AssertionError(f"bf16 warp backward at {(B, N, H, W)}: an element not written")
    if not (torch.equal(outs[-2], want[-2]) and torch.equal(outs[-1], want[-1])):
        raise AssertionError(f"bf16 warp backward at {(B, N, H, W)}: d_dx, d_dy differ "
                             "between two launches")


def phase_warp2d_bf16(card, shape=SWEEP_SHAPE, dev=torch.device("cuda")):
    """The 2-D warp's bf16 instances (src, heads and the three stacks bf16,
    dx, dy and their gradients float32) against their plain version with
    and without sigma, on WARP_BF16_HELD's and WARP_FWD_EDGES' cases,
    WARP_VIEW_CASE (src and the heads as views at the end of their
    allocation) and at the mono step's shape, each with a plane masked
    whole, and both entry points on outputs filled with NaN (every element
    written; the forward's the wrapper's bit for bit); then each timed
    beside its float32 instance.  Returns the kernels line's four entries."""
    fields = {}
    cases = WARP_BF16_HELD + WARP_FWD_EDGES + (WARP_VIEW_CASE, (shape, {}))
    for with_sigma in (True, False):
        held = HeldBf16()
        diff = (1, 2, 3, 4) if with_sigma else (1, 3, 4)
        names = (("d_logits", "d_sigma", "d_dx", "d_dy") if with_sigma
                 else ("d_logits", "d_dx", "d_dy"))
        for i, (at, kw) in enumerate(cases):
            inputs32 = seeded_warp_inputs(at, 30 + i, dev, **kw)
            if not with_sigma:
                inputs32[2] = None
            inputs32[5][0, 1 % at[1]] = 0.0               # a plane masked whole
            inputs16 = as_bf16(inputs32, (3, 4, 5))
            if (at, kw) == WARP_VIEW_CASE:
                inputs16[:3] = [None if t is None else at_allocation_end(t)
                                for t in inputs16[:3]]
            got = warp2d(*inputs16)
            fwd_writes_every_element(inputs16, got, with_sigma)
            writes_every_element(inputs16, got, with_sigma)
            held.hold(got, warp2d_plain(*inputs16), inputs16, diff, names, i)
            del got
            free_cache()
        B, N, H, W = shape
        t = {}
        for tag, inputs in (("f32", inputs32), ("bf16", inputs16)):
            suffix = "_bf16" if tag == "bf16" else ""
            src, logits, sigma, dx, dy, mask = inputs
            with torch.no_grad():
                outs = [torch.empty((B, N, 3, H, W), dtype=logits.dtype, device=dev),
                        torch.empty_like(logits),
                        torch.empty_like(logits) if with_sigma else None]
                if tag == "bf16":
                    # the bf16 entry packs src into its scratch: timed with it
                    outs.append(torch.empty(warp2d_fwd_scratch_bytes(B, H, W),
                                            dtype=torch.uint8, device=dev))
                    t["fwd_scratch_bytes"] = outs[-1].numel()
                t[f"{tag}_fwd_ms"] = launch_ms(f"pdt_warp2d_fwd{suffix}", (*inputs, *outs),
                                               B, N, H, W, int(with_sigma))
                cts = [None if o is None else torch.randn_like(o) for o in outs[:3]]
                d_xy = [torch.empty_like(dx), torch.empty_like(dy)]
                if tag == "bf16":
                    # the bf16 entry clears its own scratch: timed with it
                    scratch = torch.empty(warp2d_scratch_bytes(B, N, H, W, with_sigma),
                                          dtype=torch.uint8, device=dev)
                    heads_out = [torch.empty_like(logits),
                                 torch.empty_like(logits) if with_sigma else None]
                    args = (*inputs, *cts, *heads_out, *d_xy, scratch)
                    t["scratch_bytes"] = scratch.numel()
                else:
                    # the float32 entry adds into buffers its wrapper zeroes:
                    # timed alone, on buffers zeroed once
                    heads_out = [torch.zeros(logits.shape, device=dev),
                                 torch.zeros(logits.shape, device=dev) if with_sigma else None]
                    args = (*inputs, *cts, *heads_out, *d_xy)
                t[f"{tag}_bwd_ms"] = launch_ms(f"pdt_warp2d_bwd{suffix}", args,
                                               B, N, H, W, int(with_sigma))
                t.setdefault("info", {})[tag] = {
                    d: warp_kernel_info(with_sigma, bf16=tag == "bf16", forward=d == "fwd")
                    for d in ("fwd", "bwd")}
                del outs, cts, d_xy, heads_out, args
        wrt = [inputs16[i] for i in diff]
        # the wrapper's backward through autograd: the entry (its scratch
        # cleared inside), the scratch's allocation and autograd's own work
        out = warp2d(*inputs16)
        cts = [torch.randn_like(o) for o in out]
        t["autograd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(out, wrt, cts,
                                                                   retain_graph=True))
        t["autograd_loop_ms"] = loop_ms(lambda: torch.autograd.grad(out, wrt, cts,
                                                                    retain_graph=True))
        del out, cts
        with torch.no_grad():
            t["plain_fwd_ms"] = cuda_ms(lambda: warp2d_plain(*inputs16), warmup=1, reps=3)
        out = warp2d_plain(*inputs16)
        cts = [torch.randn_like(o) for o in out]
        t["plain_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(warp2d_plain(*inputs16), wrt,
                                                                cts),
                                    warmup=1, reps=3) - t["plain_fwd_ms"]
        stacks = nbytes(*out)
        t["fwd_bytes"] = nbytes(*inputs16) + stacks
        # backward: the operands and the stacks' cotangents read, the heads'
        # bf16 gradients and dx's and dy's written; the float32 tap sums'
        # round trip to the rounding kernel is the instance's own cost
        t["bwd_bytes"] = nbytes(*inputs16) + stacks + nbytes(*wrt)
        n = inputs16[3].numel()
        t["fwd_bound"] = bound(t["fwd_bytes"], 60 * n)
        t["bwd_bound"] = bound(t["bwd_bytes"], 100 * n)
        del out, cts, wrt
        # the library call on bf16 operands: (B*N, 5 or 4, H, W)
        src, logits, sigma, dx, dy, _ = inputs16
        t["lib_fwd_ms"], lib_ms = grid_sample_ms(
            src, [logits] + ([sigma] if with_sigma else []), dx, dy)
        t["lib_bwd_ms"] = lib_ms - t["lib_fwd_ms"]
        del inputs32, inputs16, src, logits, sigma, dx, dy
        free_cache()
        tag = "warp2d_bf16" if with_sigma else "warp2d_nosigma_bf16"
        print(f"[{tag}] warp2d on bf16 src and heads vs plain at "
              f"{', '.join(str(at) for at, _ in cases)} (degenerate coordinates, "
              f"dead planes, zoom 200, > 65535 planes, W odd and W = 3 mod 4 with taps at "
              f"x0 = W - 1, -1 and y0 = H - 1, -1, src and heads as views ending their "
              f"allocation at {WARP_VIEW_CASE[0]}), a plane masked whole in each; every "
              f"forward and backward element written (NaN-filled outputs), the forward "
              f"entry's the wrapper's bit for bit: {held.describe()} | {card}")
        print_bf16_times(tag, shape, t, card)
        print(f"[{tag}] at {shape}: bf16 backward through autograd {t['autograd_bwd_ms']:.4f} "
              f"ms ({t['autograd_loop_ms']:.4f} ms a call in a run of 20) | {card}")
        fwd, bwd = bf16_fields(held, t)
        fwd.update(scratch_bytes=t["fwd_scratch_bytes"])
        bwd.update(autograd_ms=t["autograd_bwd_ms"], autograd_loop_ms=t["autograd_loop_ms"],
                   scratch_bytes=t["scratch_bytes"])
        fields[f"{tag}_fwd"], fields[f"{tag}_bwd"] = fwd, bwd
    return fields


def phase_sweep_wide(card, shapes=WIDE_SHAPES, dev=torch.device("cuda")):
    """C10: rows wider than one launch takes run in column segments with a
    right halo.  At each width the forward and the head-only backward (with
    and without the automask) in float32 and in bf16, and the
    image-gradient backward, against the plain version, and the launches
    one call makes: one a segment."""
    pad = sweep_pad(stage1_config())
    held, held16 = Held(), HeldBf16()
    segs = {}
    names = ("d_logits", "d_sigma", "d_shift")
    for i, at in enumerate(shapes):
        for with_auto in (False, True):
            inputs = seeded_sweep_inputs(at, 100 + i, dev)
            reset_launch_counts()
            got = plane_sweep(*inputs, pad, with_auto, True)
            n = launch_counts()["plane_sweep_fwd"]
            held.hold(got, plane_sweep_plain(*inputs, pad, with_auto, True), inputs, (2, 3, 4),
                      names, 110 + i)
            segs[at] = (n, launch_counts()["plane_sweep_bwd"])
            inputs = as_bf16(inputs, (4, 5))
            reset_launch_counts()
            got = plane_sweep(*inputs, pad, with_auto, True)
            held16.hold(got, plane_sweep_plain(*inputs, pad, with_auto, True), inputs,
                        (2, 3, 4), names, 140 + i, segmented=True,
                        plain_grad_out=plane_sweep_plain(*inputs, pad, with_auto, True,
                                                         rounded_rgb=got[0]))
            n16 = (launch_counts()["plane_sweep_bf16_fwd"],
                   launch_counts()["plane_sweep_bf16_bwd"])
            if n16 != segs[at]:
                raise AssertionError(f"{at}: bf16 launches {n16}, float32 {segs[at]}")
            del got, inputs
        inputs = image_grad_inputs(at, 120 + i, dev)
        reset_launch_counts()
        got = plane_sweep(*inputs, pad, True, True)
        held.hold(got, plane_sweep_plain(*inputs, pad, True, True), inputs, (0, 1, 2, 3, 4),
                  ("d_src", "d_tgt") + names, 130 + i)
        img = launch_counts()["plane_sweep_img_bwd"]
        if img != segs[at][0] or segs[at] != (segs[at][1],) * 2 or img < 2:
            raise AssertionError(f"{at}: launches {segs[at]}, image-gradient {img}")
        del got, inputs
        free_cache()
    print(f"[sweep_wide] C10: plane_sweep at {', '.join(map(str, shapes))} in column "
          f"segments of at most {_build.load_library().pdt_plane_sweep_max_w()} "
          f"(launches a call {json.dumps({str(k): v[0] for k, v in segs.items()})}): forward, "
          f"head-only backward (automask off and on) and image-gradient backward vs plain: "
          f"{held.describe()}; bf16 forward and head-only backward vs plain (one more ulp of "
          f"the gradient's largest magnitude where segments overlap): {held16.describe()} "
          f"| {card}")


def idle_share(step, label="pdt_step", n=3):
    """The card's idle share inside ``n`` calls of ``step`` (each
    synchronised): their span less the device's busy time, over their
    span, from a torch.profiler trace."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            with torch.profiler.record_function(label):
                step()
                torch.cuda.synchronize()
    traced = step_device_busy(prof, label)
    span = sum(s for s, _ in traced)
    busy = sum(b for _, b in traced)
    if len(traced) != n or busy <= 0:
        raise AssertionError(f"the profiler saw {traced}")
    return 1.0 - busy / span


def bf16_vs_f32_step(cfg, dev, seed=1):
    """One training step of ``cfg`` in bf16 and in float32 on the card from
    the same weights and batch: each loss's difference, held to
    BF16_STEP_LOSS_TOL."""
    batch = step_batch(cfg, seed)
    losses = []
    for bf16 in (True, False):
        c = cfg.replace(bf16=bf16, allow_random_pc=True)
        bundle = ModelBundle(c, dev)
        distinct_teacher(bundle, c.seed + 1)
        opt, sched = make_optimizer(c, bundle.parameters(), 1000)
        losses.append(host_losses(make_train_step(bundle, opt, sched)(
            batch_to_tensors(batch, dev))))
        del bundle, opt, sched
        free_cache()
    rtol, atol = BF16_STEP_LOSS_TOL
    diff = {k: abs(losses[0][k] - v) for k, v in losses[1].items()}
    if any(d > rtol * abs(losses[1][k]) + atol for k, d in diff.items()):
        raise AssertionError(f"bf16 vs float32 losses {losses}")
    return diff


# bf16 keeps 8 significant bits (a loss of order 1 to ~4e-3): one step's
# losses from the same weights, (rtol, atol)
BF16_STEP_LOSS_TOL = (2e-2, 5e-3)


def bf16_step(per_step):
    """A step's launch counts with the sweep and the 2-D warp in their bf16
    instances."""
    out = dict(per_step)
    for k in ("plane_sweep_fwd", "plane_sweep_bwd", "plane_sweep_nomix_fwd",
              "plane_sweep_nomix_bwd", "warp2d_fwd", "warp2d_bwd", "warp2d_nosigma_fwd",
              "warp2d_nosigma_bwd"):
        n, out[k] = out[k], 0
        key = {"plane_sweep_fwd": "plane_sweep_bf16_fwd", "plane_sweep_bwd":
               "plane_sweep_bf16_bwd", "plane_sweep_nomix_fwd": "plane_sweep_nomix_bf16_fwd",
               "plane_sweep_nomix_bwd": "plane_sweep_nomix_bf16_bwd",
               "warp2d_fwd": "warp2d_bf16_fwd", "warp2d_bwd": "warp2d_bf16_bwd",
               "warp2d_nosigma_fwd": "warp2d_nosigma_bf16_fwd",
               "warp2d_nosigma_bwd": "warp2d_nosigma_bf16_bwd"}[k]
        out[key] = out.get(key, 0) + n
    return out


def trainer_idle(cfg, dev, per_step, after_val, warmup, steps):
    """``trainer_run`` of ``cfg``, then the card's idle share inside 3 more
    steps of a bundle of the same configuration."""
    run = trainer_run(cfg, dev, warmup, steps, per_step, after_val)
    c = run["cfg"]
    bundle = ModelBundle(c, dev)
    distinct_teacher(bundle, c.seed + 1)
    opt, sched = make_optimizer(c, bundle.parameters(), 1000)
    step = make_train_step(bundle, opt, sched)
    batch = batch_to_tensors(step_batch(c, 0), dev)
    step(batch)
    run["idle"] = idle_share(lambda: step(batch))
    del bundle, opt, sched, step, batch
    free_cache()
    return run


def phase_bf16_recipes(card, f32, dev=torch.device("cuda"), warmup=3, steps=10):
    """The recipes in bf16 (the JAX package's default) beside their float32
    runs of this call (``f32``: name -> step ms, peak GB): stage 1 through
    the Trainer (13 steps), stage 2 -> stage 3 with the teacher (2 + 13),
    mono (13), mono without the mixture, FalNet and PladeNet (2 each), and
    the eval forward at 1280x384, batch 8; each with ms a step, peak memory
    and the card's idle share, and one step's losses from the same weights
    held to float32's.  Returns the bf16 kernels' launches on those paths."""
    val = {"disp_head_fwd": 1, "head_epilogue_fwd": 1}
    rows, launches = {}, {}
    free_cache()
    stage1 = stage1_config(model_name="stage1_bf16", bf16=True)
    run = trainer_idle(stage1, dev, bf16_step(STAGE1_STEP), val, warmup, steps)
    launches.update({k: run["launches"][k] for k in ("plane_sweep_bf16_fwd",
                                                      "plane_sweep_bf16_bwd")})
    rows["stage1"] = (run, bf16_vs_f32_step(stage1_config(
        data=DataConfig(height=192, width=640)), dev))

    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_") as log_dir:
        cfg2 = hr_finetune_config(log_dir=log_dir, allow_random_pc=True, bf16=True)
        h, w = cfg2.data.height, cfg2.data.width
        stage2 = Trainer(cfg2, datasets=(SyntheticStereo(2 * cfg2.per_step_batch, h, w),
                                         SyntheticStereo(cfg2.per_step_batch, h, w)),
                         device=dev)
        stage2.train()
        stage2.close()
        del stage2
        free_cache()
        ckpt = os.path.join(log_dir, cfg2.model_name, "last_models")
        stage3 = self_distillation_config(model_name="stage3_bf16", load_weights_folder=ckpt,
                                          bf16=True)
        run = trainer_idle(stage3, dev, bf16_step(DISTILL_STEP), val, warmup, steps)
    rows["stage3"] = (run, bf16_vs_f32_step(self_distillation_config(), dev))

    mono = mono_config(model_name="mono_bf16", bf16=True)
    run = trainer_idle(mono, dev, bf16_step(MONO_STEP), val, warmup, steps)
    launches.update({k: run["launches"][k] for k in ("warp2d_bf16_fwd", "warp2d_bf16_bwd")})
    rows["mono"] = (run, bf16_vs_f32_step(mono_config(), dev))

    nomix = dataclasses.replace(mono_config().model, use_mixture_loss=False)
    run = trainer_idle(mono_config(model_name="mono_nomix_bf16", model=nomix, bf16=True),
                       dev, bf16_step(NOMIX_MONO_STEP), {"head_epilogue_fwd": 1}, 1, 1)
    launches.update({k: run["launches"][k] for k in ("warp2d_nosigma_bf16_fwd",
                                                      "warp2d_nosigma_bf16_bwd")})
    rows["mono_nomix"] = (run, None)

    for name, model, per_step in (("falnet", FALNET_MODEL, FALNET_STEP),
                                  ("pladenet", PLADENET_MODEL, PLADENET_STEP)):
        cfg = stage1_config(model_name=f"{name}_bf16", model=model, bf16=True)
        run = trainer_idle(cfg, dev, bf16_step(per_step), {}, 1, 1)
        rows[name] = (run, bf16_vs_f32_step(stage1_config(model=model), dev))
        if name == "falnet":
            launches.update({k: run["launches"][k] for k in ("plane_sweep_nomix_bf16_fwd",
                                                              "plane_sweep_nomix_bf16_bwd")})

    for name, (run, rel) in rows.items():
        base = f32.get(name)
        beside = (f"; float32 in this call {base[0]:.2f} ms, peak {base[1]:.2f} GB"
                  if base else "")
        print(f"[bf16] {name} ({run['cfg'].model_name}, "
              f"{run['cfg'].data.width}x{run['cfg'].data.height}, batch "
              f"{run['cfg'].effective_batch}): {run['warmup']}+{run['steps']} steps through "
              f"Trainer, step {run['step_ms']:.2f} ms (CUDA events {run['event_ms']:.2f} ms), "
              f"peak {run['peak_gb']:.2f} GB allocated, {run['reserved_gb']:.2f} GB reserved, "
              f"idle {run['idle']:.4f} of 3 more steps{beside}; launches "
              f"{json.dumps(nonzero(run['launches']))}; last losses "
              f"{json.dumps(run['losses'][-1])}"
              + (f"; one step from the same weights vs float32: |loss difference| "
                 f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} (<= rtol "
                 f"{BF16_STEP_LOSS_TOL[0]} + atol {BF16_STEP_LOSS_TOL[1]})" if rel else "")
              + f" | {card}")
    eval_forward_bf16(card, f32.get("eval"), dev)
    return launches


def eval_forward_bf16(card, f32_ms, dev, batch=4):
    """The eval recipe's forward (ResNet-50, DenseASPP, 49+14 planes, PE 8)
    at 1280x384 on 4 images doubled to 8 by post-processing, bf16 beside
    float32 on the same weights: ms (CUDA events), peak memory, idle
    share; disp finite and non-negative; its mean distance from float32's
    printed."""
    cfg = ModelConfig()
    out = {}
    images = make_stereo_batch(batch, 384, 1280, seed=0)
    x = torch.from_numpy(images["color_l"]).permute(0, 3, 1, 2).to(dev)
    g = torch.from_numpy(images["grid"]).permute(0, 3, 1, 2).to(dev)
    x, g = torch.cat([x, x.flip(-1)]), torch.cat([g, g])
    for name, bf16 in (("bf16", True), ("f32", False)):
        model = init_weights_(build_depth_model(cfg, bf16),
                              torch.Generator().manual_seed(0)).to(dev).eval()
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats(dev)
            ms = cuda_ms(lambda: model(x, g))
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            idle = idle_share(lambda: model(x, g))
            disp = model(x, g)["disp"].float()
        if not bool(torch.isfinite(disp).all()) or float(disp.min()) < 0:
            raise AssertionError(f"eval forward {name}: disp outside [0, inf)")
        out[name] = (ms, peak, idle, disp)
        del model
        free_cache()
    diff = float(((out["bf16"][3] - out["f32"][3]).abs().mean() / out["f32"][3].abs().mean()))
    print(f"[bf16] eval forward ResNet-{cfg.num_layers} DenseASPP at 1280x384, 8 "
          f"images: bf16 {out['bf16'][0]:.2f} ms, peak {out['bf16'][1]:.2f} GB, idle "
          f"{out['bf16'][2]:.4f}; float32 {out['f32'][0]:.2f} ms, peak {out['f32'][1]:.2f} GB, "
          f"idle {out['f32'][2]:.4f} (CUDA events, median of 10; TF32 off); mean |disp "
          f"bf16 - float32| / mean |disp| {diff:.3e}"
          + (f"; the slice phase's float32 forward {f32_ms:.2f} ms" if f32_ms else "")
          + f" | {card}")


# ---------------------------------------------------------------------------
# serving export (cli/export.py) and the API-parity networks
# ---------------------------------------------------------------------------

# the eval recipe's model (ResNet-50, DenseASPP, 49+14 planes, mixture,
# plane residual, PE 8) through the export CLI's flags
EXPORT_FLAGS = ["--height", "384", "--width", "1280", "--use_denseaspp", "--use_mixture_loss",
                "--plane_residual"]
EXPORT_F32_RTOL = 1e-6             # of max |disp|: the same kernels on the same weights
EXPORT_BF16_TOL = 4.4e-4           # of mean |disp|: bf16's eval gap from float32 (PERF.md §5)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))

# a fresh process with torch and the port's ops alone: load each program,
# run it on the card (TF32 off, as in this script), save disp and the
# kernels' launches a call
FRESH_LOAD = """
import json, sys
import numpy as np
import torch
import planedepth_tpu_torch.ops as ops
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
device, tmp, names = torch.device(sys.argv[1]), sys.argv[2], sys.argv[3:]
image = torch.from_numpy(np.load(f"{tmp}/image.npy")).to(device)
grid = torch.from_numpy(np.load(f"{tmp}/grid.npy")).to(device)
counts = {}
for name in names:
    forward = torch.export.load(f"{tmp}/{name}.pt2").module()
    b = int(name.rsplit("_", 1)[1])
    before = (ops.disp_head.disp_head.launches, ops.head_epilogue.head_epilogue.fwd_launches)
    with torch.no_grad():
        disp = forward(image[:b], grid[:b])
    torch.cuda.synchronize() if device.type == "cuda" else None
    after = (ops.disp_head.disp_head.launches, ops.head_epilogue.head_epilogue.fwd_launches)
    counts[name] = [a - c for a, c in zip(after, before)]
    np.save(f"{tmp}/{name}_fresh.npy", disp.cpu().numpy())
models = [m for m in sys.modules if m.startswith("planedepth_tpu_torch.models")]
assert not models and "jax" not in sys.modules, models
print(json.dumps(counts))
"""


# the CLI's batch-1 export of one arithmetic, in a process of its own beside
# this one's batch-8 exports (torch.export's tracing is host-bound): seconds
# and bytes
CLI_EXPORT = """
import json, sys, time
from planedepth_tpu_torch.cli import export
t0 = time.perf_counter()
n = export.main(sys.argv[1:])
print(json.dumps([time.perf_counter() - t0, n]))
"""


def hold_export(got, want, bf16, what):
    """``got`` against ``want`` at the export's tolerance; returns the
    measure held (max |d| / max |disp| in float32, mean |d| / mean |disp|
    in bf16) and whether the two are bit-equal."""
    d = (got.float() - want.float()).abs()
    err = (float(d.mean() / want.float().abs().mean()) if bf16
           else float(d.max() / want.float().abs().max()))
    if err > (EXPORT_BF16_TOL if bf16 else EXPORT_F32_RTOL) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {err:.3e} apart")
    return err, bool(torch.equal(got, want))


def forward_peak_gb(fn, dev):
    """Peak device memory one call of ``fn`` allocates above what is live
    before it (the weights, the inputs), in GB."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 1e9


def phase_export(card, dev=torch.device("cuda"), flags=EXPORT_FLAGS, batch=8):
    """The eval recipe's forward exported at 1280x384 in float32 and bf16:
    through ``cli.export.main`` at batch 1 (in a process of its own for each
    arithmetic, while this one runs the others) and ``export_forward`` at 8
    (the same seeded weights); each program loaded, held to the eager forward
    and counted (one disp head and one head epilogue a call); the CLI's
    float32 program and the bf16 batch one loaded and run again in a fresh
    process that imports torch and the port's ops alone; export seconds,
    bytes, ms a batch (CUDA events, median of 10) and peak memory above the
    weights, exported and eager."""
    free_cache()
    args, _ = parse_with_explicit(build_parser(), flags)
    H, W = args.height, args.width
    images = make_stereo_batch(batch, H, W, seed=0)
    image = torch.from_numpy(images["color_l"]).to(dev)
    grid = torch.from_numpy(images["grid"]).to(dev)
    want_calls = only(disp_head_fwd=1, head_epilogue_fwd=1)
    rows = {}
    arithmetics = (("f32", False), ("bf16", True))
    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/image.npy", images["color_l"])
        np.save(f"{tmp}/grid.npy", images["grid"])
        dtype_flags = {name: list(flags) + ([] if bf16 else ["--no_bf16"])
                       for name, bf16 in arithmetics}
        # cli.export.main at batch 1 in a process of each arithmetic, while
        # this one exports batch 8 of both
        cli = {name: subprocess.Popen(
            [sys.executable, "-c", CLI_EXPORT, *dtype_flags[name], "--out",
             f"{tmp}/{name}_1.pt2", "--export_batch", "1"],
            env=dict(os.environ, PYTHONPATH=REPO_DIR), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for name, _ in arithmetics}
        try:
            models, exported = {}, {}
            for name, bf16 in arithmetics:
                args, explicit = parse_with_explicit(build_parser(), dtype_flags[name])
                if args.no_bf16 == bf16:
                    raise AssertionError(f"export {name}: --no_bf16 is {args.no_bf16}")
                cfg, model = cli_evaluate.eval_model(args_to_config(args), explicit)
                model = init_weights_(model, torch.Generator().manual_seed(cfg.seed)).to(dev)
                t0 = time.perf_counter()
                bytes_8 = cli_export.export_forward(cfg, model, f"{tmp}/{name}_{batch}.pt2",
                                                    batch)
                exported[name] = (time.perf_counter() - t0, bytes_8)
                models[name] = model
            for name, proc in cli.items():
                out, err = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"cli.export.main {name} failed:\n{err[-4000:]}")
                exported[name] += tuple(json.loads(out.strip().splitlines()[-1]))
        finally:
            for proc in cli.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(10)
        for name, bf16 in arithmetics:
            export_s, bytes_8, cli_s, bytes_1 = exported[name]
            model = models.pop(name)
            programs = {b: torch.export.load(f"{tmp}/{name}_{b}.pt2").module()
                        for b in (1, batch)}
            eager = cli_export.EvalForward(model)
            held = {}
            with torch.no_grad():
                for b, program in programs.items():
                    reset_launch_counts()
                    got = program(image[:b], grid[:b])
                    torch.cuda.synchronize(dev)
                    if launch_counts() != want_calls:
                        raise AssertionError(f"exported {name} batch {b}: launches "
                                             f"{nonzero(launch_counts())}")
                    want = eager(image[:b], grid[:b])
                    if got.shape != (b, H, W, 1):
                        raise AssertionError(f"exported {name}: disp {tuple(got.shape)}")
                    held[b] = hold_export(got, want, bf16, f"exported {name} batch {b} vs eager")
                    np.save(f"{tmp}/{name}_{b}_inproc.npy", got.cpu().numpy())
                ms = cuda_ms(lambda: programs[batch](image, grid))
                eager_ms = cuda_ms(lambda: eager(image, grid))
                peak = forward_peak_gb(lambda: programs[batch](image, grid), dev)
                eager_peak = forward_peak_gb(lambda: eager(image, grid), dev)
            rows[name] = ms
            print(f"[export] {name}: cli.export.main batch 1 {cli_s:.1f} s in a process of "
                  f"its own ({bytes_1} bytes), export_forward batch {batch} {export_s:.1f} s "
                  f"({bytes_8} bytes) in this one, at the same time; exported vs eager "
                  + ", ".join(f"batch {b}: {e:.3e} ({'mean' if bf16 else 'max'} |d| / |disp|, "
                              f"bit-equal {eq})" for b, (e, eq) in held.items())
                  + f"; launches a call {nonzero(want_calls)}; forward at batch {batch}, "
                  f"{H}x{W}: exported {ms:.2f} ms, eager {eager_ms:.2f} ms (CUDA events, "
                  f"median of 10); peak above the weights exported {peak:.3f} GB, eager "
                  f"{eager_peak:.3f} GB | {card}")
            del model, programs, eager
            free_cache()
        # the CLI's float32 program and export_forward's bf16 one
        names = ["f32_1", f"bf16_{batch}"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", FRESH_LOAD, str(dev), tmp, *names],
                              env=dict(os.environ, PYTHONPATH=REPO_DIR), capture_output=True,
                              text=True, timeout=600)
        fresh_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"fresh process failed:\n{proc.stderr[-4000:]}")
        counts = json.loads(proc.stdout.strip().splitlines()[-1])
        fresh_equal = {}
        for n in names:
            if counts[n] != [1, 1]:
                raise AssertionError(f"fresh process, {n}: launches {counts[n]}, want [1, 1]")
            got = torch.from_numpy(np.load(f"{tmp}/{n}_fresh.npy"))
            inproc = torch.from_numpy(np.load(f"{tmp}/{n}_inproc.npy"))
            fresh_equal[n] = hold_export(got, inproc, n.startswith("bf16"),
                                         f"fresh process {n} vs this process")[1]
    print(f"[export] fresh python3 (torch + planedepth_tpu_torch.ops only) loaded and ran "
          f"{names} on the card in {fresh_s:.1f} s: launches a call {counts}, bit-equal to "
          f"this process's programs {fresh_equal}")
    return rows


A11_SIZE = (8, 192, 640)           # batch, height, width: the stage-1 training size
A11_SMALL = (2, 64, 192)
A11_LEVELS = PlaneConfig(disp_levels=49, xz_levels=0, yz_levels=0)


def a11_features(num_layers, size, dtype, dev, seed):
    """A seeded ResNet's pyramid of a seeded image batch (no grad)."""
    b, h, w = size
    encoder = init_weights_(ResnetEncoder(num_layers, dtype=dtype),
                            torch.Generator().manual_seed(seed)).to(dev).eval()
    image = torch.rand((b, 3, h, w), generator=torch.Generator().manual_seed(seed)).to(dev)
    with torch.no_grad():
        return [f.detach() for f in encoder(image)]


def a11_nets():
    """``name -> (build(dtype), inputs(size, dtype, dev), loss(out), outputs(out),
    train_kw)`` of each API-parity network, on the inputs its docstring
    names; ``train_kw`` are the keyword arguments of a training forward."""
    def grid(size, dev, seed):
        b, h, w = size
        g = torch.Generator().manual_seed(seed)
        return (torch.rand((b, 2, h, w), generator=g) * 2 - 1).to(dev)

    def pair(size, dtype, dev):
        b, h, w = size
        g = torch.Generator().manual_seed(3)
        x, y = (torch.rand((b, 3, h, w), generator=g).to(dev) for _ in range(2))
        return (x, y, grid(size, dev, 4))

    pose_out = lambda out: {"axisangle": out[0], "translation": out[1]}      # noqa: E731
    return {
        "PladePoseNet": (lambda dt: PladePoseNet(batch_norm=True, num_ep=8, dtype=dt), pair,
                         lambda out: 100.0 * (out[0].sum() + out[1].sum()), pose_out, {}),
        "Monov2Decoder": (lambda dt: Monov2Decoder(encoder_channels(18), dtype=dt),
                          lambda size, dt, dev: (a11_features(18, size, dt, dev, 5),),
                          lambda out: sum(v.mean() for v in out.values()),
                          lambda out: {str(k): v for k, v in out.items()}, {}),
        "DepthDecoderContinuous": (
            lambda dt: DepthDecoderContinuous(encoder_channels(50), planes=A11_LEVELS,
                                              dtype=dt),
            lambda size, dt, dev: (a11_features(50, size, dt, dev, 6), grid(size, dev, 7)),
            lambda out: out["disp"].mean(),
            lambda out: {k: out[k] for k in ("disp_layered", "sigma", "probability", "disp")},
            {"generator": torch.Generator().manual_seed(8)}),           # DenseASPP's dropout
    }


def a11_against_cpu(build, inputs, outputs, bf16, dev):
    """The card's eval forward of one API-parity net against the same
    weights on the CPU at ``A11_SMALL``: float32 at ``MODEL_TOL`` of each
    output's largest magnitude; bf16 as ``check_against_cpu_bf16`` holds
    the depth model (no further from the CPU's bf16 forward than that
    stands from float32's: 2x on average, 2.5x at the 99.9th percentile,
    3x at the largest).  Returns the largest error over the outputs."""
    f32 = init_weights_(build(None), torch.Generator().manual_seed(0)).eval()
    dt = torch.bfloat16 if bf16 else None
    cpu = build(dt).eval()
    cpu.load_state_dict(f32.state_dict())
    card = copy.deepcopy(cpu).to(dev)
    args = inputs(A11_SMALL, dt, torch.device("cpu"))
    with torch.no_grad():
        want = outputs(cpu(*args))
        got = outputs(card(*[[a.to(dev) for a in x] if isinstance(x, list) else x.to(dev)
                             for x in args]))
        ref = outputs(f32(*[[a.float() for a in x] if isinstance(x, list) else x.float()
                            for x in args])) if bf16 else None
    worst = 0.0
    for key, w in want.items():
        g, w = got[key].cpu().float(), w.float()
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        if not bf16:
            torch.testing.assert_close(g, w, rtol=MODEL_TOL["rtol"],
                                       atol=MODEL_TOL["atol"] * float(w.abs().max()), msg=key)
            continue
        e_bf16 = (w - ref[key].float()).abs()
        if not (float(err.mean()) <= 2.0 * float(e_bf16.mean()) + 1e-6
                and quantile(err, 0.999) <= 2.5 * quantile(e_bf16, 0.999) + 1e-6
                and float(err.max()) <= 3.0 * float(e_bf16.max()) + 1e-6):
            raise AssertionError(f"{key}: card from CPU bf16 {float(err.mean()):.3e} mean, "
                                 f"CPU bf16 from float32 {float(e_bf16.mean()):.3e}")
    return worst


def phase_a11(card, dev=torch.device("cuda")):
    """``PladePoseNet`` (BatchNorm, PE 8) on image pairs, ``Monov2Decoder`` on
    ResNet-18 features and ``DepthDecoderContinuous`` (49 levels, mixture,
    DenseASPP, PE 8) on ResNet-50 features, at 640x192, batch 8, in float32
    and bf16: a training-mode forward and backward with finite outputs and
    gradients for every parameter, the card's eval forward held to the CPU's
    on a small input, and ms (CUDA events, median of 10) of the eval forward
    and of a training forward + backward.  No kernel of the port runs."""
    free_cache()
    for name, (build, inputs, loss, outputs, train_kw) in a11_nets().items():
        for bf16 in (False, True):
            dt = torch.bfloat16 if bf16 else None
            net = init_weights_(build(dt), torch.Generator().manual_seed(0)).to(dev)
            args = inputs(A11_SIZE, dt, dev)
            reset_launch_counts()
            net.train()
            out = net(*args, **train_kw)
            loss(out).backward()
            torch.cuda.synchronize(dev)
            if nonzero(launch_counts()):
                raise AssertionError(f"{name}: launches {nonzero(launch_counts())}")
            bad = [k for k, v in outputs(out).items() if not bool(torch.isfinite(v).all())]
            bad += [k for k, p in net.named_parameters()
                    if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            if bad:
                raise AssertionError(f"{name} {'bf16' if bf16 else 'f32'}: not finite {bad}")

            def step():
                net.zero_grad(set_to_none=True)
                loss(net(*args, **train_kw)).backward()

            train_ms = cuda_ms(step)
            net.eval()
            with torch.no_grad():
                eval_ms = cuda_ms(lambda: net(*args))
            err = a11_against_cpu(build, inputs, outputs, bf16, dev)
            print(f"[a11] {name} {'bf16' if bf16 else 'f32'} at {A11_SIZE}: train forward + "
                  f"backward {train_ms:.2f} ms, eval forward {eval_ms:.2f} ms (CUDA events, "
                  f"median of 10); outputs and gradients finite; card vs CPU at {A11_SMALL} "
                  f"max_abs_err {err:.3e} | {card}")
            del net, out, args
            free_cache()


# ---------------------------------------------------------------------------
# data parallelism (parallel/mesh.py): two ranks on the one card, and one
# NCCL rank through the train CLI under the launcher's environment
# ---------------------------------------------------------------------------

DDP_STEPS = 3
DDP_RANKS = 2
ADAM_FLOOR = 1e-7                     # 10 x Adam's eps (train/state.py)
DDP_STEP_F32 = only(plane_sweep_fwd=1, plane_sweep_bwd=1, head_epilogue_fwd=1,
                    head_epilogue_bwd=1)
DDP_STEP = bf16_step(DDP_STEP_F32)
DDP_TRAIN = [f"{KITTI_DRIVE} {i} l" for i in range(10200, 10208)]
DDP_VAL = [f"{KITTI_DRIVE} {i} l" for i in range(10300, 10304)]


def ddp_steps(dev, rank, size, profile=False, bf16=True):
    """``DDP_STEPS`` stage-1 steps (seeded weights, the global batch
    ``make_stereo_batch(4, 192, 640)``) on this rank's rows of the batch,
    each synchronised: the losses, the depth model's parameters after the
    first step and its final state on the host, the first step's gradients
    (rank 0), the launch counts and, under ``profile``, the sweep kernels the
    profiler saw launched."""
    cfg = stage1_config(allow_random_pc=True, bf16=bf16)
    bundle = ModelBundle(cfg, dev)
    optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 1000)
    step = make_train_step(bundle, optimizer, scheduler)
    full = make_stereo_batch(cfg.per_step_batch, cfg.data.height, cfg.data.width, seed=0)
    b = cfg.per_step_batch // size
    batch = batch_to_tensors({k: v[rank * b:(rank + 1) * b] for k, v in full.items()}, dev)
    # the card's activity alone: the kernels are all that is counted, and a
    # trace of the host's ops as well takes seconds to read back
    activities = [torch.profiler.ProfilerActivity.CUDA]
    losses, first, grads = [], {}, {}
    reset_launch_counts()
    with torch.profiler.profile(activities=activities) if profile else contextlib.nullcontext() \
            as prof:
        for t in range(DDP_STEPS):
            out = step(batch)
            torch.cuda.synchronize(dev)
            losses.append(host_losses(out))
            if t == 0:
                first = {k: p.detach().cpu() for k, p in bundle.model.named_parameters()}
                if rank == 0:
                    grads = {k: p.grad.detach().cpu() for k, p in
                             bundle.model.named_parameters() if p.grad is not None}
    kernels = {}
    if profile:
        for e in prof.key_averages():
            for name in ("sweep_fwd_kernel", "sweep_bwd_kernel"):
                if name in e.key:
                    kernels[name] = kernels.get(name, 0) + e.count
    return {"losses": losses, "first": first, "grads": grads, "launches": launch_counts(),
            "kernels": kernels, "lr": cfg.optim.learning_rate,
            "state": {k: v.detach().cpu() for k, v in bundle.model.state_dict().items()}}


def ddp_rank(rank, size, tmp):
    """Rank ``rank`` of ``size`` on the one card: the launcher's
    environment, the group (gloo: the ranks share the card), the steps in
    bf16 and then in float32."""
    from planedepth_tpu_torch.parallel.mesh import init_distributed
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size))
    torch.backends.cudnn.allow_tf32 = False           # as phase_device sets this process
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    init_distributed(dev, init_method=f"file://{tmp}/pg")
    try:
        for bf16 in (True, False):
            torch.save(ddp_steps(dev, rank, size, profile=rank == 0, bf16=bf16),
                       os.path.join(tmp, f"rank{rank}_{'bf16' if bf16 else 'float32'}.pt"))
    finally:
        dist.destroy_process_group()


def run_ddp_ranks(dev):
    """``DDP_RANKS`` gloo ranks of ``ddp_steps`` on the card, in bf16 and in
    float32, and, while they run, one process on the global batch in each;
    returns, by arithmetic, rank 0's, rank 1's and the one process's run."""
    import torch.multiprocessing as mp

    tags = {True: "bf16", False: "float32"}
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_ddp_") as tmp:
        ranks = mp.spawn(ddp_rank, args=(DDP_RANKS, tmp), nprocs=DDP_RANKS, join=False)
        try:
            one = {tag: ddp_steps(dev, 0, 1, bf16=bf16) for bf16, tag in tags.items()}
            deadline = time.monotonic() + 600
            while not ranks.join(timeout=10):
                if time.monotonic() > deadline:
                    raise TimeoutError("the ddp ranks are still running after 600 s")
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        return {tag: tuple(torch.load(os.path.join(tmp, f"rank{r}_{tag}.pt"), weights_only=False)
                           for r in range(DDP_RANKS)) + (one[tag],)
                for tag in tags.values()}


def loss_rel_diffs(a, b):
    """Each step's largest relative difference of ``a``'s losses from ``b``'s."""
    return [max(abs(x[k] / v - 1) for k, v in y.items() if v) for x, y in
            zip(a["losses"], b["losses"])]


def first_step_c4(r0, one):
    """The C4 rule of ``check_step_against_cpu`` on the first step, the
    ranks' (averaged) gradients and post-Adam weights against one
    process's: each leaf's gradient within 0.1 relative L2 (float32 rounding
    through train-mode BatchNorm leaves ResNet-50's encoder gradients ~2% off
    float64 in either run); the weights at STEP_PARAM_ATOL where the step's
    direction is fixed, within one Adam step each way elsewhere.  Adam's
    first update is lr g / (|g| + eps): where both gradients share a sign and
    pass ADAM_FLOOR the two updates agree within 10% of lr, under it they may
    part by up to lr.  Many of ResNet-50's gradients at its seeded init lie
    under it, so a third of the weights must be held at the atol, as
    tests/_torch_parity.py holds the CPU step to JAX's."""
    worst, grad_rel, checked, total = 0.0, 0.0, 0, 0
    for k, g1 in one["grads"].items():
        g2 = r0["grads"][k]
        if g1.abs().max().item() > 1e-6:    # else mathematically zero (bias under BN)
            rel = ((g2 - g1).norm() / g1.norm()).item()
            grad_rel = max(grad_rel, rel)
            if rel > 0.1:
                raise AssertionError(f"ddp first step {k}: gradient off by {rel:.3e} (L2)")
        err = (r0["first"][k].double() - one["first"][k].double()).abs()
        fixed = g1.abs() > (g1 - g2).abs() + ADAM_FLOOR
        fixed_err = err[fixed].max().item() if bool(fixed.any()) else 0.0
        if fixed_err > STEP_PARAM_ATOL or err.max().item() > 2 * one["lr"] + STEP_PARAM_ATOL:
            raise AssertionError(f"ddp first step {k}: parameters differ by "
                                 f"{err.max().item():.3e}")
        worst = max(worst, fixed_err)
        checked += int(fixed.sum())
        total += err.numel()
    if checked < total // 3:
        raise AssertionError(f"ddp: only {checked} of {total} weights have a fixed direction")
    return {"grad_l2_rel": grad_rel, "param_err": worst,
            "share_of_weights_held_at_atol": checked / total}


def ddp_ranks_vs_one(dev):
    """Phase (a): two gloo ranks on the card against one process on the
    global batch, in bf16 (the default) and in float32 (TF32 off).  Held in
    both: the first step's losses, from equal weights, at rtol 2e-4; over
    the ``DDP_STEPS`` steps, the ranks' states (parameters and BatchNorm
    statistics) bit-equal, every loss finite and summing to its total, each
    step's launches, and rank 0's sweep kernels as torch.profiler saw them.
    In float32 also the first step's gradients and post-Adam weights
    (:func:`first_step_c4`): in bf16 the encoder's BatchNorm gradients are
    rounding in either run (scripts/ddp_spread.py).  Later steps' losses
    part from one process's by rounding that Adam's first steps amplify
    (each weight moves by ~lr sign(g)): printed."""
    n = DDP_STEPS
    out, runs = {}, run_ddp_ranks(dev)
    for bf16, per_step in ((True, DDP_STEP), (False, DDP_STEP_F32)):
        tag = "bf16" if bf16 else "float32"
        r0, r1, one = runs.pop(tag)
        want = {k: v * n for k, v in per_step.items()}
        for name, run in (("one process", one), ("rank 0", r0), ("rank 1", r1)):
            if run["launches"] != want:
                raise AssertionError(f"ddp {tag} {name}: launches {run['launches']}, "
                                     f"want {want}")
            check_losses(run["losses"], stage1_config(bf16=bf16))
        if r0["kernels"] != {"sweep_fwd_kernel": n, "sweep_bwd_kernel": n}:
            raise AssertionError(f"ddp {tag} rank 0: the profiler saw sweep kernels "
                                 f"{r0['kernels']}")
        if r0["losses"] != r1["losses"]:
            raise AssertionError(f"ddp {tag}: the ranks' losses differ")
        for k in one["state"]:
            if not torch.equal(r0["state"][k], r1["state"][k]):
                raise AssertionError(f"ddp {tag}: the ranks' {k} differ after {n} steps")
        for k, v in one["losses"][0].items():
            if not math.isclose(r0["losses"][0][k], v, rel_tol=2e-4, abs_tol=1e-7):
                raise AssertionError(f"ddp {tag} first step {k}: ranks {r0['losses'][0][k]} "
                                     f"vs {v}")
        out[tag] = {"loss_rel_diff_by_step": loss_rel_diffs(r0, one),
                    "bn_stats_vs_one_after": max(
                        (r0["state"][k].double() - v.double()).abs().max().item()
                        for k, v in one["state"].items() if "running" in k),
                    "launches": nonzero(r0["launches"]), "kernels": r0["kernels"],
                    "one_total_loss": [s["loss/total_loss"] for s in one["losses"]]}
        if not bf16:
            out[tag]["first_step_c4"] = first_step_c4(r0, one)
        del r0, r1, one
        free_cache()
    return out


def free_port():
    """A free TCP port on localhost for the process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ddp_cli(card):
    """Phase (b): one NCCL rank through ``cli.train.main`` under the
    launcher's environment: stage 1 on a small KITTI-shaped tree, 2 steps
    and validation, the group joined and left by the CLI."""
    import torch.distributed as dist
    from planedepth_tpu_torch.parallel.mesh import choose_backend

    if choose_backend(torch.device("cuda", 0), 1) != "nccl":
        raise AssertionError("one rank on its own card must take NCCL")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_ddp_cli_") as tmp:
        root, split, log_dir = (os.path.join(tmp, d) for d in ("kitti", "split", "log"))
        write_tree(root, DDP_VAL, scan_points=KITTI_SCAN_POINTS)
        write_tree(root, DDP_TRAIN)
        os.makedirs(split)
        for name, lines in (("train", DDP_TRAIN), ("val", DDP_VAL)):
            with open(os.path.join(split, f"{name}_files.txt"), "w") as f:
                f.write("".join(f"{ln}\n" for ln in lines))
        argv = ["--stage", "stage1", "--data_path", root, "--split", split, "--png",
                "--allow_random_pc", "--num_epochs", "1", "--log_dir", log_dir,
                "--model_name", "ddp"]
        saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            trainer = cli_train.main(argv)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        run_s = time.perf_counter() - t0
        launches = launch_counts()
        saved = sorted(os.listdir(os.path.join(log_dir, "ddp_ResNet", "last_models")))
        best = os.path.isdir(os.path.join(log_dir, "ddp_ResNet", "best_models"))
    steps = len(DDP_TRAIN) // trainer.cfg.per_step_batch
    n_val = -(-len(DDP_VAL) // trainer.cfg.per_step_batch)
    want = with_panels(only(plane_sweep_bf16_fwd=steps, plane_sweep_bf16_bwd=steps,
                            head_epilogue_fwd=steps + n_val, head_epilogue_bwd=steps,
                            disp_head_fwd=n_val),
                       {"disp_head_fwd": 1, "head_epilogue_fwd": 1})
    if (launches != want or trainer.step_count != steps or trainer.world != 1
            or not trainer.bundle.ddp or dist.is_initialized()
            or saved != ["adam.pth", "depth.pth", "encoder.pth"] or not best):
        raise AssertionError(f"ddp CLI: launches {launches} (want {want}), steps "
                             f"{trainer.step_count}, world {trainer.world}, wrapped "
                             f"{sorted(trainer.bundle.ddp)}, group left "
                             f"{not dist.is_initialized()}, saved {saved}, best_models {best}")
    del trainer
    free_cache()
    return {"launches": launches, "steps": steps, "n_val": n_val, "seconds": run_s,
            "saved": saved}


def phase_ddp(card, dev=torch.device("cuda")):
    """Data parallelism: (a) two gloo ranks on the one card held to one
    process on the global batch, in bf16 and float32, rank 0's sweep kernels
    counted under torch.profiler; (b) one NCCL rank through the train CLI."""
    free_cache()
    t0 = time.perf_counter()
    a = ddp_ranks_vs_one(dev)
    a_s = time.perf_counter() - t0
    b = ddp_cli(card)
    for tag, run in a.items():
        print(f"[ddp] (a) {DDP_RANKS} gloo ranks on one card (the launcher's environment, "
              f"file rendezvous), stage1_config {tag} (ResNet-50, DenseASPP, 49+14 planes, "
              f"VGG19, 640x192), global batch 4 flipped to 8, {DDP_STEPS} steps under DDP "
              f"with global BatchNorm moments, against one process on the global batch: "
              f"{json.dumps(run)}; both ranks' states bit-equal after the steps ({a_s:.1f} s "
              f"for both arithmetics) | {card}")
    print(f"[ddp] (b) one NCCL rank through cli.train.main --stage stage1 --png under "
          f"RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/MASTER_PORT: {b['steps']} steps and "
          f"{b['n_val']} validation batch in {b['seconds']:.1f} s, launches "
          f"{nonzero(b['launches'])}, saved {b['saved']} and best_models; the group left "
          f"after | {card}")


# ---------------------------------------------------------------------------
# image rows over ranks (parallel/halo.py): a (1, 2) mesh of two gloo ranks
# on the one card against one process on the global batch
# ---------------------------------------------------------------------------

SPATIAL_RANKS = 2
# ResNet render on vertical planes alone (C9: over ground planes the float32
# compositing is ill-posed, so the ranks' sums and one process's part)
RENDER_VERTICAL = dataclasses.replace(RENDER_MODEL, planes=PlaneConfig(xz_levels=0))
# each spatial run: its config and one step's launches, on each rank as in
# one process (a rank launches each kernel on its rows, the 2-D warp on the
# gathered whole image); the first three since PR 18, the rest every other
# recipe at full width
SPATIAL_RUNS = {
    "bf16": (lambda: hr_finetune_config(bf16=True), DDP_STEP),
    "float32": (hr_finetune_config, DDP_STEP_F32),
    "stage3": (lambda: self_distillation_config(bf16=True), bf16_step(DISTILL_STEP)),
    "mono_bf16": (lambda: mono_config(bf16=True), bf16_step(MONO_STEP)),
    "mono_float32": (mono_config, MONO_STEP),
    "mixed": (lambda: mono_config(warp_type="disp_warp", bf16=True), bf16_step(MIXED_STEP)),
    "self": (lambda: stage1_config(loss=SELF_LOSS, bf16=True), bf16_step(STAGE1_STEP)),
    "oracle": (lambda: stage1_config(fused_sweep=False), ORACLE_STEP),
    "render": (lambda: stage1_config(model=RENDER_VERTICAL, bf16=True),
               bf16_step(RESCUE_STEP)),
    "yz": (lambda: stage1_config(model=YZ_MODEL, bf16=True), bf16_step(RESCUE_STEP)),
    "falnet": (lambda: hr_finetune_config(model=FALNET_MODEL, batch_size=4, bf16=True),
               bf16_step(FALNET_STEP)),
    "pladenet": (lambda: hr_finetune_config(model=PLADENET_MODEL, batch_size=4, bf16=True),
                 bf16_step(PLADENET_STEP)),
}
# the runs that also hold the ranks' gradients and weights to one process's
SPATIAL_C4 = ("float32", "mono_float32")
# the bf16 runs of the recipes added to the phase after PR 18, whose loss
# terms are also held at 2e-4 of the step's total loss: two valid
# summation orders part a bf16 term by 1e-5 to 3e-5 at 640x192 in every
# recipe (the card's stem conv, the bilinear resize and BatchNorm's float32
# moments give a shard other bits than the whole image,
# scripts/shard_bits.py), which is more than 2e-4 of mono's and mixed's
# photometric term (0.056 and 0.015: a mean of per-pixel log-likelihoods of
# both signs).  Their float32 twins hold every term at 2e-4 of itself.
SPATIAL_TOTAL_SCALED = ("mono_bf16", "mixed", "self", "render", "yz", "falnet", "pladenet")
# rank 0's kernels by name as torch.profiler sees them on the card, in the
# runs it traces (substrings of the kernels' names)
SPATIAL_TRACED = {
    "bf16": {"sweep_fwd_kernel": 1, "sweep_bwd_kernel": 1},
    "float32": {"sweep_fwd_kernel": 1, "sweep_bwd_kernel": 1},
    "stage3": {"sweep_fwd_kernel": 1, "sweep_bwd_kernel": 1},
    "mono_bf16": {"warp2d_fwd": 3, "warp2d_bwd": 3, "disp_head_bwd_kernel": 1},
}
SPATIAL_RECIPES = {
    "bf16": "hr_finetune_config bf16 (ResNet-50, DenseASPP, 49+14 planes, VGG19, 8 x 1280x384)",
    "float32": "hr_finetune_config float32 (the same)",
    "stage3": "self_distillation_config bf16 (teacher + row shift, 4 x 1280x384)",
    "mono_bf16": "mono_config bf16 (ResNet-50, DenseASPP, 49+14 planes, pose ResNet-18, "
                 "homography to r, -1, 1 through the 2-D warp on gathered rows, automask, "
                 "VGG19, 8 x 640x192)",
    "mono_float32": "mono_config float32 (the same)",
    "mixed": "mono_config disp_warp bf16 (side r in the sweep on the rows, -1 and 1 "
             "through the gathered 2-D warp)",
    "self": "stage1_config + alpha_self 0.1 with SSIM, bf16 (the right image gathered)",
    "oracle": "stage1_config fused_sweep off, float32 (the oracle view synthesis)",
    "render": "stage1_config render_probability on 49 vertical planes (C9), bf16 (the "
              "disp_warp rescue through the gathered 2-D warp, plane_dists in global rows)",
    "yz": "stage1_config yz_levels 8 (N = 71), bf16 (the gathered 2-D warp)",
    "falnet": "FalNet 49 planes at 1280x384, batch 2 flipped to 4, bf16 (H % 64S)",
    "pladenet": "PladeNet 49+14 planes at 1280x384, batch 2 flipped to 4, bf16 (H % 64S, "
                "the residual head's image mean)",
}


def tensor_digest(t):
    """A digest of ``t``'s bytes: equal digests, equal tensors."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def traced_kernels(prof):
    """The counts of rank 0's traced kernels (:data:`SPATIAL_TRACED`'s names)
    in ``prof``, those it saw."""
    names = {name for want in SPATIAL_TRACED.values() for name in want}
    counts = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                counts[name] = counts.get(name, 0) + e.count
    return counts


def spatial_runs(dev, mesh_shape, profile=False, keep_float32=True, remat=None):
    """One step of each of :data:`SPATIAL_RUNS` (the three of PR 18: an
    hr_finetune step at 1280x384, the global batch 4 flipped to 8, in bf16
    and in float32, and a stage-3 step, batch 4 with the frozen teacher on
    8 images, bf16; then every other recipe at full width), each from
    seeded weights on the batch ``step_batch(cfg, 0)``, on this rank's rows
    of the images under ``mesh_shape`` or on the whole images with ``()``.
    Each run's losses, launch counts, parameters' digests after the step,
    peak device memory above what was allocated before it and, under
    ``profile``, the kernels the profiler saw in the runs of
    :data:`SPATIAL_TRACED`; under ``keep_float32`` the parameters and
    gradients of the runs of :data:`SPATIAL_C4` too.  A dict ``remat`` (the
    one process) takes the runs of :data:`REMAT_SWITCH` after their step
    (:func:`remat_first_steps`: the same first step with the switch on and
    off again, and the bundle kept for :func:`phase_remat`)."""
    runs = {}
    # the card's activity alone: the kernels are all that is counted, and a
    # trace of the host's ops as well takes seconds to read back
    activities = [torch.profiler.ProfilerActivity.CUDA]
    for tag, (preset, _) in SPATIAL_RUNS.items():
        cfg = preset().replace(allow_random_pc=True, mesh_shape=mesh_shape)
        traced = profile and tag in SPATIAL_TRACED
        t_build = time.perf_counter()
        free_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        bundle = ModelBundle(cfg, dev)
        if cfg.loss.self_distillation > 0:
            bundle.freeze_teacher()
        optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 1000)
        step = make_train_step(bundle, optimizer, scheduler)
        batch = batch_to_tensors(step_batch(cfg, 0), dev)
        kept = remat is not None and tag in REMAT_SWITCH
        init = bundle_state(bundle) if kept else None
        reset_launch_counts()
        t0 = time.perf_counter()
        build_s = t0 - t_build
        with torch.profiler.profile(activities=activities) if traced else \
                contextlib.nullcontext() as prof:
            losses = host_losses(step(batch))
            torch.cuda.synchronize(dev)
        run = {"losses": [losses], "launches": launch_counts(), "lr": cfg.optim.learning_rate,
               "seconds": time.perf_counter() - t0, "build_s": build_s,
               "peak_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9,
               "rows": batch["color_l"].shape[-2],
               "digests": {k: tensor_digest(p) for k, p in bundle.model.named_parameters()}}
        if tag in SPATIAL_C4 and keep_float32:
            run["first"] = {k: p.detach().cpu() for k, p in bundle.model.named_parameters()}
            run["grads"] = {k: p.grad.detach().cpu() for k, p in
                            bundle.model.named_parameters() if p.grad is not None}
        if traced:
            run["kernels"] = traced_kernels(prof)
        run["after_s"] = time.perf_counter() - t0 - run["seconds"]
        runs[tag] = run
        if kept:
            remat[tag] = remat_first_steps(bundle, batch, init, REMAT_SWITCH[tag],
                                           first_step_record(bundle, losses, run["launches"]))
            remat[tag]["base"] = base
        del bundle, optimizer, scheduler, step, batch
    free_cache()
    return runs


def spatial_rank(rank, size, tmp):
    """Rank ``rank`` of a (1, ``size``) mesh on the one card: the
    launcher's environment, the group (gloo: the ranks share the card),
    :func:`spatial_runs` on its rows."""
    from planedepth_tpu_torch.parallel.mesh import init_distributed
    import torch.distributed as dist

    started = time.time()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size))
    torch.backends.cudnn.allow_tf32 = False           # as phase_device sets this process
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    init_distributed(dev, init_method=f"file://{tmp}/pg")
    try:
        joined = time.time()
        runs = spatial_runs(dev, (1, size), profile=rank == 0, keep_float32=rank == 0)
        runs["clock"] = {"started": started, "joined": joined, "ran": time.time()}
        torch.save(runs, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_spatial(card, dev=torch.device("cuda")):
    """Image rows over ranks: two gloo ranks on the one card, each with half
    of the rows, held to one process on the global batch (run while the
    ranks run), one step of each of :data:`SPATIAL_RUNS`.  Held in every
    run: the losses finite, at rtol 2e-4 of one process's (in the runs of
    :data:`SPATIAL_TOTAL_SCALED`, or within 2e-4 of the total loss) and
    equal on both ranks; the ranks' parameters after the step bit-equal; each process's
    launches those of one step (every kernel of the step launched) and the
    same in all three; each rank's peak memory below the one process's; in
    the runs of :data:`SPATIAL_TRACED` rank 0's kernels as torch.profiler
    saw them; in those of :data:`SPATIAL_C4` the gradients and post-Adam
    weights (:func:`first_step_c4`).  While the ranks run, the one process
    also takes the first steps of :func:`phase_remat` on its runs of
    :data:`REMAT_SWITCH` (the card's memory is each process's own; no time
    is taken then); returns them, with their bundles."""
    import torch.multiprocessing as mp

    free_cache()
    kept = {}
    t0, clock0 = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_spatial_") as tmp:
        ranks = mp.spawn(spatial_rank, args=(SPATIAL_RANKS, tmp), nprocs=SPATIAL_RANKS,
                         join=False)
        try:
            one = spatial_runs(dev, (), remat=kept)
            t_one = time.perf_counter() - t0
            deadline = time.monotonic() + 600
            while not ranks.join(timeout=10):
                if time.monotonic() > deadline:
                    raise TimeoutError("the spatial ranks are still running after 600 s")
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        t_ranks = time.perf_counter() - t0
        r0, r1 = (torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                  for r in range(SPATIAL_RANKS))
    t_loaded = time.perf_counter() - t0
    out, failed = {}, []
    for tag, want in one.items():
        a, b = r0[tag], r1[tag]
        preset, per_step = SPATIAL_RUNS[tag]
        cfg = preset()
        faults = []
        for name, run in (("one process", want), ("rank 0", a), ("rank 1", b)):
            try:
                check_losses(run["losses"], cfg)
            except AssertionError as e:
                faults.append(f"{name}: {e}")
            missing = [k for k in nonzero(per_step) if not run["launches"][k]]
            if missing:
                faults.append(f"{name}: {missing} launched no time")
            if run["launches"] != want["launches"]:
                faults.append(f"{name}: launches {nonzero(run['launches'])}, one process "
                              f"{nonzero(want['launches'])}")
        if a["rows"] * SPATIAL_RANKS != want["rows"] or a["rows"] != b["rows"]:
            faults.append(f"rows {a['rows']}, {b['rows']} of {want['rows']}")
        if tag in SPATIAL_TRACED and a["kernels"] != SPATIAL_TRACED[tag]:
            faults.append(f"rank 0: the profiler saw kernels {a['kernels']}, want "
                          f"{SPATIAL_TRACED[tag]}")
        if a["losses"] != b["losses"]:
            faults.append("the ranks' losses differ")
        if a["digests"] != b["digests"] or set(a["digests"]) != set(want["digests"]):
            faults.append("the ranks' parameters differ after the step")
        total = want["losses"][0]["loss/total_loss"]
        abs_tol = 2e-4 * abs(total) if tag in SPATIAL_TOTAL_SCALED else 1e-7
        for k, v in want["losses"][0].items():
            if not math.isclose(a["losses"][0][k], v, rel_tol=2e-4, abs_tol=abs_tol):
                faults.append(f"{k}: ranks {a['losses'][0][k]} vs {v}")
        if max(a["peak_gb"], b["peak_gb"]) >= want["peak_gb"]:
            faults.append(f"peaks {a['peak_gb']:.3f}, {b['peak_gb']:.3f} GB, one process "
                          f"{want['peak_gb']:.3f} GB")
        out[tag] = {"loss_rel_diff": loss_rel_diffs(a, want)[0],
                    "losses": {k: [a["losses"][0][k], v] for k, v in want["losses"][0].items()},
                    "peak_gb": {"rank0": a["peak_gb"], "rank1": b["peak_gb"],
                                "one_process": want["peak_gb"]},
                    "step_s": {"rank0": a["seconds"], "one_process": want["seconds"]},
                    "build_s": {"rank0": a["build_s"], "one_process": want["build_s"]},
                    "after_step_s": {"rank0": a["after_s"], "one_process": want["after_s"]},
                    "rows": f"{a['rows']} of {want['rows']}",
                    "launches": nonzero(a["launches"]), "kernels": a.get("kernels")}
        if tag in SPATIAL_C4:
            try:
                out[tag]["first_step_c4"] = first_step_c4(a, want)
            except AssertionError as e:
                faults.append(str(e))
        if faults:
            out[tag]["failed"] = faults
            failed.append(tag)
    seconds = time.perf_counter() - t0
    timeline = {"rank0_started": r0["clock"]["started"] - clock0,
                "rank0_joined": r0["clock"]["joined"] - clock0,
                "rank0_ran": r0["clock"]["ran"] - clock0, "one_process_done": t_one,
                "ranks_done": t_ranks, "results_loaded": t_loaded, "checked": seconds}
    print(f"[spatial] phase timeline (s from its start): {json.dumps(timeline)}")
    for tag, run in out.items():
        print(f"[spatial] {tag}: {SPATIAL_RANKS} gloo ranks on one card, mesh_shape (1, "
              f"{SPATIAL_RANKS}), {SPATIAL_RECIPES[tag]}, one step against one process on "
              f"the global batch (losses: ranks, one process): {json.dumps(run)} "
              f"({seconds:.1f} s for the phase) | {card}")
    if failed:
        raise AssertionError(f"spatial: {failed} failed: "
                             + "; ".join(f"{t}: {out[t]['failed']}" for t in failed))
    return kept


# ---------------------------------------------------------------------------
# the rematerialisation switches (models/layers.py:remat): the depth encoder's
# residual blocks (model.remat) and the oracle's view synthesis and losses
# (remat_warp) recomputed in the backward pass, against the same step without
# ---------------------------------------------------------------------------

# the spatial runs (their one process) checked under each switch
REMAT_SWITCH = {"bf16": "remat", "float32": "remat", "oracle": "remat_warp"}
REMAT_WARMUP, REMAT_STEPS = 2, 5
# a gradient leaf that the step does not give bit for bit stays within this
# many times the largest difference between two steps without the switch in
# the same call (two draws of the card's nondeterministic backward), each
# leaf's difference over max(its largest element, 1e-3 x the largest
# gradient element), the scale of tests/_torch_parity.py:assert_grads_match;
# a fault of the recompute (other statistics, another mask) moves a leaf by
# orders more
REMAT_SPREAD = 4.0


def bundle_state(bundle):
    """Every trained network's state on the host."""
    return {name: {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
            for name, net in bundle.nets().items()}


def set_remat(bundle, field, on):
    """``field`` (``remat`` or ``remat_warp``) on or off in the built bundle:
    the depth encoder's trunk reads the first, the step the bundle's config."""
    cfg = bundle.cfg
    if field == "remat":
        bundle.model.encoder.encoder.remat = on
        bundle.cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=on))
    else:
        bundle.cfg = cfg.replace(remat_warp=on)


def first_step_record(bundle, losses, launches):
    """What a first step is held to: its losses and launches, the depth
    model's gradients and every network's buffers (the BatchNorm statistics
    and ``num_batches_tracked``) after it; the gradients are then released."""
    grads = {k: p.grad.detach().clone() for k, p in bundle.named_parameters()
             if p.grad is not None}
    buffers = {f"{n}.{k}": b.detach().clone() for n, net in bundle.nets().items()
               for k, b in net.named_buffers()}
    for p in bundle.parameters():
        p.grad = None
    return {"losses": losses, "launches": launches, "grads": grads, "buffers": buffers}


def remat_step(bundle, init, field, on):
    """A train step of ``bundle`` from the state ``init`` and a fresh Adam,
    with ``field`` ``on``."""
    set_remat(bundle, field, on)
    for name, net in bundle.nets().items():
        net.load_state_dict(init[name])
    optimizer, scheduler = make_optimizer(bundle.cfg, bundle.parameters(), 1000)
    return make_train_step(bundle, optimizer, scheduler)


def remat_first_steps(bundle, batch, init, field, off):
    """The first step ``off`` (the switch off) taken again with it on, then
    off once more, each from ``init``: the losses, every buffer and the
    launches of the step with it on must be the step's without it, bit for
    bit; each gradient leaf too, or (where the card's backward is not
    deterministic: the two steps without the switch part) within
    :data:`REMAT_SPREAD` times their largest relative difference.  The
    second step without it is the control, reported.  Returns the
    comparison, ``failed`` naming what broke, and the bundle, batch and
    state for the timed steps."""
    runs = {"off": off}
    for name, on in (("on", True), ("off_again", False)):
        step = remat_step(bundle, init, field, on)
        reset_launch_counts()
        losses = host_losses(step(batch))
        runs[name] = first_step_record(bundle, losses, launch_counts())
    set_remat(bundle, field, False)
    gmax = max(float(g.abs().max()) for g in off["grads"].values())
    rel, l2 = {}, {}
    for name in ("on", "off_again"):
        rel[name] = {k: float((runs[name]["grads"][k] - g).abs().max())
                     / max(float(g.abs().max()), 1e-3 * gmax, 1e-30)
                     for k, g in off["grads"].items()}
        l2[name] = math.sqrt(sum(float((runs[name]["grads"][k] - g).double().square().sum())
                                 for k, g in off["grads"].items())
                             / sum(float(g.double().square().sum())
                                   for g in off["grads"].values()))
    spread = max(rel["off_again"].values())
    same = {name: {"losses": runs[name]["losses"] == off["losses"],
                   "launches": runs[name]["launches"] == off["launches"],
                   "buffers": all(torch.equal(runs[name]["buffers"][k], b)
                                  for k, b in off["buffers"].items())}
            for name in ("on", "off_again")}
    failed = [f"on: {what} differ from the step without remat"
              for what, equal in same["on"].items() if not equal]
    if set(runs["on"]["grads"]) != set(off["grads"]):
        failed.append("on: other gradient leaves")
    wide = [k for k, r in rel["on"].items() if r > 0 and r > REMAT_SPREAD * spread]
    if wide:
        failed.append(f"on: gradient leaves {wide[:4]} ({len(wide)}) beyond {REMAT_SPREAD} x "
                      f"the spread {spread:.3e}: {[rel['on'][k] for k in wide[:4]]}")
    check = {"field": field, "bit_equal": same, "leaves": len(off["grads"]),
             "leaves_bit_equal": {n: sum(r == 0 for r in rel[n].values()) for n in rel},
             "largest_rel_grad_diff": {n: max(rel[n].values()) for n in rel},
             "rel_l2_grad_diff": l2,
             "buffers": len(off["buffers"]), "launches": nonzero(off["launches"])}
    return {"check": check, "failed": failed, "bundle": bundle, "batch": batch, "init": init}


def remat_times(kept, dev):
    """:data:`REMAT_WARMUP` warm-up and :data:`REMAT_STEPS` timed
    synchronised steps with the switch off, then on, each from the kept
    state: each one's median ms, the peak memory allocated in its timed
    steps (the allocator's statistic reset after the warm-ups) above what
    was allocated before the bundle, and one more step's memory by aten op
    (:func:`memory_by_op`)."""
    bundle, batch, field = kept["bundle"], kept["batch"], kept["check"]["field"]
    out = {}
    for name, on in (("off", False), ("on", True)):
        step = remat_step(bundle, kept["init"], field, on)
        for _ in range(REMAT_WARMUP):
            host_losses(step(batch))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for _ in range(REMAT_STEPS):
            t = time.perf_counter()
            host_losses(step(batch))
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t) * 1e3)
        peak = (torch.cuda.max_memory_allocated(dev) - kept["base"]) / 1e9
        out[name] = {"ms": statistics.median(ms), "ms_all": ms, "peak_gb": peak,
                     "by_op": memory_by_op(lambda: host_losses(step(batch)), dev)}
    set_remat(bundle, field, False)
    return out


def phase_remat(card, kept=None, dev=torch.device("cuda")):
    """The two rematerialisation switches on the spatial phase's one-process
    runs of :data:`REMAT_SWITCH` (hr_finetune_config in bf16 and float32
    under ``remat``, the oracle stage 1 in float32 under ``remat_warp``),
    from their seeded weights and batches: ``kept`` holds their first steps
    (:func:`remat_first_steps`) and bundles; alone (``python3 chip_smoke.py
    remat``) the phase builds them and takes those steps first.  Then each
    switch off and on timed (:func:`remat_times`).  Fails on any check of
    the first steps."""
    if kept is None:
        kept = {}
        for tag in REMAT_SWITCH:
            free_cache()
            base = torch.cuda.memory_allocated(dev)
            cfg = SPATIAL_RUNS[tag][0]().replace(allow_random_pc=True)
            bundle = ModelBundle(cfg, dev)
            batch = batch_to_tensors(step_batch(cfg, 0), dev)
            init = bundle_state(bundle)
            step = remat_step(bundle, init, REMAT_SWITCH[tag], False)
            reset_launch_counts()
            losses = host_losses(step(batch))
            kept[tag] = remat_first_steps(bundle, batch, init, REMAT_SWITCH[tag],
                                          first_step_record(bundle, losses, launch_counts()))
            kept[tag]["base"] = base
    failed = []
    for tag, run in kept.items():
        want = nonzero(SPATIAL_RUNS[tag][1])
        if run["check"]["launches"] != want:
            run["failed"].append(f"launches {run['check']['launches']}, want {want}")
        run["times"] = remat_times(run, dev)
        out = {"check": run["check"], "failed": run["failed"], **run["times"]}
        print(f"[remat] {tag}: {SPATIAL_RECIPES[tag]}, {run['check']['field']} on against off "
              f"from the same seeded weights and batch (first steps; then {REMAT_WARMUP} "
              f"warm-up and {REMAT_STEPS} timed steps each, the peak GB allocated in the "
              f"timed steps above what was before the bundle): {json.dumps(out)} | {card}")
        if run["failed"]:
            failed.append(tag)
        del run["bundle"], run["batch"], run["init"]
        free_cache()
    if failed:
        raise AssertionError(f"remat: {failed} failed: "
                             + "; ".join(f"{t}: {kept[t]['failed']}" for t in failed))


def main(argv=()):
    t_start = time.perf_counter()

    def run(phase, *args, **kwargs):
        """One phase, with its wall time."""
        t0 = time.perf_counter()
        out = phase(*args, **kwargs)
        print(f"[time] {phase.__name__}{'' if not kwargs else kwargs}: "
              f"{time.perf_counter() - t0:.1f} s")
        return out

    count_panels()
    card = run(phase_device)
    run(phase_build)
    if argv:
        # the named phases alone (those that take only the card), no JSON
        # lines; remat after spatial takes the spatial phase's runs
        kept = None
        for name in argv:
            out = run(globals()[f"phase_{name}"], card, *([kept] if name == "remat" else []))
            kept = out if name == "spatial" else kept
        return
    # launches: each kernel's count on the path that brought it to the port
    fields = {"disp_head_fwd": run(phase_kernel, card)}
    launches = {"disp_head_fwd": run(phase_slice, card)["disp_head_fwd"]}
    fields.update(run(phase_sweep, card))
    img_fields, launches["plane_sweep_img_bwd"] = run(phase_sweep_img, card)
    fields.update(img_fields)
    run(phase_sweep_wide, card)
    fields.update(run(phase_sweep_bf16, card))
    fields.update(run(phase_warp2d_bf16, card))
    train = run(phase_train, card)
    launches.update({k: train[k] for k in ("plane_sweep_fwd", "plane_sweep_bwd")})
    fields.update(run(phase_epilogue, card))
    fields.update(run(phase_shift, card))
    distill = run(phase_distill, card)
    launches.update({k: distill[k] for k in
                     ("row_shift_fwd", "head_epilogue_fwd", "head_epilogue_bwd")})
    run(phase_mom, card)
    fields.update(run(phase_warp2d, card))
    fields.update(run(phase_disp_head_bwd, card))
    mono = run(phase_mono, card)
    launches.update({k: mono[k] for k in ("disp_head_bwd", "warp2d_fwd", "warp2d_bwd")})
    fields.update(run(phase_sweep_nomix, card))
    fields.update(run(phase_warp2d, card, with_sigma=False))
    falnet = run(phase_falnet, card)
    launches.update({k: falnet[k] for k in ("plane_sweep_nomix_fwd", "plane_sweep_nomix_bwd")})
    run(phase_pladenet, card)
    nomix = run(phase_nomix, card)
    launches.update({k: nomix[k] for k in ("warp2d_nosigma_fwd", "warp2d_nosigma_bwd")})
    run(phase_kitti, card)
    stage1 = run(phase_stage1_trainer, card)
    run(phase_render, card, stage1)
    run(phase_yz, card, stage1)
    run(phase_self, card, stage1)
    run(phase_pladenet_render, card)
    run(phase_oracle, card)
    f32 = {k: F32_RUNS[v] for k, v in (("stage1", "stage1"), ("stage3", "self_distillation"),
                                         ("mono", "mono"), ("falnet", "falnet"),
                                         ("pladenet", "pladenet"), ("eval", "eval"))}
    launches.update(run(phase_bf16_recipes, card, {k: v for k, v in f32.items() if k != "eval"}
                        | {"eval": f32["eval"][0]}))
    run(phase_export, card)
    run(phase_a11, card)
    run(phase_ddp, card)
    run(phase_remat, card, run(phase_spatial, card))
    print(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **fields[name]}
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
