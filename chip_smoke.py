"""Drive the PyTorch/CUDA port's inference path, stage-1 step, stage-2 -> stage-3 trainer, mono trainer, FalNet and PladeNet trainers and no-mixture recipes on one NVIDIA GPU.

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
     kernel and twin times by CUDA events;
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
     the CPU at 64x128.
Each phase prints its wall time.  Then one JSON line of the kernels and,
last, the ok line.  TF32 is off for convolutions and matmuls so that the
card computes in float32 throughout.
"""
from __future__ import annotations

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

from planedepth_tpu_torch.config import (
    DataConfig,
    LossConfig,
    ModelConfig,
    PlaneConfig,
    hr_finetune_config,
    mono_config,
    self_distillation_config,
    stage1_config,
)
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.eval.evaluator import mirror_batch, predict_disparities
from planedepth_tpu_torch.eval.metrics import evaluate_disparities
from planedepth_tpu_torch.geometry.pose import transformation_from_parameters
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.ops import _build
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue, head_epilogue_plain
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain, shift_max
from planedepth_tpu_torch.ops.row_shift import row_shift, row_shift_plain, shift_limit
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
from planedepth_tpu_torch.train.trainer import Trainer
from planedepth_tpu_torch.utils.checkpoint import load_checkpoint

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
}


def only(**counts):
    """Launch counts that are 0 but for ``counts``."""
    unknown = set(counts) - set(KERNELS)
    if unknown:
        raise KeyError(f"no kernel {sorted(unknown)}")
    return {**{k: 0 for k in KERNELS}, **counts}


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
    the Laplacian's exp, the centre's exp and 1/sigma."""
    ops = 2 + int(mix) + int(with_auto and direction == "fwd")
    return ops + (1 + int(mix) if with_disp else 0)


def mufu_floor_ms(pixel_planes, ops):
    """Least time in ms for ``ops`` MUFU operations on each of
    ``pixel_planes``: the sweep kernels' second floor, under the bytes."""
    return pixel_planes * ops / MUFU_OPS_PER_S * 1e3


def sweep_kernel_info(backward, mix, N, W):
    """The compiler's and the occupancy calculator's view of the sweep
    kernel instance that a launch at (N, W) takes."""
    out = (ctypes.c_int * 5)()
    rc = _build.load_library().pdt_plane_sweep_kernel_info(int(backward), int(mix), N, W, out)
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
            "warp2d_nosigma_bwd": (warp2d, "nosigma_bwd_launches")}


def launch_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts():
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


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
        losses.append(train_step(batch))          # floats: the step has synchronised
        times.append(time.perf_counter() - t0)
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
        losses.append(make_train_step(bundle, opt, sched)(
            batch_to_tensors(batch, bundle.device)))
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


def check_losses(losses, cfg):
    for ls in losses:
        if not all(math.isfinite(v) for v in ls.values()):
            raise AssertionError(f"non-finite loss: {ls}")
        total = (ls["loss/ph_loss"] + cfg.loss.alpha_pc * ls["loss/pc_loss"]
                 + cfg.loss.alpha_smooth * ls["loss/smooth_loss"]
                 + cfg.loss.self_distillation * ls.get("loss/disp_loss", 0.0))
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
        want = only(disp_head_fwd=1, plane_sweep_fwd=2, plane_sweep_bwd=2,
                    head_epilogue_fwd=3, head_epilogue_bwd=2)   # 2 steps + one val batch
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
            out = step_fn(batch)                  # floats: the step has synchronised
            times.append(time.perf_counter() - t0)
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != DISTILL_STEP:
                raise AssertionError(f"stage-3 step launches {delta}, want {DISTILL_STEP}")
            losses.append(out)
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
    bundle = ModelBundle(cfg, dev)
    optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 1000)
    train_step = make_train_step(bundle, optimizer, scheduler)
    batch = batch_to_tensors(make_stereo_batch(cfg.per_step_batch, cfg.data.height,
                                               cfg.data.width, seed=0), dev)
    reset_launch_counts()
    losses = [train_step(batch) for _ in range(steps)]
    launches = launch_counts()
    want = only(plane_sweep_fwd=steps, plane_sweep_bwd=steps, row_shift_fwd=6 * steps,
                head_epilogue_fwd=steps, head_epilogue_bwd=steps)
    if launches != want:
        raise AssertionError(f"use_mom launches {launches}, want {want}")
    check_losses(losses, cfg)
    print(f"[mom] stage1_config use_mom at {cfg.data.width}x{cfg.data.height}, batch "
          f"{cfg.per_step_batch} flipped to {cfg.effective_batch}: {steps} steps, launches "
          f"{launches}, losses {json.dumps(losses[-1])} | {card}")


def seeded_warp_inputs(shape, seed, dev, degenerate=False, zoom=30.0, dead_plane=False):
    """2-D warp operands like a mono step's: per plane a zoom about the
    image centre (up to ``zoom`` px at the edges: ~30, the near planes under
    forward motion) plus a shift and sub-pixel noise, so that samples leave
    the image on both sides and run boundary-partial; with ``degenerate`` 5%
    of the samples at 1e12 / -3e9 and a row of NaN, as a near-singular
    homography gives them; with ``dead_plane`` the last plane of the first
    image wholly at 1e12 and the first half of the rows of the last plane
    of the last image NaN (bands of only degenerate samples).  logits and
    sigma require grad, as do dx, dy."""
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
    return [src, logits.requires_grad_(), sigma.requires_grad_(),
            dx.contiguous().requires_grad_(), dy.contiguous().requires_grad_(), mask]


class Held:
    """The worst errors of a kernel pair against its plain version over
    every shape it was held at: the forward's max abs error, and per
    gradient the max abs error and that error over the gradient's largest
    magnitude."""

    def __init__(self):
        self.fwd, self.abs, self.rel = 0.0, {}, {}

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
            self.rel[name] = max(err / max(scale, 1e-30), self.rel.get(name, 0.0))

    def bwd_fields(self):
        return {"max_abs_err": max(self.abs.values()), "max_rel_err": max(self.rel.values())}

    def describe(self):
        fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})
        return (f"forward max_abs_err {self.fwd:.3e} (rtol {TOL['rtol']}, atol {TOL['atol']}); "
                f"grads max_abs_err {fmt(self.abs)}, over max |value| {fmt(self.rel)} "
                f"(<= {GRAD_TOL})")


def launch_ms(fn, tensors, *sizes):
    """CUDA-event time of the library entry point ``fn`` alone, on
    ``tensors`` and ``sizes`` as its wrapper passes them: no allocation, no
    autograd, no launch count."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return cuda_ms(lambda: _build.launch(fn, *ptrs, *sizes))


def warp_kernel_info(with_sigma):
    """Registers, spills, block and occupancy of the warp backward kernel."""
    out = (ctypes.c_int * 4)()
    rc = _build.load_library().pdt_warp2d_bwd_kernel_info(int(with_sigma), out)
    if rc != 0:
        raise RuntimeError(f"pdt_warp2d_bwd_kernel_info: CUDA error {rc}")
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
    # than the grid's z axis takes (B * N > 65535: launches of whole images)
    extras = (((2, 3, 96, 330), dict(zoom=200.0)),
              ((2, 3, 24, 100), dict(degenerate=True, dead_plane=True)),
              ((2, 33000, 2, 5), {}))
    for i, (small, kw) in enumerate(extras):
        inputs = warp_inputs(small, 15 + i, **kw)
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

    # the library call: F.grid_sample on (B*N, C, H, W) [rgb | logit (| sigma)]
    # with a prebuilt normalised grid, both built outside the timed region;
    # its backward also computes the rgb input's gradient, which the
    # kernel skips
    heads = [logits] + ([sigma] if with_sigma else [])
    channels = 3 + len(heads)
    with torch.no_grad():
        x = torch.arange(W, device=dev, dtype=torch.float32)
        y = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
        grid = torch.stack([(dx + x) * (2.0 / (W - 1)) - 1.0,
                            (dy + y) * (2.0 / (H - 1)) - 1.0], -1).view(B * N, H, W, 2)
        stack = torch.cat([src[:, None].expand(B, N, 3, H, W),
                           *(t[:, :, None] for t in heads)], 2).view(B * N, channels, H, W)
    grid.requires_grad_()
    stack.requires_grad_()
    sample = lambda: F.grid_sample(stack, grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=True)
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(sample)
    lib_out = sample()
    lib_ct = torch.randn_like(lib_out)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(sample(), (stack, grid), lib_ct))
    del grid, stack, lib_out, lib_ct, inputs, wrt, heads
    free_cache()
    tag = "warp2d" if with_sigma else "warp2d_nosigma"
    info = warp_kernel_info(with_sigma)
    print(f"[{tag}] warp2d vs plain on {', '.join(map(str, smalls))}, each with and "
          f"without degenerate coordinates, on {extras[0][0]} at zoom 200, {extras[1][0]} "
          f"with degenerate planes, {extras[2][0]} (B * N > 65535), and at {shape}: "
          f"{held.describe()}; {'d_logits and d_sigma sum' if with_sigma else 'd_logits sums'}"
          f" by float atomics{' (neighbouring lanes combined)' if with_sigma else ''} in no "
          f"fixed order | {card}")
    print(f"[{tag}] backward kernel: {info['registers']} registers (spills "
          f"{info['spill_bytes']} B), {info['threads']} threads a block, "
          f"{info['blocks_per_sm']} blocks an SM, no shared memory | {card}")
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
                       "library_ms": lib_fwd_ms},
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


def trainer_run(cfg, dev, warmup, steps, per_step, after_val):
    """``cfg`` through the Trainer on synthetic samples: ``warmup + steps``
    steps, each held to the launch counts ``per_step``, and one validation
    pass, whose launches must be ``after_val``; then the memory of one more
    step by aten op.  Returns what the phases print."""
    with tempfile.TemporaryDirectory(prefix="pdt_chip_smoke_") as log_dir:
        # seeded random weights throughout: no ImageNet files in the checkout
        cfg = cfg.replace(log_dir=log_dir, allow_random_pc=True,
                          optim=dataclasses.replace(cfg.optim, num_epochs=1))
        b, h, w = cfg.per_step_batch, cfg.data.height, cfg.data.width
        novel = cfg.novel_frame_ids
        trainer = Trainer(cfg, datasets=(SyntheticStereo(b * (warmup + steps), h, w, novel),
                                         SyntheticStereo(b, h, w, novel)), device=dev)
        start = {k: p.detach().clone() for k, p in trainer.bundle.named_parameters()}
        times, losses, val = [], [], {}
        step_fn, val_fn = trainer.train_step, trainer.val

        def timed_step(batch):
            if len(times) == warmup:
                torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts()
            t0 = time.perf_counter()
            out = step_fn(batch)                  # floats: the step has synchronised
            times.append(time.perf_counter() - t0)
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != per_step:
                raise AssertionError(f"{cfg.model_name} step launches {delta}, want {per_step}")
            losses.append(out)
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
        want = {k: v * n + after_val.get(k, 0) for k, v in per_step.items()}
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
        batch = batch_to_tensors(step_batch(cfg, 0), dev)
        memory = memory_by_op(lambda: step_fn(batch), dev)
        del trainer, start, batch
        free_cache()
    return {"cfg": cfg, "launches": launches, "losses": losses, "val": val["metrics"],
            "moved": moved, "saved": saved, "memory": memory, "peak_gb": peak_gb,
            "reserved_gb": reserved_gb, "step_ms": statistics.median(times[warmup:]) * 1e3,
            "warmup": warmup, "steps": steps}


def print_trainer_run(tag, what, run, cpu, cpu_shape, card):
    cfg, b = run["cfg"], run["cfg"].per_step_batch
    print(f"[{tag}] {what}, {cfg.data.width}x{cfg.data.height}, batch {b}"
          f"{f' flipped to {cfg.effective_batch}' if cfg.flip_right else ''}: "
          f"{run['warmup']}+{run['steps']} steps through Trainer, launches {run['launches']}; "
          f"parameter tensors moved per network {json.dumps(run['moved'])}; saved "
          f"{run['saved']}; first/last losses {json.dumps(run['losses'][0])} "
          f"{json.dumps(run['losses'][-1])}")
    print(f"[{tag}] validation metrics {json.dumps(run['val'])}")
    print(f"[{tag}] card vs CPU at {cpu_shape} (one step): {json.dumps(cpu)}")
    print(f"[{tag}] step {run['step_ms']:.2f} ms median of {run['steps']} (host clock around "
          f"synchronised steps, after {run['warmup']} warm-up), "
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
        bundle = ModelBundle(cfg, dev)
        optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 1000)
        train_step = make_train_step(bundle, optimizer, scheduler)
        batch = batch_to_tensors(step_batch(cfg, 0), dev)
        losses = []
        for _ in range(steps):
            before = launch_counts()
            losses.append(train_step(batch))
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            if delta != per_step:
                raise AssertionError(f"{name} step launches {delta}, want {per_step}")
        check_losses(losses, cfg)
        total = {k: v + steps * per_step[k] for k, v in total.items()}
        nonzero = {k: v for k, v in per_step.items() if v}
        lines.append(f"[nomix] {name} without the mixture at {cfg.data.width}x"
                     f"{cfg.data.height}, batch {cfg.effective_batch}: {steps} steps, launches "
                     f"per step {nonzero}, losses {json.dumps(losses[-1])} | {card}")
        del bundle, optimizer, scheduler, train_step, batch
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
    bundle = ModelBundle(mixed, dev)
    optimizer, scheduler = make_optimizer(mixed, bundle.parameters(), 1000)
    train_step = make_train_step(bundle, optimizer, scheduler)
    batch = batch_to_tensors(step_batch(mixed, 0), dev)
    reset_launch_counts()
    mixed_losses = [train_step(batch) for _ in range(2)]
    mixed_launches = launch_counts()
    want = {k: 2 * v for k, v in MIXED_STEP.items()}
    if mixed_launches != want:
        raise AssertionError(f"mixed launches {mixed_launches}, want {want}")
    check_losses(mixed_losses, mixed)
    del bundle, optimizer, batch
    free_cache()
    print(f"[mono] mixed disp_warp (side r through the sweep, -1 and 1 through the 2-D "
          f"warp) at {w}x{h}, batch {b}: 2 steps, launches {mixed_launches}, losses "
          f"{json.dumps(mixed_losses[-1])} | {card}")
    return run["launches"]


def main():
    t_start = time.perf_counter()

    def run(phase, *args, **kwargs):
        """One phase, with its wall time."""
        t0 = time.perf_counter()
        out = phase(*args, **kwargs)
        print(f"[time] {phase.__name__}{'' if not kwargs else kwargs}: "
              f"{time.perf_counter() - t0:.1f} s")
        return out

    card = run(phase_device)
    run(phase_build)
    # launches: each kernel's count on the path that brought it to the port
    fields = {"disp_head_fwd": run(phase_kernel, card)}
    launches = {"disp_head_fwd": run(phase_slice, card)["disp_head_fwd"]}
    fields.update(run(phase_sweep, card))
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
    print(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **fields[name]}
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
