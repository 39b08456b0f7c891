"""Where the time of the port's training step goes on one NVIDIA GPU.

    python scripts/profile_torch_step.py [--recipe stage1|stage3|mono|falnet|pladenet|render|yz|self] [--steps 3] [--no_bf16]

Runs one recipe's step with seeded random weights, in bf16 (the default, as
in the JAX package) or float32 with ``--no_bf16``, TF32 off:
``stage1`` is ``stage1_config()`` (ResNet-50, DenseASPP, 49+14 planes, VGG19
perceptual loss, Adam; 8 images at 640x192), ``stage3`` is
``self_distillation_config()`` (the same model and loss at 1280x384, batch 4,
plus the frozen teacher on 8 images), ``mono`` is ``mono_config()`` (the
same model with the pose nets, the homography warp to the sides r, -1, 1,
automask and the perceptual loss per side; 8 images at 640x192), ``falnet``
is stage 1 with FalNet (49 fronto-parallel planes, no mixture: the
no-mixture sweep), ``pladenet`` stage 1 with PladeNet (49+14 planes,
mixture, 8-channel PE, plane residuals), ``render`` stage 1 with
render_probability and ``yz`` stage 1 with yz side planes (yz_levels 8),
both through the 2-D warp, and ``self`` stage 1 with alpha_self 0.1 and
SSIM.  Prints,
each beside the card's name and power limit:
  - the device time of a few steps under ``torch.profiler``, split by kernel
    class (the port's kernels, convolutions, BatchNorm, the rest) and the
    device's idle share of the profiled wall time;
  - the step time with and without each of the recipe's parts, host clock
    around synchronised steps, median of 5, in turns: the perceptual loss
    (``alpha_pc`` 0.1 and 0) for stage 1, FalNet, PladeNet, mono, render
    and yz, the teacher (``self_distillation`` 1 and 0) for stage 3, the pose
    nets for mono (``use_colmap``: the batch's poses instead), the switch
    itself for render, yz and self (stage 1 without it: render and yz then
    take the plane sweep); the difference is what that part costs.
The summary is one JSON line on standard output.  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from planedepth_tpu_torch.config import (  # noqa: E402
    DataConfig,
    LossConfig,
    ModelConfig,
    PlaneConfig,
    mono_config,
    self_distillation_config,
    stage1_config,
)
from planedepth_tpu_torch.data.synthetic import make_stereo_batch  # noqa: E402
from planedepth_tpu_torch.train.state import make_optimizer  # noqa: E402
from planedepth_tpu_torch.train.step import (  # noqa: E402
    ModelBundle,
    batch_to_tensors,
    make_train_step,
)

# first match wins: cuDNN names its BatchNorm kernels "cudnn::bn_..."
CLASSES = (
    ("plane_sweep", ("sweep_fwd_kernel", "sweep_bwd_kernel")),
    ("row_shift", ("row_shift_fwd_kernel",)),
    ("disp_head", ("disp_head_fwd_kernel", "disp_head_bwd_kernel")),
    ("head_epilogue", ("head_epilogue_fwd_kernel", "head_epilogue_bwd_kernel")),
    ("warp2d", ("warp2d_fwd_kernel", "warp2d_bwd_kernel")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "::bn_")),
    ("convolution", ("conv", "cudnn", "gemm", "xmma", "implicit", "fft", "winograd",
                     "wgrad", "dgrad", "pointwise_mult_and_sum_complex", "cutlass")),
)


FALNET = ModelConfig(net_type="FalNet", use_mixture_loss=False, plane_residual=False,
                     planes=PlaneConfig(xz_levels=0))
PLADENET = ModelConfig(net_type="PladeNet", num_ep=8, use_mixture_loss=True, plane_residual=True)
RENDER = ModelConfig(render_probability=True)
YZ = ModelConfig(planes=PlaneConfig(yz_levels=8))
SELF = LossConfig(alpha_self=0.1, use_ssim=True)

# recipe -> (its config, {part: the overrides that take that part out})
RECIPES = {
    "stage1": (stage1_config, {"vgg": dict(loss=LossConfig(alpha_pc=0.0))}),
    "falnet": (lambda **kw: stage1_config(model=FALNET, **kw),
               {"vgg": dict(loss=LossConfig(alpha_pc=0.0))}),
    "pladenet": (lambda **kw: stage1_config(model=PLADENET, **kw),
                 {"vgg": dict(loss=LossConfig(alpha_pc=0.0))}),
    "stage3": (self_distillation_config, {"teacher": dict(loss=LossConfig())}),
    "mono": (mono_config, {"vgg": dict(loss=LossConfig(alpha_pc=0.0, automask=True)),
                           "pose_nets": dict(data=DataConfig(use_colmap=True))}),
    "render": (lambda **kw: stage1_config(**{"model": RENDER, **kw}),
               {"vgg": dict(loss=LossConfig(alpha_pc=0.0)), "render": dict(model=ModelConfig())}),
    "yz": (lambda **kw: stage1_config(**{"model": YZ, **kw}),
           {"vgg": dict(loss=LossConfig(alpha_pc=0.0)), "yz": dict(model=ModelConfig())}),
    "self": (lambda **kw: stage1_config(**{"loss": SELF, **kw}),
             {"self_loss": dict(loss=LossConfig())}),
}


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def make_step(cfg, device):
    bundle = ModelBundle(cfg, device)
    if cfg.loss.self_distillation > 0:
        bundle.freeze_teacher()
    optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 1000)
    batch = batch_to_tensors(make_stereo_batch(cfg.per_step_batch, cfg.data.height,
                                               cfg.data.width, seed=0,
                                               novel_frame_ids=cfg.novel_frame_ids), device)
    step = make_train_step(bundle, optimizer, scheduler)
    return lambda: step(batch)


def timed(step, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()            # the step's losses stay on the device
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--recipe", choices=sorted(RECIPES), default="stage1")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--no_bf16", action="store_true", help="float32 networks and kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    preset, parts = RECIPES[args.recipe]
    # seeded random weights: no converted ImageNet files in the checkout
    full = make_step(preset(allow_random_pc=True, bf16=not args.no_bf16), device)
    reduced = {part: make_step(preset(allow_random_pc=True, bf16=not args.no_bf16, **kw),
                               device)
               for part, kw in parts.items()}
    for step in (full, *reduced.values()):
        timed(step, 3)                      # warm-up: cuDNN picks its algorithms

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed(full, args.steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, kernels = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / args.steps
        by_class[classify(evt.key)] = by_class.get(classify(evt.key), 0.0) + ms
        kernels[evt.key] = ms
    device_ms = sum(by_class.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]

    runs = {"full": []} | {f"without_{part}": [] for part in parts}
    for _ in range(5):                      # in turns, so drift hits all alike
        runs["full"] += timed(full, 1)
        for part, step in reduced.items():
            runs[f"without_{part}"] += timed(step, 1)
    step_ms = statistics.median(runs["full"])
    summary = {
        "card": card,
        "recipe": args.recipe,
        "profiled_steps": args.steps,
        "device_ms_per_step": device_ms,
        "wall_ms_per_step_profiled": wall_ms / args.steps,
        "idle_share": 1.0 - device_ms * args.steps / wall_ms if wall_ms else None,
        "device_ms_by_class": by_class,
        "top_kernels_ms": dict(top),
        "step_ms": step_ms,
        "step_ms_runs": runs,
    }
    for part in parts:
        summary[f"{part}_ms"] = step_ms - statistics.median(runs[f"without_{part}"])
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
