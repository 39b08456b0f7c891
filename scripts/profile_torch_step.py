"""Where the time of the port's training step goes on one NVIDIA GPU.

    python scripts/profile_torch_step.py [--recipe stage1|stage3] [--steps 3]

Runs one recipe's step with seeded random weights, float32, TF32 off:
``stage1`` is ``stage1_config()`` (ResNet-50, DenseASPP, 49+14 planes, VGG19
perceptual loss, Adam; 8 images at 640x192), ``stage3`` is
``self_distillation_config()`` (the same model and loss at 1280x384, batch 4,
plus the frozen teacher on 8 images).  Prints, each beside the card's name
and power limit:
  - the device time of a few steps under ``torch.profiler``, split by kernel
    class (the port's kernels, convolutions, BatchNorm, the rest) and the
    device's idle share of the profiled wall time;
  - the step time with and without one part, host clock around synchronised
    steps, median of 5, in turns: the perceptual loss (``alpha_pc`` 0.1 and
    0) for stage 1, the teacher (``self_distillation`` 1 and 0) for stage 3;
    the difference is what that part costs.
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
    LossConfig,
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
    ("disp_head", ("disp_head_fwd_kernel",)),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "::bn_")),
    ("convolution", ("conv", "cudnn", "gemm", "xmma", "implicit", "fft", "winograd",
                     "wgrad", "dgrad", "pointwise_mult_and_sum_complex", "cutlass")),
)


# recipe -> (its config, the config without one part, that part's name)
RECIPES = {
    "stage1": (stage1_config, dict(loss=LossConfig(alpha_pc=0.0)), "vgg"),
    "stage3": (self_distillation_config, dict(loss=LossConfig()), "teacher"),
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
    optimizer, scheduler = make_optimizer(cfg, bundle.model.parameters(), 1000)
    batch = batch_to_tensors(make_stereo_batch(cfg.per_step_batch, cfg.data.height,
                                               cfg.data.width, seed=0), device)
    step = make_train_step(bundle, optimizer, scheduler)
    return lambda: step(batch)


def timed(step, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()                              # returns floats: synchronised
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--recipe", choices=sorted(RECIPES), default="stage1")
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    preset, without, part = RECIPES[args.recipe]
    full = make_step(preset(), device)
    reduced = make_step(preset(**without), device)
    for step in (full, reduced):
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

    with_part, without_part = [], []
    for _ in range(5):                      # in turns, so drift hits both alike
        with_part += timed(full, 1)
        without_part += timed(reduced, 1)
    summary = {
        "card": card,
        "recipe": args.recipe,
        "profiled_steps": args.steps,
        "device_ms_per_step": device_ms,
        "wall_ms_per_step_profiled": wall_ms / args.steps,
        "idle_share": 1.0 - device_ms * args.steps / wall_ms if wall_ms else None,
        "device_ms_by_class": by_class,
        "top_kernels_ms": dict(top),
        f"step_ms_with_{part}": statistics.median(with_part),
        f"step_ms_without_{part}": statistics.median(without_part),
        "step_ms_runs": {f"with_{part}": with_part, f"without_{part}": without_part},
    }
    summary[f"{part}_ms"] = (summary[f"step_ms_with_{part}"]
                             - summary[f"step_ms_without_{part}"])
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
