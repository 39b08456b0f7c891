"""Where the time of the port's stage-1 training step goes on one NVIDIA GPU.

    python scripts/profile_torch_step.py [--steps 3]

Runs ``stage1_config()`` (ResNet-50, DenseASPP, 49+14 planes, VGG19
perceptual loss, Adam; 8 images at 640x192, float32, TF32 off) with seeded
random weights and prints, each beside the card's name and power limit:
  - the device time of a few steps under ``torch.profiler``, split by kernel
    class (the two plane-sweep kernels, convolutions, BatchNorm, the rest)
    and the device's idle share of the profiled wall time;
  - the step time with and without the perceptual loss (``alpha_pc`` 0.1
    and 0), host clock around synchronised steps, median of 5, in turns:
    the difference is what the VGG costs.
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

from planedepth_tpu_torch.config import LossConfig, stage1_config  # noqa: E402
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
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "::bn_")),
    ("convolution", ("conv", "cudnn", "gemm", "xmma", "implicit", "fft", "winograd",
                     "wgrad", "dgrad", "pointwise_mult_and_sum_complex", "cutlass")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def make_step(cfg, device):
    bundle = ModelBundle(cfg, device)
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

    full = make_step(stage1_config(), device)
    no_pc = make_step(stage1_config(loss=LossConfig(alpha_pc=0.0)), device)
    for step in (full, no_pc):
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

    with_pc, without_pc = [], []
    for _ in range(5):                      # in turns, so drift hits both alike
        with_pc += timed(full, 1)
        without_pc += timed(no_pc, 1)
    summary = {
        "card": card,
        "profiled_steps": args.steps,
        "device_ms_per_step": device_ms,
        "wall_ms_per_step_profiled": wall_ms / args.steps,
        "idle_share": 1.0 - device_ms * args.steps / wall_ms if wall_ms else None,
        "device_ms_by_class": by_class,
        "top_kernels_ms": dict(top),
        "step_ms_alpha_pc_0.1": statistics.median(with_pc),
        "step_ms_alpha_pc_0": statistics.median(without_pc),
        "step_ms_runs": {"alpha_pc_0.1": with_pc, "alpha_pc_0": without_pc},
    }
    summary["vgg_ms"] = summary["step_ms_alpha_pc_0.1"] - summary["step_ms_alpha_pc_0"]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
