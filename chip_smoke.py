"""Drive the PyTorch/CUDA port's inference path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: needs CUDA (exits non-zero without it) and prints the card's
     name and power limit as nvidia-smi gives them;
  2. build: compiles planedepth_tpu_torch/csrc/*.cu with nvcc for sm_90a;
  3. kernel: disp_head (CUDA) against disp_head_plain on seeded inputs at
     the slice's shape (8, 63, 384, 1280), one row fully masked;
  4. slice: the eval recipe's model (ResNet-50, DenseASPP, 49+14 planes,
     mixture sigma, plane residual, 8-channel neural PE) at 384x1280 with
     seeded random weights, through predict_disparities(post_process=True)
     on make_stereo_batch(4, 384, 1280): 8 images through the net; the
     launch count of every kernel is read around that run; disp is checked
     against the plain head on the decoder's own tensors, the card's
     forward against the CPU's on a small input, and disp is scored with
     evaluate_disparities; forward and kernel times by CUDA events.
Then one JSON line of the kernels and, last, the ok line.  TF32 is off for
convolutions and matmuls so that the forward is float32 throughout.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from planedepth_tpu_torch.config import DataConfig, ModelConfig
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.eval.evaluator import mirror_batch, predict_disparities
from planedepth_tpu_torch.eval.metrics import evaluate_disparities
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.ops import _build
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain

SHAPE = (8, 63, 384, 1280)            # (B, N, H, W): eval batch 4, doubled
TOL = dict(rtol=1e-5, atol=1e-5)      # only the f32 summation order differs
# cuDNN and CPU float32 convolutions through a ResNet: the tolerance at which
# tests/test_torch_models.py holds the CPU port to the JAX package
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
KERNEL_SOURCE = "planedepth_tpu_torch/csrc/disp_head.cu"
KERNEL_REPLACES = "planedepth_tpu/ops/pallas_disp.py:40"


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
             if "registers" in ln or "spill" in ln]
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
    print(f"[kernel] disp_head vs plain at {shape}: max_abs_err {err:.3e} "
          f"(rtol {TOL['rtol']}, atol {TOL['atol']}) | kernel {ms:.4f} ms "
          f"({gbytes / ms:.1f} TB/s of logits+sigma), plain {plain_ms:.4f} ms "
          f"| {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_slice(card, data=DataConfig(height=384, width=1280),
                dev=torch.device("cuda")):
    cfg = ModelConfig()                  # the eval recipe: ResNet-50, 49+14
    height, width = data.height, data.width
    model = init_weights_(DepthModel(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    batch = make_stereo_batch(4, height, width, seed=0)

    disp_head.launches = 0
    t0 = time.perf_counter()
    disps, prob_max = predict_disparities(model, [batch], post_process=True,
                                          device=dev)
    wall = time.perf_counter() - t0
    launches = {"disp_head": disp_head.launches}
    if launches["disp_head"] < 1:
        raise AssertionError(f"main path launched no disp_head kernel: {launches}")
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


def main():
    card = phase_device()
    phase_build()
    kernel = phase_kernel(card)
    launches = phase_slice(card)
    print(json.dumps({"kernels": [{
        "name": "disp_head_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches["disp_head"],
        **kernel}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
