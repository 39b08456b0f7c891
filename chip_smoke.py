"""Drive the PyTorch/CUDA port's inference path and stage-1 training step on one NVIDIA GPU.

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
     plane_sweep_plain at the stage-1 shape (8, 63, 192, 640) on seeded
     step-like inputs (row-constant vertical shifts up to ~320, per-row
     ground shifts, a fully masked row, shifts beyond the clip):
     forward outputs, then d_logits, d_sigma, d_shift from autograd with
     seeded cotangents; kernel and twin times by CUDA events;
  6. train: stage1_config() (ResNet-50, DenseASPP, 49+14 planes, VGG19
     perceptual loss, Adam) at 640x192 with seeded random weights on
     make_stereo_batch(4, 192, 640) flipped to 8: 3 warm-up and 10 timed
     steps with every launch count read around them, one validation step
     (make_eval_step, which launches disp_head), and one step on the card
     held to the same step on the CPU at 64x192.
Then one JSON line of the kernels and, last, the ok line.  TF32 is off for
convolutions and matmuls so that the card computes in float32 throughout.
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

from planedepth_tpu_torch.config import DataConfig, ModelConfig, stage1_config
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.eval.evaluator import mirror_batch, predict_disparities
from planedepth_tpu_torch.eval.metrics import evaluate_disparities
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.ops import _build
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain
from planedepth_tpu_torch.train.state import make_optimizer
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    make_eval_step,
    make_train_step,
    process_batch,
    sweep_pad,
)

SHAPE = (8, 63, 384, 1280)            # (B, N, H, W): eval batch 4, doubled
SWEEP_SHAPE = (8, 63, 192, 640)       # stage-1 batch 4, flipped to 8
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
}


def bound(nbytes, flops):
    """Least time in ms for moving ``nbytes`` and doing ``flops`` on the card,
    and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def phase_sweep(card, shape=SWEEP_SHAPE, dev=torch.device("cuda")):
    """The sweep kernels against their twin; returns the JSON fields of both."""
    inputs = seeded_sweep_inputs(shape, 1, dev)
    heads = inputs[2:5]
    pad = sweep_pad(stage1_config())
    fwd_err = 0.0
    for with_auto in (False, True):
        got = plane_sweep(*inputs, pad, with_auto, True)
        torch.cuda.synchronize(dev)
        want = plane_sweep_plain(*inputs, pad, with_auto, True)
        names = ("rgb", "nll") + (("nll_auto",) if with_auto else ()) + ("disp",)
        for name, a, b in zip(names, got, want):
            torch.testing.assert_close(a, b, msg=name, **TOL)
            fwd_err = max(fwd_err, (a - b).abs().max().item())
    if not bool((got[-1][:, 5] == 0).all()):
        raise AssertionError("fully masked row must give disp 0")

    # the step's configuration: no automask; seeded cotangents on every output
    got = plane_sweep(*inputs, pad, False, True)
    want = plane_sweep_plain(*inputs, pad, False, True)
    g = torch.Generator(device=dev).manual_seed(2)
    cts = [torch.randn(o.shape, generator=g, device=dev) for o in got]
    d_got = torch.autograd.grad(got, heads, cts, retain_graph=True)
    torch.cuda.synchronize(dev)
    d_want = torch.autograd.grad(want, heads, cts)
    bwd_err, rel = 0.0, {}
    for name, a, b in zip(("d_logits", "d_sigma", "d_shift"), d_got, d_want):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        rel[name] = err / scale
        if err > GRAD_TOL * scale:
            raise AssertionError(f"{name}: max err {err:.3e} > {GRAD_TOL} x {scale:.3e}")
        bwd_err = max(bwd_err, err)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: plane_sweep(*inputs, pad, False, True))
        plain_fwd_ms = cuda_ms(lambda: plane_sweep_plain(*inputs, pad, False, True))
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(got, heads, cts, retain_graph=True))
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        plane_sweep_plain(*inputs, pad, False, True), heads, cts), warmup=1, reps=3)
    # bytes: each input read once, each output written once (stats: 7 maps);
    # operations: ~60 flops a pixel-plane forward, ~100 backward
    src, tgt, logits, sigma, shift, mask = inputs
    B, N, H, W = shape
    row = B * H * W * 4
    fwd_bytes = nbytes(src, tgt, logits, sigma, shift, mask) + row * (3 + 1 + 1 + 7)
    bwd_bytes = (nbytes(src, tgt, logits, sigma, shift, mask) + row * (7 + 3 + 3 + 1 + 1)
                 + nbytes(logits, sigma, shift))
    fwd_bound = bound(fwd_bytes, 60 * logits.numel())
    bwd_bound = bound(bwd_bytes, 100 * logits.numel())
    print(f"[sweep] plane_sweep vs plain at {shape}, pad {pad}: forward max_abs_err "
          f"{fwd_err:.3e} (rtol {TOL['rtol']}, atol {TOL['atol']}); grads max err / "
          f"max |value| {json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} "
          f"(<= {GRAD_TOL}) | {card}")
    print(f"[sweep] forward kernel {fwd_ms:.4f} ms (bound {fwd_bound[0]:.4f} ms, "
          f"{fwd_bytes / 1e6:.0f} MB), backward kernel {bwd_ms:.4f} ms (bound "
          f"{bwd_bound[0]:.4f} ms, {bwd_bytes / 1e6:.0f} MB); twin forward "
          f"{plain_fwd_ms:.2f} ms, twin forward+backward {plain_ms:.2f} ms; no "
          f"single PyTorch call computes either | {card}")
    return {
        "plane_sweep_fwd": {"library_ms": None, "max_abs_err": fwd_err, "ms": fwd_ms,
                            "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound[0],
                            "bound_by": fwd_bound[1]},
        "plane_sweep_bwd": {"library_ms": None, "max_abs_err": bwd_err, "ms": bwd_ms,
                            # the twin's backward: its forward+backward less its forward
                            "plain_ms": plain_ms - plain_fwd_ms,
                            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]},
    }


def launch_counts():
    return {"disp_head_fwd": disp_head.launches,
            "plane_sweep_fwd": plane_sweep.fwd_launches,
            "plane_sweep_bwd": plane_sweep.bwd_launches}


def reset_launch_counts():
    disp_head.launches = plane_sweep.fwd_launches = plane_sweep.bwd_launches = 0


def phase_train(card, dev=torch.device("cuda"), warmup=3, steps=10):
    """The stage-1 step on the card; returns the launch counts of its run."""
    cfg = stage1_config()
    bundle = ModelBundle(cfg, dev)
    optimizer, scheduler = make_optimizer(cfg, bundle.model.parameters(), 1000)
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
    want = {"disp_head_fwd": 0, "plane_sweep_fwd": warmup + steps,
            "plane_sweep_bwd": warmup + steps}
    if launches != want:
        raise AssertionError(f"training launches {launches}, want {want}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for ls in losses:
        if not all(math.isfinite(v) for v in ls.values()):
            raise AssertionError(f"non-finite loss: {ls}")
        total = (ls["loss/ph_loss"] + cfg.loss.alpha_pc * ls["loss/pc_loss"]
                 + cfg.loss.alpha_smooth * ls["loss/smooth_loss"])
        if not math.isclose(ls["loss/total_loss"], total, rel_tol=1e-5, abs_tol=1e-6):
            raise AssertionError(f"total {ls['loss/total_loss']} != {total}")
    moved = sum(int(not torch.equal(p, first[k]))
                for k, p in bundle.model.named_parameters())
    if moved < len(first) // 2:
        raise AssertionError(f"only {moved} of {len(first)} parameters changed")

    reset_launch_counts()
    metrics = make_eval_step(bundle)(batch)
    eval_launches = launch_counts()
    if eval_launches["disp_head_fwd"] != 1 or not all(math.isfinite(v) for v in metrics.values()):
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
          f"{peak_gb:.2f} GB; float32, TF32 off for cudnn and matmul | {card}")
    return launches


def check_step_against_cpu(cfg, dev, seed=1):
    """One training step of ``cfg`` on the card and on the CPU (plain twin)
    from the same weights, batch and dropout masks; returns the worst errors.

    - losses at rtol 1e-3;
    - gradients, each leaf against the float64 gradient of the same step on
      the CPU: relative L2 error <= 0.1.  Float32 rounding through train-mode
      BatchNorm over few pixels is amplified (the CPU's own float32 error is
      printed beside the card's), and cuDNN's convolutions round differently
      again, so the bound is one an error of the method, not of rounding,
      would exceed;
    - post-Adam parameters at atol 1e-4 wherever the step's direction is
      fixed: the first Adam step is ~lr * sign(g), so elements whose float64
      gradient is under the card's and the CPU's largest float32 error on
      their leaf may differ by one step each way (2 * lr), and are held to
      that.
    """
    batch = make_stereo_batch(cfg.per_step_batch, cfg.data.height, cfg.data.width,
                              seed=seed)
    cpu_dev = torch.device("cpu")
    bundles = (ModelBundle(cfg, dev), ModelBundle(cfg, cpu_dev))
    losses = []
    for bundle in bundles:
        opt, sched = make_optimizer(cfg, bundle.model.parameters(), 1000)
        losses.append(make_train_step(bundle, opt, sched)(
            batch_to_tensors(batch, bundle.device)))
    for k, v in losses[1].items():
        if not math.isclose(losses[0][k], v, rel_tol=STEP_LOSS_RTOL, abs_tol=1e-7):
            raise AssertionError(f"{k}: card {losses[0][k]} vs CPU {v}")

    ref = ModelBundle(cfg, cpu_dev)               # float64, same first-step masks
    ref.model.double().train()
    if ref.pc is not None:
        ref.pc.double()
    out = process_batch(ref, {k: v.double() for k, v in
                              batch_to_tensors(batch, cpu_dev).items()},
                        torch.Generator().manual_seed(cfg.seed << 32))
    out["loss/total_loss"].backward()
    g64 = {k: p.grad for k, p in ref.model.named_parameters()}
    card, cpu = (dict(b.model.named_parameters()) for b in bundles)
    after = [{k: v.double().cpu() for k, v in b.model.state_dict().items()} for b in bundles]
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


def main():
    card = phase_device()
    phase_build()
    fields = {"disp_head_fwd": phase_kernel(card)}
    launches = {"disp_head_fwd": phase_slice(card)["disp_head"]}
    fields.update(phase_sweep(card))
    train = phase_train(card)
    launches.update({k: train[k] for k in ("plane_sweep_fwd", "plane_sweep_bwd")})
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **fields[name]}
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
