"""Time the plane-sweep kernels of this tree against another checkout's, on one card, in one process.

    python scripts/compare_sweep.py --other <checkout> [--out build/compare_sweep.json]

Builds this tree's kernels (``planedepth_tpu_torch/ops/_build.py``) and the
other checkout's ``planedepth_tpu_torch/csrc/plane_sweep.cu`` alone into a
library of its own (its C entry points ``pdt_plane_sweep_fwd``/``_bwd`` have
this tree's signature).  At stage 1's (8, 63, 192, 640) and stage 3's
(4, 63, 384, 1280) mixture shapes and FalNet's (8, 49, 192, 640) no-mixture
shape, on the same seeded inputs as ``chip_smoke.py``'s sweep phases, each
library's forward and backward entry point is launched alone (no autograd,
no allocation), in turns: other, this, this, other; each time is the median
of 20 CUDA-event times after 3 warm-ups.  The two libraries' outputs are
held to each other (forward at rtol = atol = 1e-5, gradients to 1e-4 of their largest
magnitude), and two backward runs of this tree's kernel must be
bit-identical.  Prints one JSON object, also written to ``--out``, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs                                   # noqa: E402
from planedepth_tpu_torch.config import stage1_config     # noqa: E402
from planedepth_tpu_torch.ops import _build               # noqa: E402
from planedepth_tpu_torch.ops.plane_sweep import shift_max  # noqa: E402
from planedepth_tpu_torch.train.step import sweep_pad     # noqa: E402

# (name, shape, mixture, with_disp): the main paths' calls
CASES = (("stage1 mixture", cs.SWEEP_SHAPE, True, True),
         ("stage3 mixture", cs.SHIFT_SHAPE, True, True),
         ("falnet no mixture", cs.FALNET_SHAPE, False, False))


def build_other(checkout: Path) -> ctypes.CDLL:
    """The other checkout's plane_sweep.cu alone, as a shared library."""
    src = checkout / "planedepth_tpu_torch" / "csrc" / "plane_sweep.cu"
    out = REPO / "build" / "compare_sweep" / "libother_sweep.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pdt_plane_sweep_fwd.argtypes = [p] * 11 + [i, i, i, i, f, i, i, i, p]
    lib.pdt_plane_sweep_fwd.restype = i
    lib.pdt_plane_sweep_bwd.argtypes = [p] * 14 + [i, i, i, i, f, i, i, p]
    lib.pdt_plane_sweep_bwd.restype = i
    return lib


def call(lib, fn, *args):
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(lib, fn)(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")


def run_case(libs, shape, mix, with_disp, limit, dev):
    inputs = cs.seeded_sweep_inputs(shape, 1, dev)
    src, tgt, logits, sigma, shift, mask = (t.detach() for t in inputs)
    if not mix:
        sigma = None
    B, N, H, W = shape
    new = lambda *size: torch.empty(size, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    g_rgb = torch.randn((B, 3, H, W), generator=g, device=dev)
    g_nll = torch.randn((B, H, W), generator=g, device=dev)
    g_disp = torch.randn((B, H, W), generator=g, device=dev) if with_disp else None
    res = {}
    for name, lib in libs.items():
        outs = dict(rgb=new(B, 3, H, W), nll=new(B, H, W),
                    disp=new(B, H, W) if with_disp else None,
                    stats=new(B, 7 if with_disp else 4, H, W))
        grads = dict(d_logits=torch.empty_like(logits),
                     d_sigma=torch.empty_like(logits) if mix else None,
                     d_shift=torch.empty_like(shift))
        fwd = lambda lib=lib, o=outs: call(
            lib, "pdt_plane_sweep_fwd", src, tgt, logits, sigma, shift, mask, o["rgb"],
            o["nll"], None, o["disp"], o["stats"], B, N, H, W, limit, 0, int(with_disp),
            int(mix))
        bwd = lambda lib=lib, o=outs, d=grads: call(
            lib, "pdt_plane_sweep_bwd", src, tgt, logits, sigma, shift, mask, o["stats"],
            o["rgb"], g_rgb, g_nll, g_disp, d["d_logits"], d["d_sigma"], d["d_shift"],
            B, N, H, W, limit, int(with_disp), int(mix))
        fwd()
        bwd()
        torch.cuda.synchronize(dev)
        res[name] = dict(fwd=fwd, bwd=bwd, outs=outs, grads=grads)

    this, other = res["this"], res["other"]
    # beyond the forward tolerance of the tests: |a - b| - 1e-5 |b| (atol 1e-5)
    fwd_err = max(((this["outs"][k] - other["outs"][k]).abs()
                   - 1e-5 * other["outs"][k].abs()).max().item()
                  for k in ("rgb", "nll", "disp") if this["outs"][k] is not None)
    grad_rel = {}
    for k, a in this["grads"].items():
        if a is None:
            continue
        b = other["grads"][k]
        grad_rel[k] = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    first = {k: v.clone() for k, v in this["grads"].items() if v is not None}
    this["bwd"]()
    torch.cuda.synchronize(dev)
    identical = all(torch.equal(first[k], this["grads"][k]) for k in first)
    if fwd_err > 1e-5 or max(grad_rel.values()) > 1e-4 or not identical:
        raise AssertionError(f"{shape}: forward {fwd_err:.3e}, grads {grad_rel}, "
                             f"repeat bit-identical {identical}")

    times = {f"{n}_{d}": [] for n in ("this", "other") for d in ("fwd", "bwd")}
    for turn in ("other", "this", "this", "other"):
        for d in ("fwd", "bwd"):
            times[f"{turn}_{d}"].append(cs.cuda_ms(res[turn][d], warmup=3, reps=20))
    bounds = (cs.sweep_bounds(inputs) if mix
              else cs.sweep_nomix_bounds([src, tgt, logits, None, shift, mask], with_disp))
    (fwd_bytes, fwd_bound), (bwd_bytes, bwd_bound) = bounds
    return {"shape": list(shape), "mixture": mix, "with_disp": with_disp,
            "ms": times, "bound_ms": {"fwd": fwd_bound[0], "bwd": bwd_bound[0]},
            "mufu_floor_ms": {d: cs.mufu_floor_ms(logits.numel(), cs.sweep_mufu(mix, with_disp, d))
                              for d in ("fwd", "bwd")},
            "kernel_info": {d: cs.sweep_kernel_info(d == "bwd", mix, N, W)
                            for d in ("fwd", "bwd")},
            "fwd_excess_over_rtol": fwd_err, "grad_max_rel_diff": grad_rel,
            "bwd_repeat_bit_identical": identical}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", default=str(REPO / "build" / "compare_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_sweep: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    libs = {"this": _build.load_library(), "other": build_other(args.other)}
    limit = shift_max(sweep_pad(stage1_config()))
    cases = {name: run_case(libs, shape, mix, with_disp, limit, dev)
             for name, shape, mix, with_disp in CASES}
    report = {"card": card, "other": str(args.other), "cases": cases}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    for name, c in cases.items():
        t = c["ms"]
        print(f"[compare] {name} {tuple(c['shape'])}: forward this {t['this_fwd']} other "
              f"{t['other_fwd']} ms (bound {c['bound_ms']['fwd']:.4f}, MUFU floor "
              f"{c['mufu_floor_ms']['fwd']:.4f}); backward this {t['this_bwd']} other "
              f"{t['other_bwd']} ms (bound {c['bound_ms']['bwd']:.4f}, MUFU floor "
              f"{c['mufu_floor_ms']['bwd']:.4f}) | {card}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
