"""Time the plane-sweep, 2-D warp backward and disp-head backward kernels of this tree against another checkout's, on one card, in one process.

    python scripts/compare_sweep.py --other <checkout> [--out build/compare_sweep.json]

Builds this tree's kernels (``planedepth_tpu_torch/ops/_build.py``) and the
other checkout's ``planedepth_tpu_torch/csrc/plane_sweep.cu``,
``warp2d.cu`` and ``disp_head.cu``, each alone into a library of its own
(one nvcc each, started together).  The sweep's C entry points have this
tree's signature in both, and so do the warp backward's.  The other
disp-head backward may be the earlier one without a scratch argument (no
``pdt_disp_head_bwd_scratch_floats``), and is called as it was.

Cases: the sweep at stage 1's (8, 63, 192, 640) and stage 3's (4, 63, 384,
1280) mixture shapes and FalNet's (8, 49, 192, 640) no-mixture shape, on
``chip_smoke.py``'s sweep inputs; the warp backward with and without sigma
at the mono step's (8, 63, 192, 640) on ``chip_smoke.py``'s warp inputs
(zoom up to 30 px), and with sigma at zoom up to 200 px (taps far from the
sample's own row); the disp-head backward at (8, 63, 192, 640).  Each
library's entry point is launched alone (no autograd, no allocation), in
turns: other, this, this, other; each time is the median of 20 CUDA-event
times after 3 warm-ups.  The warp backward adds into its scatter buffers:
it is timed alone (on buffers zeroed once) and with the zeroing that its
wrapper runs.  The two libraries' outputs are held to each other (forward
at rtol = atol = 1e-5, gradients to 1e-4 of their largest magnitude); two
backward runs of this tree's sweep and disp-head kernels must be
bit-identical (the warp's repeat is reported).  Prints one JSON object,
also written to ``--out``, with the card's name and power limit.
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
# (name, with_sigma, zoom in px at the edges): the mono step's warps, and a
# zoom whose taps cross far into the neighbouring blocks' bands
WARP_CASES = (("warp2d_bwd sigma", True, 30.0), ("warp2d_bwd nosigma", False, 30.0),
              ("warp2d_bwd sigma zoom 200", True, 200.0))


def build_other(checkout: Path) -> dict:
    """The other checkout's plane_sweep.cu, warp2d.cu and disp_head.cu, each
    alone as a shared library: {"sweep", "warp2d", "disp_head"}."""
    out_dir = REPO / "build" / "compare_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, name in (("sweep", "plane_sweep"), ("warp2d", "warp2d"),
                      ("disp_head", "disp_head")):
        src = checkout / "planedepth_tpu_torch" / "csrc" / f"{name}.cu"
        out = out_dir / f"libother_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
        procs[key] = (out, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (out, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        libs[key] = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = libs["sweep"]
    lib.pdt_plane_sweep_fwd.argtypes = [p] * 11 + [i, i, i, i, f, i, i, i, p]
    lib.pdt_plane_sweep_fwd.restype = i
    lib.pdt_plane_sweep_bwd.argtypes = [p] * 14 + [i, i, i, i, f, i, i, p]
    lib.pdt_plane_sweep_bwd.restype = i
    lib = libs["warp2d"]
    lib.pdt_warp2d_bwd.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.pdt_warp2d_bwd.restype = i
    lib = libs["disp_head"]
    scratch = hasattr(lib, "pdt_disp_head_bwd_scratch_floats")
    lib.pdt_disp_head_bwd.argtypes = [p] * (9 if scratch else 8) + [i] * 4 + [p]
    lib.pdt_disp_head_bwd.restype = i
    if scratch:
        lib.pdt_disp_head_bwd_scratch_floats.argtypes = [i] * 4
        lib.pdt_disp_head_bwd_scratch_floats.restype = ctypes.c_longlong
    return libs


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


def rel_diffs(this, other):
    """Max |a - b| over max |b| of each named gradient."""
    return {k: (a - other[k]).abs().max().item() / max(other[k].abs().max().item(), 1e-30)
            for k, a in this.items() if a is not None}


def in_turns(fns):
    """CUDA-event medians of each of ``fns`` (name -> (turn, fn)), in turns
    other, this, this, other."""
    times = {name: [] for name in fns}
    for turn in ("other", "this", "this", "other"):
        for name, (who, fn) in fns.items():
            if who == turn:
                times[name].append(cs.cuda_ms(fn, warmup=3, reps=20))
    return times


def run_warp(libs, shape, with_sigma, zoom, dev):
    """The warp backward of both libraries at ``shape``, alone and with the
    zeroing of the buffers it adds into."""
    inputs = [None if t is None else t.detach()
              for t in cs.seeded_warp_inputs(shape, 20, dev, zoom=zoom)]
    if not with_sigma:
        inputs[2] = None
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(2)
    cts = [torch.randn((B, N, 3, H, W), generator=g, device=dev),
           torch.randn(shape, generator=g, device=dev),
           torch.randn(shape, generator=g, device=dev) if with_sigma else None]
    names = ("d_logits", "d_sigma", "d_dx", "d_dy")
    res = {}
    for who, lib in libs.items():
        grads = {k: torch.empty(shape, device=dev) for k in names}
        if not with_sigma:
            grads["d_sigma"] = None
        bwd = lambda lib=lib, d=grads: call(lib, "pdt_warp2d_bwd", *inputs, *cts, *d.values(),
                                            B, N, H, W, int(with_sigma))

        def zeroed(bwd=bwd, d=grads):
            for k in ("d_logits", "d_sigma"):
                if d[k] is not None:
                    d[k].zero_()
            bwd()
        zeroed()
        torch.cuda.synchronize(dev)
        res[who] = dict(bwd=bwd, zeroed=zeroed, grads=grads,
                        first={k: None if v is None else v.clone() for k, v in grads.items()})
    this, other = res["this"], res["other"]
    grad_rel = rel_diffs(this["first"], other["first"])
    this["zeroed"]()
    torch.cuda.synchronize(dev)
    live = [k for k, v in this["grads"].items() if v is not None]
    repeat_identical = all(torch.equal(this["grads"][k], this["first"][k]) for k in live)
    if max(grad_rel.values()) > 1e-4:
        raise AssertionError(f"warp {shape} sigma={with_sigma}: grads {grad_rel}")
    times = in_turns({"this_ms": ("this", this["bwd"]), "other_ms": ("other", other["bwd"]),
                      "this_with_zeroing_ms": ("this", this["zeroed"]),
                      "other_with_zeroing_ms": ("other", other["zeroed"])})
    moved = cs.nbytes(*inputs, *cts) + 4 * len(live) * B * N * H * W
    info = (ctypes.c_int * 4)()
    _build.load_library().pdt_warp2d_bwd_kernel_info(int(with_sigma), info)
    return {"shape": list(shape), "with_sigma": with_sigma, "zoom_px": zoom, "ms": times,
            "bound_ms": cs.bound(moved, 100 * B * N * H * W)[0],
            "kernel_info": dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm"),
                                    info)),
            "grad_max_rel_diff": grad_rel, "bwd_repeat_bit_identical": repeat_identical}


def run_disp(libs, shape, dev):
    """The disp-head backward of both libraries at ``shape``."""
    logits, sigma, rows, mask = cs.seeded_head_inputs(shape, 3, dev)
    B, N, H, W = shape
    g = torch.randn((B, 1, H, W), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    res = {}
    for who, lib in libs.items():
        grads = {"d_logits": torch.empty_like(logits), "d_sigma": torch.empty_like(sigma),
                 "d_disp_rows": torch.empty_like(rows)}
        extra = ()
        if hasattr(lib, "pdt_disp_head_bwd_scratch_floats"):
            floats = lib.pdt_disp_head_bwd_scratch_floats(B, N, H, W)
            extra = (torch.empty(floats, device=dev) if floats else None,)
        bwd = lambda lib=lib, d=grads, extra=extra: call(
            lib, "pdt_disp_head_bwd", logits, sigma, rows, mask, g, *d.values(), *extra,
            B, N, H, W)
        bwd()
        torch.cuda.synchronize(dev)
        res[who] = dict(bwd=bwd, grads=grads, first={k: v.clone() for k, v in grads.items()})
    this, other = res["this"], res["other"]
    grad_rel = rel_diffs(this["grads"], other["grads"])
    this["bwd"]()
    torch.cuda.synchronize(dev)
    identical = all(torch.equal(this["first"][k], v) for k, v in this["grads"].items())
    if max(grad_rel.values()) > 1e-4 or not identical:
        raise AssertionError(f"disp head {shape}: grads {grad_rel}, repeat bit-identical "
                             f"{identical}")
    times = in_turns({"this_ms": ("this", this["bwd"]), "other_ms": ("other", other["bwd"])})
    moved = cs.nbytes(logits, sigma, rows, mask, g, logits, sigma, rows)
    info = (ctypes.c_int * 6)()
    _build.load_library().pdt_disp_head_bwd_kernel_info(N, W, info)
    return {"shape": list(shape), "ms": times,
            "bound_ms": cs.bound(moved, 30 * logits.numel())[0],
            "kernel_info": dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm",
                                     "smem_bytes", "planes_a_chunk"), info)),
            "grad_max_rel_diff": grad_rel, "bwd_repeat_bit_identical": identical}


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
    this, other = _build.load_library(), build_other(args.other)
    limit = shift_max(sweep_pad(stage1_config()))
    cases = {name: run_case({"this": this, "other": other["sweep"]}, shape, mix, with_disp,
                            limit, dev)
             for name, shape, mix, with_disp in CASES}
    warp_libs = {"this": this, "other": other["warp2d"]}
    for name, with_sigma, zoom in WARP_CASES:
        cases[name] = run_warp(warp_libs, cs.SWEEP_SHAPE, with_sigma, zoom, dev)
        torch.cuda.empty_cache()
    cases["disp_head_bwd"] = run_disp({"this": this, "other": other["disp_head"]},
                                      cs.SWEEP_SHAPE, dev)
    report = {"card": card, "other": str(args.other), "cases": cases}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    for name, c in cases.items():
        t = c["ms"]
        if "this_fwd" not in t:
            print(f"[compare] {name} {tuple(c['shape'])}: {json.dumps(t)} (bound "
                  f"{c['bound_ms']:.4f} ms; {json.dumps(c['kernel_info'])}) | {card}")
            continue
        print(f"[compare] {name} {tuple(c['shape'])}: forward this {t['this_fwd']} other "
              f"{t['other_fwd']} ms (bound {c['bound_ms']['fwd']:.4f}, MUFU floor "
              f"{c['mufu_floor_ms']['fwd']:.4f}); backward this {t['this_bwd']} other "
              f"{t['other_bwd']} ms (bound {c['bound_ms']['bwd']:.4f}, MUFU floor "
              f"{c['mufu_floor_ms']['bwd']:.4f}) | {card}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
