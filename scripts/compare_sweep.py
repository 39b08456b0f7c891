"""Time the plane-sweep, 2-D warp and disp-head backward kernels of this tree against another checkout's, on one card, in one process.

    python scripts/compare_sweep.py --other <checkout> [--out build/compare_sweep.json]
                                    [--only sweep,sweep_bf16,warp_bwd,warp_bwd_bf16,
                                            warp_fwd_bf16,disp_head,img_bwd]

Builds this tree's kernels (``planedepth_tpu_torch/ops/_build.py``) and each
of the other checkout's ``planedepth_tpu_torch/csrc/*.cu`` alone into a
library of its own (one nvcc each, started together).  ``--only`` runs the
named groups of cases (all by default).  The sweep's C entry points have this
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
bit-identical (the warp's repeat is reported).

The sweep backward's image-gradient instance (``pdt_plane_sweep_bwd_img``)
is timed the same way at stage 1's and stage 3's shapes and at (2, 63, 96,
2048), on ``chip_smoke.py:time_sweep_img``'s inputs, this tree's forward
with the automask and the centre disparity and seeded cotangents on every
output, beside this tree's head-only backward on the same operands; an
other checkout whose ``pdt_plane_sweep_kernel_info`` refuses the width (an
earlier kernel took W <= 1280 only) is reported as refusing it, and any
other failure stops the run.  Its d_src, d_tgt and head gradients are held
to the other's (1e-4 of their largest magnitude), its head gradients must
equal the head-only instance's bit for bit and its repeat run its first.
Both image-gradient backwards are also held to the plain version's
autograd on ``chip_smoke.py:phase_sweep_img``'s cases (the same inputs and
cotangents), each gradient's max error over its largest magnitude side by
side.

The 2-D warp's bf16 backward (``pdt_warp2d_bwd_bf16``) with and without
sigma at the mono step's shape, at a zoom of 200 px and at stage 3's
(4, 63, 384, 1280), on the warp inputs in bf16 (dx, dy, mask float32): this
tree's entry, which takes a scratch it clears itself, against the other's,
which may be the earlier one adding into two float32 buffers its caller
zeroes (timed alone, and with that zeroing), beside this tree's float32
instance, in turns; both held to the plain version's autograd (the heads'
gradients within one bf16 ulp plus 1e-4 of their largest magnitude), d_dx
and d_dy bit-identical between the two.

The sweep's bf16 instances (``pdt_plane_sweep_{fwd,bwd}_bf16``), with and
without the mixture, at stage 1's, stage 3's and FalNet's shapes on the
same operands in bf16 (shift and mask float32), the disp on and the
automask off as ``chip_smoke.py:time_sweep_bf16`` launches them: each
library's forward and backward in turns, other, this, this, other, beside
this tree's float32 instance on the float32 operands in the same turns.
Both libraries' bf16 outputs and head gradients are held to the plain
version as ``chip_smoke.py:HeldBf16`` holds them (the gradients anchored at
that library's rounded reconstruction), with seeded cotangents; whether
the two libraries' outputs are bit-identical is reported, and two backward
runs of this tree's must be.

The 2-D warp's bf16 forward (``pdt_warp2d_fwd_bf16``, group
``warp_fwd_bf16``) with and without sigma at the mono step's shape, at a
zoom of 200 px, at stage 3's (4, 63, 384, 1280) and on degenerate inputs
with planes of only degenerate samples: each library's entry alone (this
tree's packing src into its scratch; an earlier entry without a scratch
called as it was) into NaN-filled outputs, in turns beside this tree's
float32 instance; every output of this tree's the other's bit for bit,
none left NaN and within ``chip_smoke.py:HeldBf16``'s forward bound of the
plain version; the same, untimed, on ``chip_smoke.py``'s WARP_BF16_HELD and
WARP_FWD_EDGES cases.

Last, whatever the groups, ``cuobjdump -sass`` of both libraries: every
kernel by name (the anonymous namespace's hash dropped), the same but for
constant-bank offsets, differing, or only in one; and of the plane-sweep
and 2-D warp kernels each instance's instruction count, whether its
instructions are the other's but for constant-bank offsets (the parameter
lists differ), and
the instructions of its outermost loop (the sweep's loop over groups of
planes, every runtime branch included) over the planes a group and the
pixels a thread: the static SASS instructions a pixel-plane, whose issue
floor (one warp instruction a clock on each of an SM's four schedulers)
stands beside each bf16 case's bound.  Prints one JSON object, also
written to ``--out``, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs                                   # noqa: E402
from planedepth_tpu_torch.config import stage1_config     # noqa: E402
from planedepth_tpu_torch.ops import _build               # noqa: E402
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep_plain, shift_max  # noqa: E402
from planedepth_tpu_torch.ops.warp2d import warp2d_plain  # noqa: E402
from planedepth_tpu_torch.train.step import sweep_pad     # noqa: E402

# (name, shape, mixture, with_disp): the main paths' calls
CASES = (("stage1 mixture", cs.SWEEP_SHAPE, True, True),
         ("stage3 mixture", cs.SHIFT_SHAPE, True, True),
         ("falnet no mixture", cs.FALNET_SHAPE, False, False))
# (name, with_sigma, zoom in px at the edges): the mono step's warps, and a
# zoom whose taps cross far into the neighbouring blocks' bands
WARP_CASES = (("warp2d_bwd sigma", True, 30.0), ("warp2d_bwd nosigma", False, 30.0),
              ("warp2d_bwd sigma zoom 200", True, 200.0))
# the bf16 warp backward: (name, shape, with_sigma, zoom): the mono step's, a
# zoom whose taps cross far into the neighbouring blocks' bands, and stage
# 3's width
WARP_BF16_CASES = (("warp2d_bwd_bf16 sigma", cs.SWEEP_SHAPE, True, 30.0),
                   ("warp2d_bwd_bf16 nosigma", cs.SWEEP_SHAPE, False, 30.0),
                   ("warp2d_bwd_bf16 sigma zoom 200", cs.SWEEP_SHAPE, True, 200.0),
                   ("warp2d_bwd_bf16 sigma wide", cs.SHIFT_SHAPE, True, 30.0),
                   ("warp2d_bwd_bf16 nosigma wide", cs.SHIFT_SHAPE, False, 30.0))
# the bf16 warp forward: (name, shape, with_sigma, seeded_warp_inputs' options)
# in both modes: the mono step's, a zoom of 200 px, stage 3's width, and
# degenerate coordinates with planes and half-planes of only degenerate samples
WARP_FWD_BF16_CASES = tuple(
    (f"warp2d_fwd_bf16 {'sigma' if sig else 'nosigma'}{tag}", shape, sig, kw)
    for tag, shape, kw in (("", cs.SWEEP_SHAPE, {}), (" zoom 200", cs.SWEEP_SHAPE,
                                                      dict(zoom=200.0)),
                           (" wide", cs.SHIFT_SHAPE, {}),
                           (" degenerate", cs.SWEEP_SHAPE, dict(degenerate=True,
                                                               dead_plane=True)))
    for sig in (False, True))
# the other checkout's sources, each built alone: (key, csrc/<name>.cu)
OTHER_SOURCES = (("sweep", "plane_sweep"), ("warp2d", "warp2d"), ("disp_head", "disp_head"),
                 ("row_shift", "row_shift"), ("head_epilogue", "head_epilogue"))
# the groups of cases --only may name
GROUPS = ("sweep", "sweep_bf16", "warp_bwd", "warp_bwd_bf16", "warp_fwd_bf16", "disp_head",
          "img_bwd")
# the image-gradient backward: stage 1, stage 3, and a row wider than 1280
IMG_CASES = (("img_bwd stage1", cs.SWEEP_SHAPE), ("img_bwd stage3", cs.SHIFT_SHAPE),
             ("img_bwd wide", (2, 63, 96, 2048)))
IMG_NAMES = ("d_src", "d_tgt", "d_logits", "d_sigma", "d_shift")
# the bf16 instances: (name, shape, mixture), the disp on, the automask off
BF16_CASES = (("stage1 mixture bf16", cs.SWEEP_SHAPE, True),
              ("stage3 mixture bf16", cs.SHIFT_SHAPE, True),
              ("falnet no mixture bf16", cs.FALNET_SHAPE, False))
# planes a group of the sweep's forward and backward (csrc/plane_sweep.cu:
# kFwdGroup, kBwdGroup)
GROUP = {"fwd": 4, "bwd": 2}
# thread-instructions a second: one warp instruction a clock on each of the
# four schedulers of the H100 SXM's 132 SMs at its 1.98 GHz boost clock
INSTR_PER_S = 132 * 4 * 32 * 1.98e9


def build_other(checkout: Path) -> dict:
    """Each of the other checkout's OTHER_SOURCES alone as a shared library:
    {"sweep", "warp2d", "disp_head", "row_shift", "head_epilogue"}."""
    out_dir = REPO / "build" / "compare_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, name in OTHER_SOURCES:
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
    lib.pdt_plane_sweep_fwd_bf16.argtypes = [p] * 11 + [i, i, i, i, f, i, i, i, p]
    lib.pdt_plane_sweep_fwd_bf16.restype = i
    lib.pdt_plane_sweep_bwd_bf16.argtypes = [p] * 14 + [i, i, i, i, f, i, i, p]
    lib.pdt_plane_sweep_bwd_bf16.restype = i
    lib.pdt_plane_sweep_bwd_img.argtypes = [p] * 17 + [i, i, i, i, f, i, p]
    lib.pdt_plane_sweep_bwd_img.restype = i
    lib.pdt_plane_sweep_kernel_info.argtypes = [i, i, i, i, i, p]
    lib.pdt_plane_sweep_kernel_info.restype = i
    lib = libs["warp2d"]
    lib.pdt_warp2d_bwd.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.pdt_warp2d_bwd.restype = i
    # an earlier bf16 entry adds into two float32 buffers that its caller
    # zeroes (acc_logits, acc_sigma before d_logits); this tree's takes a
    # scratch it clears itself, after d_dy
    scratch = hasattr(lib, "pdt_warp2d_bwd_bf16_scratch_bytes")
    lib.pdt_warp2d_bwd_bf16.argtypes = [p] * (14 if scratch else 15) + [i] * 5 + [p]
    lib.pdt_warp2d_bwd_bf16.restype = i
    lib.pdt_warp2d_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.pdt_warp2d_fwd.restype = i
    # an earlier bf16 forward takes no scratch; this tree's packs src into
    # one, after sigma_out
    scratch = hasattr(lib, "pdt_warp2d_fwd_bf16_scratch_bytes")
    lib.pdt_warp2d_fwd_bf16.argtypes = [p] * (10 if scratch else 9) + [i] * 5 + [p]
    lib.pdt_warp2d_fwd_bf16.restype = i
    if scratch:
        lib.pdt_warp2d_fwd_bf16_scratch_bytes.argtypes = [i] * 3
        lib.pdt_warp2d_fwd_bf16_scratch_bytes.restype = ctypes.c_longlong
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


def bf16_excess(outs, grads, inputs16, cts, pad):
    """A library's bf16 sweep outputs (rgb, nll, disp) and head gradients
    against the plain version, as ``chip_smoke.py:HeldBf16`` bounds them:
    each one's worst excess over its bound (<= 0: within it); the gradients
    against the plain version anchored at the library's rounded rgb."""
    ops = [None if t is None else t.detach().requires_grad_(i in (2, 3, 4))
           for i, t in enumerate(inputs16)]
    wrt = [t for t in ops[2:5] if t is not None]
    excess = {}
    with torch.no_grad():
        plain = plane_sweep_plain(*ops, pad, False, True)
    for name, a, b in zip(("rgb", "nll", "disp"), outs, plain):
        err = (a.float() - b.float()).abs()
        tol = cs.TOL["atol"] + cs.TOL["rtol"] * b.float().abs()
        ulp = cs.bf16_ulp(b) if a.dtype == cs.BF16 else 0.0
        excess[name] = float((err - ulp - tol).max())
    del plain
    anchored = plane_sweep_plain(*ops, pad, False, True, rounded_rgb=outs[0])
    want = torch.autograd.grad(anchored, wrt, cts)
    del anchored
    names = ("d_logits", "d_sigma", "d_shift") if len(wrt) == 3 else ("d_logits", "d_shift")
    for name, a, b in zip(names, [g for g in grads if g is not None], want):
        err = (a.float() - b.float()).abs()
        ulp = cs.bf16_ulp(b) if a.dtype == cs.BF16 else 0.0
        excess[name] = float((err - ulp).max()) - cs.GRAD_TOL * float(b.float().abs().max())
    return excess


def run_case_bf16(libs, shape, mix, limit, pad, loops, dev):
    """The bf16 sweep instances of both libraries at ``shape``, beside this
    tree's float32 instance on the same values; ``loops``: the static SASS
    instructions a pixel-plane of each library's instances."""
    inputs32 = [t.detach() for t in cs.seeded_sweep_inputs(shape, 1, dev)]
    if not mix:
        inputs32[3] = None
    inputs16 = [None if t is None else t.detach() for t in cs.as_bf16(inputs32, (4, 5))]
    B, N, H, W = shape
    new = lambda *size: torch.empty(size, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    cts = (torch.randn((B, 3, H, W), generator=g, device=dev).to(cs.BF16),
           torch.randn((B, H, W), generator=g, device=dev),
           torch.randn((B, H, W), generator=g, device=dev))

    def entries(lib, suffix, ops, g_rgb):
        logits, shift = ops[2], ops[4]
        outs = (torch.empty((B, 3, H, W), dtype=logits.dtype, device=dev), new(B, H, W),
                new(B, H, W))
        stats = new(B, 7, H, W)
        grads = (torch.empty_like(logits), torch.empty_like(logits) if mix else None,
                 torch.empty_like(shift))
        fwd = lambda: call(lib, f"pdt_plane_sweep_fwd{suffix}", *ops, outs[0], outs[1], None,
                           outs[2], stats, B, N, H, W, limit, 0, 1, int(mix))
        bwd = lambda: call(lib, f"pdt_plane_sweep_bwd{suffix}", *ops, stats, outs[0], g_rgb,
                           cts[1], cts[2], *grads, B, N, H, W, limit, 1, int(mix))
        fwd()
        bwd()
        torch.cuda.synchronize(dev)
        return dict(fwd=fwd, bwd=bwd, outs=outs, grads=grads)

    res = {who: entries(lib, "_bf16", inputs16, cts[0]) for who, lib in libs.items()}
    f32 = entries(libs["this"], "", inputs32, cts[0].float())
    excess = {who: bf16_excess(r["outs"], r["grads"], inputs16, cts, pad)
              for who, r in res.items()}
    this, other = res["this"], res["other"]
    same = all(torch.equal(a, b) for a, b in zip((*this["outs"], *this["grads"]),
                                                 (*other["outs"], *other["grads"]))
               if a is not None)
    first = [t.clone() for t in this["grads"] if t is not None]
    this["bwd"]()
    torch.cuda.synchronize(dev)
    identical = all(torch.equal(a, b) for a, b in
                    zip(first, [t for t in this["grads"] if t is not None]))
    worst = max(max(e.values()) for e in excess.values())
    if worst > 0 or not identical:
        raise AssertionError(f"bf16 {shape} mixture={mix}: excess over the bounds {excess}, "
                             f"repeat bit-identical {identical}")
    fns = {f"{who}_{d}": (who, r[d]) for who, r in res.items() for d in ("fwd", "bwd")}
    fns.update({f"this_f32_{d}": ("this", f32[d]) for d in ("fwd", "bwd")})
    times = in_turns(fns)
    fwd_bytes, bwd_bytes = cs.sweep_bytes(inputs16, True)
    n = inputs16[2].numel()
    px = 1 if W <= 640 else 2 if W <= 1280 else 4
    issue = {}
    for who in libs:
        for d in ("fwd", "bwd"):
            per = loops[who].get(f"{d}<{px},{int(mix)},bf16>")
            issue[f"{who}_{d}"] = (None if per is None else
                                   {"sass_per_pixel_plane": per,
                                    "issue_floor_ms": n * per / INSTR_PER_S * 1e3})
    return {"shape": list(shape), "mixture": mix, "with_disp": True, "ms": times,
            "bytes": {"fwd": fwd_bytes, "bwd": bwd_bytes},
            "bound_ms": {"fwd": cs.bound(fwd_bytes, 60 * n)[0],
                         "bwd": cs.bound(bwd_bytes, 100 * n)[0]},
            "mufu_floor_ms": {d: cs.mufu_floor_ms(n, cs.sweep_mufu(mix, True, d))
                              for d in ("fwd", "bwd")},
            "issue": issue,
            "kernel_info": {d: cs.sweep_kernel_info(d == "bwd", mix, N, W, bf16=True)
                            for d in ("fwd", "bwd")},
            "float32_kernel_info": {d: cs.sweep_kernel_info(d == "bwd", mix, N, W)
                                    for d in ("fwd", "bwd")},
            "excess_over_bounds": excess, "bit_identical_to_other": same,
            "bwd_repeat_bit_identical": identical}


def rel_diffs(this, other):
    """Max |a - b| over max |b| of each named gradient."""
    return {k: (a - other[k]).abs().max().item() / max(other[k].abs().max().item(), 1e-30)
            for k, a in this.items() if a is not None}


def in_turns(fns, order=("other", "this")):
    """CUDA-event medians of each of ``fns`` (name -> (who, fn)), in turns
    over ``order`` and back: other, this, this, other."""
    times = {name: [] for name in fns}
    for turn in (*order, *reversed(order)):
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


def run_warp_bf16(libs, shape, with_sigma, zoom, dev):
    """The bf16 warp backward of both libraries at ``shape`` beside this
    tree's float32 instance on the same values, each entry alone in turns
    (an earlier bf16 entry's float32 sums zeroed once, and also timed with
    the zeroing its wrapper runs; this tree's entry clears its own scratch);
    both held to the plain version's autograd as ``chip_smoke.py:HeldBf16``
    bounds the heads' gradients (one bf16 ulp plus 1e-4 of the largest
    magnitude), d_dx and d_dy compared bit for bit."""
    inputs32 = [None if t is None else t.detach()
                for t in cs.seeded_warp_inputs(shape, 20, dev, zoom=zoom)]
    if not with_sigma:
        inputs32[2] = None
    ins16 = [None if t is None else t.detach() for t in cs.as_bf16(inputs32, (3, 4, 5))]
    B, N, H, W = shape
    g = torch.Generator(device=dev).manual_seed(2)
    cts32 = [torch.randn((B, N, 3, H, W), generator=g, device=dev),
             torch.randn(shape, generator=g, device=dev),
             torch.randn(shape, generator=g, device=dev) if with_sigma else None]
    cts16 = [None if c is None else c.to(cs.BF16) for c in cts32]
    fns, grads = {}, {}
    for who, lib in libs.items():
        heads = [torch.empty_like(ins16[1]), torch.empty_like(ins16[1]) if with_sigma else None]
        d_xy = [torch.empty(shape, device=dev), torch.empty(shape, device=dev)]
        if hasattr(lib, "pdt_warp2d_bwd_bf16_scratch_bytes"):
            scratch = torch.empty(lib.pdt_warp2d_bwd_bf16_scratch_bytes(B, N, H, W,
                                                                        int(with_sigma)),
                                  dtype=torch.uint8, device=dev)
            fns[f"{who}_ms"] = (who, lambda lib=lib, h=heads, d=d_xy, sc=scratch: call(
                lib, "pdt_warp2d_bwd_bf16", *ins16, *cts16, *h, *d, sc, B, N, H, W,
                int(with_sigma)))
        else:
            acc = [torch.zeros(shape, device=dev),
                   torch.zeros(shape, device=dev) if with_sigma else None]
            alone = lambda lib=lib, h=heads, d=d_xy, acc=acc: call(
                lib, "pdt_warp2d_bwd_bf16", *ins16, *cts16, *acc, *h, *d, B, N, H, W,
                int(with_sigma))

            def zeroed(alone=alone, acc=acc):
                for a in acc:
                    if a is not None:
                        a.zero_()
                alone()
            fns[f"{who}_ms"] = (who, alone)
            fns[f"{who}_with_zeroing_ms"] = (who, zeroed)
        (fns.get(f"{who}_with_zeroing_ms") or fns[f"{who}_ms"])[1]()
        grads[who] = heads + d_xy
    f32 = [torch.zeros(shape, device=dev), torch.zeros(shape, device=dev) if with_sigma else None,
           torch.empty(shape, device=dev), torch.empty(shape, device=dev)]
    fns["this_float32_ms"] = ("this", lambda: call(libs["this"], "pdt_warp2d_bwd", *inputs32,
                                                   *cts32, *f32, B, N, H, W, int(with_sigma)))
    torch.cuda.synchronize(dev)
    ops = [None if t is None else t.detach().requires_grad_(i in (1, 2, 3, 4))
           for i, t in enumerate(ins16)]
    wrt = [t for t in ops[1:5] if t is not None]
    out = warp2d_plain(*ops)
    want = torch.autograd.grad(out, wrt, [c for c in cts16 if c is not None])
    del out
    names = ("d_logits", "d_sigma", "d_dx", "d_dy")
    excess = {}
    for who, got in grads.items():
        got = [x for x in got if x is not None]
        excess[who] = {}
        for name, a, b in zip([n for n, x in zip(names, grads[who]) if x is not None], got,
                              want):
            err = (a.float() - b.float()).abs()
            ulp = cs.bf16_ulp(b) if a.dtype == cs.BF16 else 0.0
            excess[who][name] = (float((err - ulp).max())
                                 - cs.GRAD_TOL * float(b.float().abs().max()))
    d_xy_same = all(torch.equal(a, b) for a, b in zip(grads["this"][2:], grads["other"][2:]))
    worst = max(max(e.values()) for e in excess.values())
    if worst > 0 or not d_xy_same:
        raise AssertionError(f"bf16 warp {shape} sigma={with_sigma}: excess over the bounds "
                             f"{excess}, d_dx/d_dy bit-identical {d_xy_same}")
    times = in_turns(fns)
    moved = cs.nbytes(*ins16, *cts16, *wrt)
    info = (ctypes.c_int * 4)()
    _build.load_library().pdt_warp2d_bwd_kernel_info_bf16(int(with_sigma), info)
    return {"shape": list(shape), "with_sigma": with_sigma, "zoom_px": zoom, "ms": times,
            "bytes": moved, "bound_ms": cs.bound(moved, 100 * B * N * H * W)[0],
            "kernel_info": dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm"),
                                    info)),
            "excess_over_bounds": excess, "d_dx_d_dy_bit_identical_to_other": d_xy_same}


def warp_fwd_bf16_entry(lib, ins16, outs, shape, with_sigma):
    """A call of ``lib``'s bf16 warp forward into ``outs``, with the scratch
    its entry takes where it takes one."""
    B, N, H, W = shape
    scratch = ()
    if hasattr(lib, "pdt_warp2d_fwd_bf16_scratch_bytes"):
        scratch = (torch.empty(lib.pdt_warp2d_fwd_bf16_scratch_bytes(B, H, W),
                               dtype=torch.uint8, device=ins16[3].device),)
    return lambda: call(lib, "pdt_warp2d_fwd_bf16", *ins16, *outs, *scratch, B, N, H, W,
                        int(with_sigma))


def bits_equal(a, b):
    """Whether two bf16 tensors hold the same bits (NaN included)."""
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def warp_fwd_bf16_outputs(shape, with_sigma, dev):
    B, N, H, W = shape
    new = lambda *size: torch.full(size, float("nan"), dtype=cs.BF16, device=dev)  # noqa: E731
    return [new(B, N, 3, H, W), new(B, N, H, W), new(B, N, H, W) if with_sigma else None]


def run_warp_fwd_bf16(libs, shape, with_sigma, kw, dev, timed=True):
    """The bf16 warp forward of both libraries at ``shape`` on
    ``chip_smoke.py``'s warp inputs in bf16 (dx, dy, mask float32), into
    NaN-filled outputs: whether every output of this tree's equals the
    other's bit for bit and none is left NaN, this tree's worst excess over
    ``chip_smoke.py:HeldBf16``'s forward bound against the plain version;
    with ``timed``, each entry alone (this tree's with its packing) in
    turns beside this tree's float32 instance on the same values."""
    inputs32 = [None if t is None else t.detach()
                for t in cs.seeded_warp_inputs(shape, 20, dev, **kw)]
    if not with_sigma:
        inputs32[2] = None
    ins16 = [None if t is None else t.detach() for t in cs.as_bf16(inputs32, (3, 4, 5))]
    B, N, H, W = shape
    fns, outs = {}, {}
    for who, lib in libs.items():
        outs[who] = warp_fwd_bf16_outputs(shape, with_sigma, dev)
        fns[f"{who}_ms"] = (who, warp_fwd_bf16_entry(lib, ins16, outs[who], shape, with_sigma))
        fns[f"{who}_ms"][1]()
    torch.cuda.synchronize(dev)
    live = lambda o: [t for t in o if t is not None]                      # noqa: E731
    identical = all(bits_equal(a, b) for a, b in zip(live(outs["this"]), live(outs["other"])))
    written = not any(bool(torch.isnan(t).any()) for t in live(outs["this"]))
    excess = 0.0
    with torch.no_grad():
        for a, b in zip(live(outs["this"]), warp2d_plain(*ins16)):
            err = (a.float() - b.float()).abs()
            tol = cs.TOL["atol"] + cs.TOL["rtol"] * b.float().abs()
            excess = max(excess, float((err - cs.bf16_ulp(b) - tol).max()))
    if not (identical and written) or excess > 0:
        raise AssertionError(f"bf16 warp forward {shape} sigma={with_sigma} {kw}: bit-identical "
                             f"{identical}, every element written {written}, excess over "
                             f"the bound {excess:.3e}")
    res = {"shape": list(shape), "with_sigma": with_sigma, "inputs": kw,
           "bit_identical_to_other": identical, "excess_over_bound": excess}
    if not timed:
        return res
    f32 = [torch.empty((B, N, 3, H, W), device=dev), torch.empty(shape, device=dev),
           torch.empty(shape, device=dev) if with_sigma else None]
    fns["this_float32_ms"] = ("this", lambda: call(libs["this"], "pdt_warp2d_fwd", *inputs32,
                                                   *f32, B, N, H, W, int(with_sigma)))
    times = in_turns(fns)
    moved = cs.nbytes(*ins16, *live(outs["this"]))
    info = (ctypes.c_int * 4)()
    _build.load_library().pdt_warp2d_fwd_kernel_info_bf16(int(with_sigma), info)
    res.update(ms=times, bytes=moved, bound_ms=cs.bound(moved, 60 * B * N * H * W)[0],
               kernel_info=dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm"),
                                    info)))
    return res


def kernel_sass(lib_path) -> dict:
    """Every kernel of a library as ``cuobjdump -sass`` prints it: mangled
    name -> (address, instruction text) pairs, constant-bank offsets
    blanked; the name's anonymous namespace (a hash of the source's path)
    dropped."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN",
                         line.split("Function :", 1)[1].strip())
            funcs[cur] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur and ins:
            funcs[cur].append((int(ins.group(1), 16),
                               re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][.]", ins.group(2))))
    return funcs


def compare_all_sass(this, other) -> dict:
    """Every kernel of this library and of the other's (:func:`kernel_sass`
    of each) by mangled name: whether the two compile to the same SASS but
    for constant-bank offsets, and the kernels only one of them has."""
    texts = lambda code: [ins for _, ins in code]                       # noqa: E731
    both = sorted(set(this) & set(other))
    return {"same": [k for k in both if texts(this[k]) == texts(other[k])],
            "differing": [k for k in both if texts(this[k]) != texts(other[k])],
            "only_this": sorted(set(this) - set(other)),
            "only_other": sorted(set(other) - set(this))}


def sweep_info(lib, N, W, image_grads):
    """``pdt_plane_sweep_kernel_info`` of ``lib``'s mixture backward (its
    image-gradient instance with ``image_grads``), None where it refuses."""
    out = (ctypes.c_int * 5)()
    if lib.pdt_plane_sweep_kernel_info(1, 1, int(image_grads), N, W, out) != 0:
        return None
    return dict(zip(("registers", "spill_bytes", "threads", "blocks_per_sm", "smem_bytes"),
                    out))


def sweep_fwd_stats(this, src, tgt, logits, sigma, shift, mask, with_disp, limit):
    """This tree's mixture forward with the automask: (rgb, nll, nll_auto,
    disp or None, stats)."""
    B, N, H, W = logits.shape
    new = lambda *size: torch.empty(size, device=logits.device)
    outs = (new(B, 3, H, W), new(B, H, W), new(B, H, W), new(B, H, W) if with_disp else None,
            new(B, 7 if with_disp else 4, H, W))
    call(this, "pdt_plane_sweep_fwd", src, tgt, logits, sigma, shift, mask, *outs,
         B, N, H, W, limit, 1, int(with_disp), 1)
    return outs


def run_img(libs, shape, limit, dev):
    """The image-gradient backward of each of ``libs`` (name -> library, in
    turn order; "this" among them) that takes the width, and this tree's
    head-only backward at ``shape``, on ``chip_smoke.py:time_sweep_img``'s
    operands."""
    src, tgt, logits, sigma, shift, mask = (t.detach() for t in
                                            cs.image_grad_inputs(shape, 2, dev))
    B, N, H, W = shape
    this = libs["this"]
    rgb, nll, nll_auto, disp, stats = sweep_fwd_stats(this, src, tgt, logits, sigma, shift,
                                                      mask, True, limit)
    g = torch.Generator(device=dev).manual_seed(3)
    g_rgb, g_nll, g_auto, g_disp = (torch.randn(x.shape, generator=g, device=dev)
                                    for x in (rgb, nll, nll_auto, disp))
    common = (src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll)
    info = {who: sweep_info(lib, N, W, True) for who, lib in libs.items()}
    if info["this"] is None:
        raise AssertionError(f"this tree's image-gradient backward refuses {shape}")
    res = {}
    for who, lib in libs.items():
        if info[who] is None:
            continue
        d = {k: torch.empty_like(x) for k, x in zip(IMG_NAMES, (src, tgt, logits, sigma, shift))}
        fn = lambda lib=lib, d=d: call(lib, "pdt_plane_sweep_bwd_img", *common, g_auto,
                                       g_disp, *d.values(), B, N, H, W, limit, 1)
        fn()
        torch.cuda.synchronize(dev)
        res[who] = dict(fn=fn, d=d, first={k: v.clone() for k, v in d.items()})
    heads = {k: torch.empty_like(x) for k, x in zip(IMG_NAMES[2:], (logits, sigma, shift))}
    head_only = lambda: call(this, "pdt_plane_sweep_bwd", *common, g_disp, *heads.values(),
                             B, N, H, W, limit, 1, 1)
    head_only()
    mine = res["this"]
    mine["fn"]()
    torch.cuda.synchronize(dev)
    repeat = all(torch.equal(mine["first"][k], v) for k, v in mine["d"].items())
    heads_identical = all(torch.equal(mine["first"][k], v) for k, v in heads.items())
    grad_rel = {who: rel_diffs(mine["first"], r["first"]) for who, r in res.items()
                if who != "this"}
    worst = max((max(v.values()) for v in grad_rel.values()), default=0.0)
    if worst > 1e-4 or not repeat or not heads_identical:
        raise AssertionError(f"image-gradient backward {shape}: grads {grad_rel}, repeat "
                             f"bit-identical {repeat}, heads as the head-only instance's "
                             f"{heads_identical}")
    fns = {f"{who}_ms": (who, r["fn"]) for who, r in res.items()}
    fns["head_only_ms"] = ("this", head_only)
    times = in_turns(fns, tuple(res))
    row = B * H * W * 4
    inputs = [src, tgt, logits, sigma, shift, mask]
    moved = cs.sweep_bounds(inputs)[1][0] + row + cs.nbytes(src, tgt)
    return {"shape": list(shape), "ms": times,
            "refused": [who for who, i in info.items() if i is None],
            "bound_ms": cs.bound(moved, 120 * logits.numel())[0], "bytes": moved,
            "mufu_floor_ms": cs.mufu_floor_ms(logits.numel(),
                                              cs.sweep_mufu(True, True, "bwd", True)),
            "kernel_info": info, "head_only_kernel_info": sweep_info(this, N, W, False),
            "grad_max_rel_diff": grad_rel, "bwd_repeat_bit_identical": repeat,
            "head_grads_bit_identical": heads_identical}


def img_twin_errors(libs, shape, seed, ct_seed, with_disp, pad, dev):
    """Each of ``libs``' image-gradient backward against the plain
    version's autograd on one of phase 5b's cases (its inputs, and its
    cotangents on every output, as ``chip_smoke.py:Held`` seeds them), on
    this tree's forward statistics: each gradient's max abs error over its
    largest magnitude; None for a library that refuses the width."""
    inputs = cs.image_grad_inputs(shape, seed, dev)
    outs = plane_sweep_plain(*inputs, pad, True, with_disp)
    g = torch.Generator(device=dev).manual_seed(ct_seed)
    cts = [torch.randn(o.shape, generator=g, device=dev) for o in outs]
    want = dict(zip(IMG_NAMES, torch.autograd.grad(outs, inputs[:5], cts)))
    del outs
    ops = [t.detach() for t in inputs]
    B, N, H, W = shape
    limit = shift_max(pad)
    rgb, _, _, _, stats = sweep_fwd_stats(libs["this"], *ops, with_disp, limit)
    g_disp = cts[3] if with_disp else None
    errs = {}
    for who, lib in libs.items():
        if sweep_info(lib, N, W, True) is None:
            errs[who] = None
            continue
        # the twin's gradients may be strided: the kernel writes contiguous ones
        d = {k: torch.empty_like(x) for k, x in zip(IMG_NAMES, ops[:5])}
        call(lib, "pdt_plane_sweep_bwd_img", *ops, stats, rgb, *cts[:3], g_disp, *d.values(),
             B, N, H, W, limit, int(with_disp))
        torch.cuda.synchronize(dev)
        errs[who] = rel_diffs(d, want)
    return errs


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


def sweep_sass(funcs) -> dict:
    """The plane-sweep and 2-D warp kernels of :func:`kernel_sass`'s
    ``funcs``, keyed "fwd|bwd|bwd_img<PX,MIX>" and "warp_fwd|warp_bwd<SIGMA>";
    the bf16 instances (a later source's element type) with ",bf16" in the
    key.  An earlier source's sweep_bwd_kernel<PX, MIX, IMG> holds both
    backwards."""
    out = {}
    for name, code in funcs.items():
        m = re.search(r"(sweep|warp2d)_(fwd|bwd|bwd_img)_kernelI((?:L[ib]\d+E)+)"
                      r"(f|13__nv_bfloat16)?E", name)
        if not m:
            continue
        args = [int(a) for a in re.findall(r"L[ib](\d+)E", m.group(3))]
        # the float instances keep the names of a source without the element
        # type; the bf16 ones are new
        bf16 = ",bf16" if m.group(4) == "13__nv_bfloat16" else ""
        if m.group(1) == "warp2d":
            key = f"warp_{m.group(2)}<{args[0]}{bf16}>"
        else:
            kind = "bwd_img" if m.group(2) == "bwd_img" or args[2:] == [1] else m.group(2)
            key = f"{kind}<{args[0]},{args[1] if len(args) > 1 else 1}{bf16}>"
        out[key] = code
    return out


def loop_per_pixel_plane(key, code):
    """The static instructions of a sweep instance's loop over groups of
    planes a pixel-plane: the instructions on a cycle through the head of
    its longest backward branch (the loop's body with its out-of-line
    blocks and inner loops, each once, both arms of every runtime branch)
    over the pixel-planes that body computes.  A bf16 instance's ring taps
    are its only 16-bit shared loads, 6 a pixel-plane with the mixture and
    3 without (the two taps and the centre sample of each row), so they
    count its pixel-plane bodies, which a loop the compiler versions holds
    twice; a float instance's are taken as its planes a group times pixels
    a thread.  None for other kernels or without a loop."""
    m = re.match(r"(fwd|bwd)<(\d+),(\d)(,bf16)?>", key)
    if not m or not code:
        return None
    at = {a: i for i, (a, _) in enumerate(code)}
    succ, back = [[] for _ in code], []
    for i, (a, ins) in enumerate(code):
        b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)\s*$", ins)
        if b and int(b.group(1), 16) in at:
            succ[i].append(at[int(b.group(1), 16)])
            if int(b.group(1), 16) < a:
                back.append((i - at[int(b.group(1), 16)], at[int(b.group(1), 16)]))
        ends = (b or re.match(r"(EXIT|RET)\b", ins)) and not ins.startswith("@")
        if not ends and i + 1 < len(code):
            succ[i].append(i + 1)
    if not back:
        return None
    head = max(back)[1]
    pred = [[] for _ in code]
    for i, nxt in enumerate(succ):
        for j in nxt:
            pred[j].append(i)

    def reach(edges):
        seen, todo = {head}, [head]
        while todo:
            for j in edges[todo.pop()]:
                if j not in seen:
                    seen.add(j)
                    todo.append(j)
        return seen
    body = reach(succ) & reach(pred)
    if m.group(4):
        taps = sum(1 for i in body if "LDS.U16" in code[i][1])
        bodies = taps / (6 if m.group(3) == "1" else 3)
    else:
        bodies = GROUP[m.group(1)] * int(m.group(2))
    return len(body) / bodies if bodies else None


def compare_sass(this, other) -> dict:
    """Each plane-sweep and 2-D warp kernel instance of this library and of
    the other's (:func:`kernel_sass` of each): its instruction counts and
    whether the two are the same but for constant-bank offsets."""
    this, other = sweep_sass(this), sweep_sass(other)
    texts = lambda code: None if code is None else [ins for _, ins in code]   # noqa: E731
    loop = lambda k, code: None if code is None else loop_per_pixel_plane(k, code)  # noqa: E731
    return {k: {"this": len(this.get(k, ())), "other": len(other.get(k, ())),
                "same": texts(this.get(k)) == texts(other.get(k)),
                "loop_per_pixel_plane": {"this": loop(k, this.get(k)),
                                         "other": loop(k, other.get(k))}}
            for k in sorted(set(this) | set(other))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", default=str(REPO / "build" / "compare_sweep.json"))
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated groups of cases to run, of {', '.join(GROUPS)} "
                         "(default all; the SASS comparisons always run)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        raise SystemExit(f"compare_sweep: unknown groups {sorted(only - set(GROUPS))}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_sweep: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    this = _build.load_library()
    other = build_other(args.other)
    pad = sweep_pad(stage1_config())
    limit = shift_max(pad)
    others = {name: REPO / "build" / "compare_sweep" / f"libother_{name}.so"
              for _, name in OTHER_SOURCES}
    this_sass, other_sass = kernel_sass(_build.library_path()), {}
    for path in others.values():
        other_sass.update(kernel_sass(path))
    sass = compare_sass(this_sass, other_sass)
    all_sass = compare_all_sass(this_sass, other_sass)
    loops = {who: {k: v["loop_per_pixel_plane"][who] for k, v in sass.items()}
             for who in ("this", "other")}
    cases = {}
    if "sweep" in only:
        for name, shape, mix, with_disp in CASES:
            cases[name] = run_case({"this": this, "other": other["sweep"]}, shape, mix,
                                   with_disp, limit, dev)
    if "sweep_bf16" in only:
        for name, shape, mix in BF16_CASES:
            cases[name] = run_case_bf16({"other": other["sweep"], "this": this}, shape, mix,
                                        limit, pad, loops, dev)
            torch.cuda.empty_cache()
    warp_libs = {"this": this, "other": other["warp2d"]}
    if "warp_bwd" in only:
        for name, with_sigma, zoom in WARP_CASES:
            cases[name] = run_warp(warp_libs, cs.SWEEP_SHAPE, with_sigma, zoom, dev)
            torch.cuda.empty_cache()
    if "warp_bwd_bf16" in only:
        for name, shape, with_sigma, zoom in WARP_BF16_CASES:
            cases[name] = run_warp_bf16({"other": other["warp2d"], "this": this}, shape,
                                        with_sigma, zoom, dev)
            torch.cuda.empty_cache()
    fwd_edges = []
    if "warp_fwd_bf16" in only:
        for name, shape, with_sigma, kw in WARP_FWD_BF16_CASES:
            cases[name] = run_warp_fwd_bf16({"other": other["warp2d"], "this": this}, shape,
                                            with_sigma, kw, dev)
            torch.cuda.empty_cache()
        # bit-identity alone on chip_smoke.py's held edge cases
        for shape, kw in cs.WARP_BF16_HELD + cs.WARP_FWD_EDGES:
            for with_sigma in (True, False):
                fwd_edges.append(run_warp_fwd_bf16(warp_libs, shape, with_sigma, kw, dev,
                                                   timed=False))
    if "disp_head" in only:
        cases["disp_head_bwd"] = run_disp({"this": this, "other": other["disp_head"]},
                                          cs.SWEEP_SHAPE, dev)
    held = []
    if "img_bwd" in only:
        img_libs = {"other": other["sweep"], "this": this}
        for name, shape in IMG_CASES:
            cases[name] = run_img(img_libs, shape, limit, dev)
            torch.cuda.empty_cache()
        for shape, seed, ct_seed, with_disp in cs.SWEEP_IMG_HELD:
            held.append({"shape": list(shape), "with_disp": with_disp,
                         "rel_err": img_twin_errors(img_libs, shape, seed, ct_seed, with_disp,
                                                    pad, dev)})
            torch.cuda.empty_cache()
    report = {"card": card, "other": str(args.other), "cases": cases,
              "img_bwd_vs_plain": held, "warp_fwd_bf16_edges": fwd_edges, "sass": sass,
              "all_sass": all_sass}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    for name, c in cases.items():
        t = c["ms"]
        if "this_f32_fwd" in t:
            for d in ("fwd", "bwd"):
                issue = {who: f["issue_floor_ms"] for who, f in c["issue"].items()
                         if who.endswith(d) and f}
                print(f"[compare] {name} {tuple(c['shape'])} {d}: bf16 this {t[f'this_{d}']} "
                      f"other {t[f'other_{d}']} ms, float32 this {t[f'this_f32_{d}']} ms "
                      f"(bound {c['bound_ms'][d]:.4f} of {c['bytes'][d] / 1e6:.0f} MB, MUFU "
                      f"floor {c['mufu_floor_ms'][d]:.4f}, issue floor {json.dumps(issue)}; "
                      f"{json.dumps(c['kernel_info'][d])}) | {card}")
            print(f"[compare] {name}: excess over HeldBf16's bounds "
                  f"{json.dumps(c['excess_over_bounds'])}, bit-identical to the other's "
                  f"{c['bit_identical_to_other']} | {card}")
            continue
        if "this_fwd" not in t:
            refused = (f"; refused by {json.dumps(c['refused'])}" if c.get("refused") else "")
            ident = (f"; bit-identical to the other's {c['bit_identical_to_other']}, excess "
                     f"over HeldBf16's bound {c['excess_over_bound']:.3e}"
                     if "bit_identical_to_other" in c else "")
            print(f"[compare] {name} {tuple(c['shape'])}: {json.dumps(t)} (bound "
                  f"{c['bound_ms']:.4f} ms; {json.dumps(c['kernel_info'])}{refused}{ident}) | "
                  f"{card}")
            continue
        print(f"[compare] {name} {tuple(c['shape'])}: forward this {t['this_fwd']} other "
              f"{t['other_fwd']} ms (bound {c['bound_ms']['fwd']:.4f}, MUFU floor "
              f"{c['mufu_floor_ms']['fwd']:.4f}); backward this {t['this_bwd']} other "
              f"{t['other_bwd']} ms (bound {c['bound_ms']['bwd']:.4f}, MUFU floor "
              f"{c['mufu_floor_ms']['bwd']:.4f}) | {card}")
    for h in held:
        print(f"[compare] img_bwd vs plain {tuple(h['shape'])} disp={h['with_disp']}: "
              f"{json.dumps(h['rel_err'])} | {card}")
    if fwd_edges:
        print(f"[compare] warp2d_fwd_bf16 bit-identical to the other's, every element written "
              f"and within HeldBf16's bound on "
              f"{', '.join(str(tuple(e['shape'])) for e in fwd_edges[::2])}, both modes")
    print(f"[compare] SASS, instructions this/other and the same but for constant-bank "
          f"offsets: {json.dumps(sass)}")
    same = {k: v["same"] for k, v in sass.items() if v["this"] and v["other"]}
    print(f"[compare] instances in both libraries, the same SASS but for constant-bank "
          f"offsets: {sum(same.values())} of {len(same)}; differing: "
          f"{json.dumps([k for k, v in same.items() if not v])}; only in one: "
          f"{json.dumps([k for k, v in sass.items() if not (v['this'] and v['other'])])}")
    print(f"[compare] every kernel of both libraries: {len(all_sass['same'])} the same SASS "
          f"but for constant-bank offsets, differing {json.dumps(all_sass['differing'])}, "
          f"only this tree's {json.dumps(all_sass['only_this'])}, only the other's "
          f"{json.dumps(all_sass['only_other'])}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
