"""Time variants of the 2-D warp's bf16 forward against another checkout's, on one card, in one process.

    python scripts/warp_fwd_variants.py --other <checkout> [--out build/warp_fwd_variants.json]

Each variant is this tree's ``planedepth_tpu_torch/csrc/warp2d.cu`` with
textual patches (``VARIANTS``), built alone into a library of its own, as is
the other checkout's ``warp2d.cu`` (one nvcc each, started together):

- ``heads_pair``: a row's logit (and sigma) tap pair one 4-byte load where
  both taps are inside and the pair is 4-byte aligned, else two predicated
  2-byte loads (this tree: always the latter);
- ``pairs16``: src packed into pairs of horizontally neighbouring pixels,
  16 bytes an entry, a sample's four rgb taps two 16-byte loads (this tree:
  one pixel an 8-byte entry, four 8-byte loads); ``pairs16_cols2`` the same
  at two columns a thread in blocks of 64 x 2 with no minimum of blocks an
  SM (the first design measured);
- ``cols2``, ``cols2_rows4``, ``cols1``: two and one columns a thread (this
  tree: four), in blocks of 64 x 2, 64 x 4 and 128 x 1 threads (this tree:
  32 x 4), no minimum of blocks an SM (this tree asks for 10);
- ``no_min``, ``min12``: this tree's geometry with no minimum of blocks an
  SM, and asking for 12;
- ``rows8``, ``lanes16``: blocks of 32 x 8 and 16 x 8 threads;
- ``stream``: dx, dy and mask read and the stacks written with the
  streaming cache hints (``__ldcs``, ``__stcs``).

At the mono step's (8, 63, 192, 640) with and without sigma, and without
sigma at a zoom of 200 px, on ``chip_smoke.py``'s warp inputs in bf16 (dx,
dy, mask float32): each library's ``pdt_warp2d_fwd_bf16`` alone (this tree's
and the variants' with their packing) in turns, first library to last and
back, each time the median of 20 CUDA-event times after 3 warm-ups, beside
this tree's float32 entry.  Every output of every library is compared bit
for bit with the other checkout's.  Prints one JSON object, also written to
``--out``, with the card's name and power limit and each library's
registers from ``-Xptxas -v``.
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
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as cs                                   # noqa: E402
import compare_sweep as cmp                               # noqa: E402
from planedepth_tpu_torch.ops import _build               # noqa: E402

CASES = ((cs.SWEEP_SHAPE, True, {}), (cs.SWEEP_SHAPE, False, {}),
         (cs.SWEEP_SHAPE, False, dict(zoom=200.0)))

GEOMETRY = ("constexpr int kFwdCols = 4;", "constexpr int kFwdLanes = 32;",
            "constexpr int kFwdRows = 4;")


def geometry(cols, lanes, rows):
    """kFwdCols columns a thread, blocks of kFwdLanes x kFwdRows threads."""
    return [[old, re.sub(r"= \d+;", f"= {n};", old)]
            for old, n in zip(GEOMETRY, (cols, lanes, rows))]


def min_blocks(n):
    """__launch_bounds__ asking for n blocks an SM (None: no minimum)."""
    bound = "kFwdThreads" if n is None else f"kFwdThreads, {n}"
    return [["__launch_bounds__(kFwdThreads, kFwdMinBlocks)", f"__launch_bounds__({bound})"]]


STREAM = [["__ldg(reinterpret_cast<const float4*>(p))", "__ldcs(reinterpret_cast<const float4*>(p))"],
          ["*reinterpret_cast<uint2*>(p) = w;", "__stcs(reinterpret_cast<uint2*>(p), w);"]]
PAIRS16 = [["  pix[i] = make_uint2(c[0] | c[1] << 16, c[2]);",
            "  unsigned int d[3] = {0u, 0u, 0u};\n"
            "  if (y >= 0 && y < H && x + 1 >= 0 && x + 1 < W) {\n"
            "    const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + b * 3 * H * W;\n"
            "    for (int ch = 0; ch < 3; ++ch) d[ch] = __ldg(s + ((int64_t)ch * H + y) * W + x + 1);\n"
            "  }\n"
            "  reinterpret_cast<uint4*>(pix)[i] = make_uint4(c[0] | c[1] << 16, c[2], "
            "d[0] | d[1] << 16, d[2]);"],
           ["    const uint2* q = pix + (t.y0 + 1) * (W + 2) + (t.x0 + 1);\n"
            "    const uint2 p[4] = {__ldg(q), __ldg(q + 1), __ldg(q + (W + 2)), __ldg(q + (W + 3))};",
            "    const uint4* q = reinterpret_cast<const uint4*>(pix) + (t.y0 + 1) * (W + 2)"
            " + (t.x0 + 1);\n"
            "    const uint4 top = __ldg(q), bot = __ldg(q + (W + 2));\n"
            "    const uint2 p[4] = {make_uint2(top.x, top.y), make_uint2(top.z, top.w),"
            " make_uint2(bot.x, bot.y), make_uint2(bot.z, bot.w)};"],
           ["const uint2* pp = pix + (int64_t)(bn / N) * (H + 2) * (W + 2);",
            "const uint2* pp = reinterpret_cast<const uint2*>(reinterpret_cast<const uint4*>"
            "(pix) + (int64_t)(bn / N) * (H + 2) * (W + 2));"],
           ["pix + b0 * img,", "reinterpret_cast<uint2*>(reinterpret_cast<uint4*>(pix) + b0 * img),"],
           ["(int64_t)B * (H + 2) * (W + 2) * (int64_t)sizeof(uint2)",
            "(int64_t)B * (H + 2) * (W + 2) * (int64_t)sizeof(uint4)"]]

HEADS_PAIR = [["// VEC: W a multiple of kFwdCols and every float32 map",
               "__device__ __forceinline__ void corners_paired(const __nv_bfloat16* __restrict__ img,\n"
               "                                               const Taps32& t, float v[4]) {\n"
               "  for (int r = 0; r < 2; ++r) {\n"
               "    const __nv_bfloat16* p = img + t.off[2 * r];\n"
               "    if (t.in[2 * r] && t.in[2 * r + 1] && (uintptr_t)p % 4 == 0) {\n"
               "      const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(p));\n"
               "      v[2 * r] = bf_lo(w), v[2 * r + 1] = bf_hi(w);\n"
               "    } else {\n"
               "      v[2 * r] = t.in[2 * r] ? ldg_f(p) : 0.f;\n"
               "      v[2 * r + 1] = t.in[2 * r + 1] ? ldg_f(p + 1) : 0.f;\n"
               "    }\n"
               "  }\n"
               "}\n\n"
               "// VEC: W a multiple of kFwdCols and every float32 map"],
              ["corners32(lp, t, v);", "corners_paired(lp, t, v);"],
              ["corners32(sp, t, v);", "corners_paired(sp, t, v);"]]

VARIANTS = {
    "heads_pair": HEADS_PAIR,
    "pairs16": PAIRS16,
    "pairs16_cols2": PAIRS16 + geometry(2, 64, 2) + min_blocks(None),
    "cols2": geometry(2, 64, 2) + min_blocks(None),
    "cols2_rows4": geometry(2, 64, 4) + min_blocks(None),
    "cols1": geometry(1, 128, 1) + min_blocks(None),
    "no_min": min_blocks(None),
    "min12": min_blocks(12),
    "rows8": geometry(4, 32, 8),
    "lanes16": geometry(4, 16, 8),
    "stream": STREAM,
}


def patched(name):
    text = (REPO / "planedepth_tpu_torch" / "csrc" / "warp2d.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source has no {old!r}")
        text = text.replace(old, new)
    return text


def registers(log):
    """``-Xptxas -v``'s registers of the bf16 forward's warp kernels."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and "warp2d_fwd" in cur and ("bf16" in cur or "bfloat16" in cur):
            out["sigma" if "ILb1E" in cur else "nosigma"] = int(m.group(1))
    return out


def build(other: Path):
    """The variants and the other checkout's warp2d.cu, one library each."""
    out_dir = REPO / "build" / "warp_fwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: out_dir / f"{name}.cu" for name in VARIANTS}
    for name, path in sources.items():
        path.write_text(patched(name))
    sources["other"] = other / "planedepth_tpu_torch" / "csrc" / "warp2d.cu"
    procs = {}
    for name, path in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / f"{name}.so"),
               str(path)]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        scratch = hasattr(lib, "pdt_warp2d_fwd_bf16_scratch_bytes")
        lib.pdt_warp2d_fwd_bf16.argtypes = [p] * (10 if scratch else 9) + [i] * 5 + [p]
        lib.pdt_warp2d_fwd_bf16.restype = i
        if scratch:
            lib.pdt_warp2d_fwd_bf16_scratch_bytes.argtypes = [i] * 3
            lib.pdt_warp2d_fwd_bf16_scratch_bytes.restype = ctypes.c_longlong
        libs[name], regs[name] = lib, registers(log)
    return libs, regs


def run_case(libs, this, shape, with_sigma, kw, dev):
    inputs32 = [None if t is None else t.detach()
                for t in cs.seeded_warp_inputs(shape, 20, dev, **kw)]
    if not with_sigma:
        inputs32[2] = None
    ins16 = [None if t is None else t.detach() for t in cs.as_bf16(inputs32, (3, 4, 5))]
    B, N, H, W = shape
    fns, outs = {}, {}
    for name, lib in libs.items():
        outs[name] = cmp.warp_fwd_bf16_outputs(shape, with_sigma, dev)
        fns[name] = cmp.warp_fwd_bf16_entry(lib, ins16, outs[name], shape, with_sigma)
        fns[name]()
    f32 = [torch.empty((B, N, 3, H, W), device=dev), torch.empty(shape, device=dev),
           torch.empty(shape, device=dev) if with_sigma else None]
    fns["float32"] = lambda: cmp.call(this, "pdt_warp2d_fwd", *inputs32, *f32, B, N, H, W,
                                      int(with_sigma))
    torch.cuda.synchronize(dev)
    live = lambda o: [t for t in o if t is not None]                      # noqa: E731
    same = {name: all(cmp.bits_equal(a, b) for a, b in zip(live(o), live(outs["other"])))
            for name, o in outs.items()}
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in (order, order[::-1]):
        for name in turn:
            times[name].append(cs.cuda_ms(fns[name], warmup=3, reps=20))
    return {"shape": list(shape), "with_sigma": with_sigma, "inputs": kw, "ms": times,
            "bit_identical_to_other": same}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", default=str(REPO / "build" / "warp_fwd_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_fwd_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    this = _build.load_library()
    built, regs = build(args.other)
    libs = {"other": built.pop("other"), "this": this, **built}
    regs["this"] = registers(_build.build()["log"])
    cases = []
    for shape, with_sigma, kw in CASES:
        cases.append(run_case(libs, this, shape, with_sigma, kw, dev))
        torch.cuda.empty_cache()
        c = cases[-1]
        med = {k: round(sorted(v)[len(v) // 2], 4) for k, v in c["ms"].items()}
        print(f"[variants] {tuple(shape)} sigma {with_sigma} {kw}: ms {json.dumps(med)}; "
              f"bit-identical to the other's {json.dumps(c['bit_identical_to_other'])} | {card}",
              flush=True)
    report = {"card": card, "other": str(args.other), "registers": regs, "cases": cases}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[variants] registers {json.dumps(regs)}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
