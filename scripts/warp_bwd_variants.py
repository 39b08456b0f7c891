"""Time variants of the 2-D warp's bf16 backward against another checkout's, on one card, in one process.

    python scripts/warp_bwd_variants.py --other <checkout> [--out build/warp_bwd_variants.json]

Each variant is this tree's ``planedepth_tpu_torch/csrc/warp2d.cu`` with
textual patches (``VARIANTS``), built alone into a library of its own, as is
the other checkout's ``warp2d.cu`` (one nvcc each, started together):

- ``tile1``, ``tile4``: ``warp2d_bwd_tile_kernel`` on tiles of 1 x 32 and
  4 x 8 lanes (this tree: 2 x 16);
- ``ring``: the sums of each plane in one slot of a ring of 16 L2-resident
  plane slots, rounded and cleared inside the same launch (``RING``):
  tickets of 2 rows of 128 columns taken in order from a counter, the next
  taken while one runs; a ticket rounds plane q - 4, clears plane q - 8 and
  scatters plane q, each once the counts of earlier tickets allow (counts
  spread over 8 lines, polled relaxed, released by the counting tickets);
  8 blocks an SM;
- ``ring_probe``: the same without any wait or count (wrong sums: a probe
  of the design's floor).

At the mono step's (8, 63, 192, 640) with and without sigma, and with sigma
at a zoom of 200 px, on ``chip_smoke.py``'s warp inputs in bf16: each
library's ``pdt_warp2d_bwd_bf16`` alone in turns (first library to last and
back; each time the median of 10 CUDA-event times after 3 warm-ups), the
other's also with the zeroing of its float32 buffers, beside this tree's
float32 entry.  Every variant but the probe is held to the plain version's
autograd as ``chip_smoke.py:HeldBf16`` bounds a bf16 gradient; whether its
d_dx and d_dy equal the other's bit for bit is reported.  Prints one JSON object, also written
to ``--out``, with the card's name and power limit.
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
from planedepth_tpu_torch.ops import _build               # noqa: E402
from planedepth_tpu_torch.ops.warp2d import warp2d_plain  # noqa: E402

CASES = (((8, 63, 192, 640), True, 30.0), ((8, 63, 192, 640), False, 30.0),
         ((8, 63, 192, 640), True, 200.0))

RING = r'''
constexpr int kRingSlots = 16;
constexpr int kRingRoundLag = 4;
constexpr int kRingClearLag = 8;    // > kRingRoundLag, < kRingSlots
constexpr int kRingRows = 2;
constexpr int kRingMinBlocks = 8;
constexpr int kRingSubs = 8;
constexpr int kRingSubStride = 1024;
constexpr int kRingHeader = (kRingSubs + 1) * kRingSubStride * 4;
enum { kScattered = 0, kRounded = 1, kCleared = 2 };

__device__ __forceinline__ unsigned int* ring_count(unsigned int* ctr, int set, int stage,
                                                    int slot) {
  return ctr + (set + 1) * kRingSubStride + stage * kRingSlots + slot;
}

__device__ __forceinline__ unsigned int ld_relaxed(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void wait_counts(unsigned int* ctr, int s0, unsigned int w0, int s1,
                                            unsigned int w1, int s2, unsigned int w2) {
  if (threadIdx.x < 32) {
    const int k = threadIdx.x >> 3;
    const unsigned int want = k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : 0u;
    const unsigned int* c = ring_count(ctr, threadIdx.x & 7, k, k == 0 ? s0 : k == 1 ? s1 : s2);
    for (;;) {
      unsigned int v = want ? ld_relaxed(c) : 0u;
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (__all_sync(0xffffffffu, v >= want)) break;
      __nanosleep(64);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void signal_count(unsigned int* count, bool release) {
  if (release)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
  else
    asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
}

__host__ __device__ __forceinline__ unsigned ring_tickets(int H, int W) {
  return (unsigned)((W + kBwdThreads - 1) / kBwdThreads) *
         (unsigned)((H + kRingRows - 1) / kRingRows);
}

template <bool SIGMA>
__global__ void __launch_bounds__(kBwdThreads, kRingMinBlocks)
warp2d_bwd_ring_kernel(const __nv_bfloat16* __restrict__ src,
                       const __nv_bfloat16* __restrict__ logits,
                       const __nv_bfloat16* __restrict__ sigma, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ g_rgb,
                       const __nv_bfloat16* __restrict__ g_logit,
                       const __nv_bfloat16* __restrict__ g_sigma,
                       __nv_bfloat16* __restrict__ d_logits, __nv_bfloat16* __restrict__ d_sigma,
                       float* __restrict__ d_dx, float* __restrict__ d_dy,
                       unsigned int* __restrict__ ctr, float* __restrict__ ring, int N, int H,
                       int W, int planes) {
  using bf = __nv_bfloat16;
  constexpr int C = SIGMA ? 2 : 1;
  const int plane = H * W;
  const int segs = (W + kBwdThreads - 1) / kBwdThreads;
  const unsigned per_plane = ring_tickets(H, W);
  const unsigned total = (unsigned)(planes + kRingClearLag) * per_plane;
  __shared__ unsigned int tickets[2];
  if (threadIdx.x == 0) tickets[0] = atomicAdd(ctr, 1u);
  __syncthreads();
  for (int i = 0;; i ^= 1) {
    const unsigned tk = tickets[i];
    if (tk >= total) return;
    unsigned next = 0;
    if (threadIdx.x == 0) next = atomicAdd(ctr, 1u);
    const int q = tk / per_plane;
    const int r = tk - q * per_plane;
    const int band = r / segs;
    const int x = (r - band * segs) * kBwdThreads + threadIdx.x;
    const int y0 = band * kRingRows, y1 = min(y0 + kRingRows, H);
    const int pr = q - kRingRoundLag, pc = q - kRingClearLag;
    const bool rounds = pr >= 0 && pr < planes, clears = pc >= 0, scatters = q < planes;
    wait_counts(ctr, max(pr, 0) % kRingSlots,
                rounds ? (unsigned)(pr / kRingSlots + 1) * per_plane : 0u,
                max(pc, 0) % kRingSlots, clears ? (unsigned)(pc / kRingSlots + 1) * per_plane : 0u,
                q % kRingSlots,
                scatters && q >= kRingSlots ? (unsigned)(q / kRingSlots) * per_plane : 0u);
    if (rounds && x < W) {
      const float* slot = ring + (int64_t)(pr % kRingSlots) * C * plane;
      for (int y = y0; y < y1; ++y) {
        const int at = y * W + x;
        const int64_t o = (int64_t)pr * plane + at;
        if (SIGMA) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(slot) + at);
          d_logits[o] = __float2bfloat16_rn(v.x);
          d_sigma[o] = __float2bfloat16_rn(v.y);
        } else {
          d_logits[o] = __float2bfloat16_rn(__ldcg(slot + at));
        }
      }
    }
    if (clears && x < W) {
      float* slot = ring + (int64_t)(pc % kRingSlots) * C * plane;
      for (int y = y0; y < y1; ++y) {
        if (SIGMA)
          __stcg(reinterpret_cast<float2*>(slot) + y * W + x, make_float2(0.f, 0.f));
        else
          __stcg(slot + y * W + x, 0.f);
      }
    }
    if (scatters) {
      float* slot = ring + (int64_t)(q % kRingSlots) * C * plane;
      const int64_t base = (int64_t)q * plane;
      const bf* srcb = src + (int64_t)(q / N) * 3 * plane;
      for (int y = y0; y < y1; ++y) {
        const int at = y * W + x;
        Taps32 t;
        float wl[4] = {0.f, 0.f, 0.f, 0.f}, ws[4] = {0.f, 0.f, 0.f, 0.f};
        bool live = false;
        if (x < W) {
          const float xs = x + dx[base + at], ys = y + dy[base + at];
          const bool valid = xs > -1.f && xs < (float)W && ys > -1.f && ys < (float)H;
          const float m = valid ? mask[base + at] : 0.f;
          float gx = 0.f, gy = 0.f;
          if (m != 0.f) {
            live = true;
            t = make_taps32(xs, ys, H, W);
            const bf* grp = g_rgb + 3 * base + at;
            float v[4];
            for (int c = 0; c < 3; ++c) {
              corners32(srcb + c * plane, t, v);
              add_coord_grads(v, m * to_f(grp[c * plane]), t.fx, t.fy, gx, gy);
            }
            const float gl = m * to_f(g_logit[base + at]);
            corners32(logits + base, t, v);
            add_coord_grads(v, gl, t.fx, t.fy, gx, gy);
            float gs = 0.f;
            if (SIGMA) {
              gs = m * to_f(g_sigma[base + at]);
              corners32(sigma + base, t, v);
              add_coord_grads(v, gs, t.fx, t.fy, gx, gy);
            }
            for (int k = 0; k < 4; ++k) {
              const float w = t.in[k] ? ((k & 1) ? t.fx : 1.f - t.fx) *
                                            ((k & 2) ? t.fy : 1.f - t.fy)
                                      : 0.f;
              wl[k] = w * gl;
              ws[k] = w * gs;
              if (!SIGMA && t.in[k]) atomicAdd(slot + t.off[k], wl[k]);
            }
          }
          d_dx[base + at] = gx;
          d_dy[base + at] = gy;
        }
        if (SIGMA) {
          const int lane = threadIdx.x & 31;
          const int key = live ? (t.y0 + 1) * (W + 2) + t.x0 + 1 : -2;
          const bool take = __shfl_up_sync(0xffffffffu, key, 1) + 1 == key && lane > 0;
          const float up0 = __shfl_up_sync(0xffffffffu, wl[1], 1);
          const float up1 = __shfl_up_sync(0xffffffffu, wl[3], 1);
          const float up2 = __shfl_up_sync(0xffffffffu, ws[1], 1);
          const float up3 = __shfl_up_sync(0xffffffffu, ws[3], 1);
          const bool skip = __shfl_down_sync(0xffffffffu, (int)take, 1) && lane < 31;
          if (live) {
            if (take) {
              wl[0] += up0;
              wl[2] += up1;
              ws[0] += up2;
              ws[2] += up3;
            }
            for (int k = 0; k < 4; ++k)
              if (t.in[k] && !((k & 1) && skip))
                asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(slot + 2 * t.off[k]),
                             "f"(wl[k]), "f"(ws[k]) : "memory");
          }
        }
      }
    }
    if (threadIdx.x == 0) tickets[i ^ 1] = next;
    __syncthreads();
    if (threadIdx.x == 0) {
      const int set = blockIdx.x % kRingSubs;
      if (rounds) signal_count(ring_count(ctr, set, kRounded, pr % kRingSlots), false);
      if (clears) signal_count(ring_count(ctr, set, kCleared, pc % kRingSlots), true);
      if (scatters) signal_count(ring_count(ctr, set, kScattered, q % kRingSlots), true);
    }
  }
}

int64_t ring_scratch_bytes(int H, int W, int with_sigma) {
  return kRingHeader + (int64_t)kRingSlots * (with_sigma ? 2 : 1) * H * W * sizeof(float);
}

int warp_bwd_ring(const __nv_bfloat16* src, const __nv_bfloat16* logits,
                  const __nv_bfloat16* sigma, const float* dx, const float* dy,
                  const float* mask, const __nv_bfloat16* g_rgb, const __nv_bfloat16* g_logit,
                  const __nv_bfloat16* g_sigma, __nv_bfloat16* d_logits, __nv_bfloat16* d_sigma,
                  float* d_dx, float* d_dy, void* scratch, int B, int N, int H, int W,
                  int with_sigma, cudaStream_t st) {
  const int planes = B * N;
  const int64_t tickets = (int64_t)(planes + kRingClearLag) * ring_tickets(H, W);
  if (tickets >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const void* fn = with_sigma ? (const void*)warp2d_bwd_ring_kernel<true>
                              : (const void*)warp2d_bwd_ring_kernel<false>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBwdThreads, 0);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, ring_scratch_bytes(H, W, with_sigma), st);
  if (e != cudaSuccess) return (int)e;
  unsigned int* ctr = (unsigned int*)scratch;
  float* ring = (float*)((char*)scratch + kRingHeader);
  const int grid = (int)std::min<int64_t>(tickets, (int64_t)sms * std::max(per_sm, 1));
  if (with_sigma)
    warp2d_bwd_ring_kernel<true><<<grid, kBwdThreads, 0, st>>>(
        src, logits, sigma, dx, dy, mask, g_rgb, g_logit, g_sigma, d_logits, d_sigma, d_dx,
        d_dy, ctr, ring, N, H, W, planes);
  else
    warp2d_bwd_ring_kernel<false><<<grid, kBwdThreads, 0, st>>>(
        src, logits, nullptr, dx, dy, mask, g_rgb, g_logit, nullptr, d_logits, nullptr, d_dx,
        d_dy, ctr, ring, N, H, W, planes);
  return (int)cudaGetLastError();
}

'''
HOST_ANCHOR = "// The bf16 backward: clears the accumulator (the scratch), scatters into it"
ENTRY = "  return warp_bwd_bf16((const bf*)src,"
SCRATCH = "  return bf16_bwd_scratch_bytes(B, N, H, W, with_sigma);"
RING_PATCH = [[HOST_ANCHOR, RING + HOST_ANCHOR], [ENTRY, "  return warp_bwd_ring((const bf*)src,"],
              [SCRATCH, "  return ring_scratch_bytes(H, W, with_sigma);"]]
WAIT = "    wait_counts(ctr, max(pr, 0) % kRingSlots,"
VARIANTS = {
    "tile1": [["constexpr int kTileRows = 2;", "constexpr int kTileRows = 1;"]],
    "tile4": [["constexpr int kTileRows = 2;", "constexpr int kTileRows = 4;"]],
    "ring": RING_PATCH,
    # no waits and no counts: every ticket goes on at once (wrong sums)
    "ring_probe": RING_PATCH + [[WAIT, "    if (false) wait_counts(ctr, max(pr, 0) % kRingSlots,"],
                                ["      if (rounds) signal_count(", "      if (false) signal_count("],
                                ["      if (clears) signal_count(", "      if (false) signal_count("],
                                ["      if (scatters) signal_count(", "      if (false) signal_count("]],
}
PROBES = ("ring_probe",)


def patched(name):
    text = (REPO / "planedepth_tpu_torch" / "csrc" / "warp2d.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source has no {old!r}")
        text = text.replace(old, new, 1 if old == HOST_ANCHOR else -1)
    return text


def build(other: Path) -> dict:
    """The variants and the other checkout's warp2d.cu, one library each."""
    out_dir = REPO / "build" / "warp_bwd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    sources = {name: out_dir / f"{name}.cu" for name in VARIANTS}
    for name, path in sources.items():
        path.write_text(patched(name))
    sources["other"] = other / "planedepth_tpu_torch" / "csrc" / "warp2d.cu"
    for name, path in sources.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out_dir / f"{name}.so"),
               str(path)]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        scratch = hasattr(lib, "pdt_warp2d_bwd_bf16_scratch_bytes")
        lib.pdt_warp2d_bwd_bf16.argtypes = [p] * (14 if scratch else 15) + [i] * 5 + [p]
        lib.pdt_warp2d_bwd_bf16.restype = i
        if scratch:
            lib.pdt_warp2d_bwd_bf16_scratch_bytes.argtypes = [i] * 5
            lib.pdt_warp2d_bwd_bf16_scratch_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def call(lib, fn, *args):
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(lib, fn)(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")


def run_case(libs, this, shape, with_sigma, zoom, dev):
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
    for name, lib in libs.items():
        out = [torch.empty_like(ins16[1]), torch.empty_like(ins16[1]) if with_sigma else None,
               torch.empty(shape, device=dev), torch.empty(shape, device=dev)]
        if hasattr(lib, "pdt_warp2d_bwd_bf16_scratch_bytes"):
            sc = torch.empty(lib.pdt_warp2d_bwd_bf16_scratch_bytes(B, N, H, W, int(with_sigma)),
                             dtype=torch.uint8, device=dev)
            fns[name] = lambda lib=lib, o=out, sc=sc: call(
                lib, "pdt_warp2d_bwd_bf16", *ins16, *cts16, *o, sc, B, N, H, W, int(with_sigma))
        else:
            acc = [torch.zeros(shape, device=dev),
                   torch.zeros(shape, device=dev) if with_sigma else None]
            fns[name] = lambda lib=lib, o=out, acc=acc: call(
                lib, "pdt_warp2d_bwd_bf16", *ins16, *cts16, *acc, *o, B, N, H, W,
                int(with_sigma))

            def zeroed(f=fns[name], acc=acc):
                for a in acc:
                    if a is not None:
                        a.zero_()
                f()
            fns[f"{name}_with_zeroing"] = zeroed
        (fns.get(f"{name}_with_zeroing") or fns[name])()
        grads[name] = out
    f32 = [torch.zeros(shape, device=dev), torch.zeros(shape, device=dev) if with_sigma else None,
           torch.empty(shape, device=dev), torch.empty(shape, device=dev)]
    fns["float32"] = lambda: call(this, "pdt_warp2d_bwd", *inputs32, *cts32, *f32, B, N, H, W,
                                  int(with_sigma))
    torch.cuda.synchronize(dev)
    ops = [None if t is None else t.detach().requires_grad_(i in (1, 2, 3, 4))
           for i, t in enumerate(ins16)]
    wrt = [t for t in ops[1:5] if t is not None]
    want = torch.autograd.grad(warp2d_plain(*ops), wrt, [c for c in cts16 if c is not None])
    held = {}
    for name, out in grads.items():
        got = [t for t in out if t is not None]
        excess = []
        for a, b in zip(got, want):
            err = (a.float() - b.float()).abs()
            ulp = cs.bf16_ulp(b) if a.dtype == cs.BF16 else 0.0
            excess.append(float((err - ulp).max()) - cs.GRAD_TOL * float(b.float().abs().max()))
        same = torch.equal(out[2], grads["other"][2]) and torch.equal(out[3], grads["other"][3])
        held[name] = {"excess_over_bound": max(excess), "d_dx_d_dy_as_other": same}
        if name not in PROBES and max(excess) > 0:
            raise AssertionError(f"{name} at {shape}, sigma {with_sigma}: {held[name]}")
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in (order, order[::-1]):
        for name in turn:
            times[name].append(cs.cuda_ms(fns[name], warmup=3, reps=10))
    return {"shape": list(shape), "with_sigma": with_sigma, "zoom_px": zoom, "ms": times,
            "held": held}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", default=str(REPO / "build" / "warp_bwd_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_bwd_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    this = _build.load_library()
    libs = {"other": None, "this": this}
    libs.update(build(args.other))
    cases = []
    for shape, with_sigma, zoom in CASES:
        cases.append(run_case(libs, this, shape, with_sigma, zoom, dev))
        torch.cuda.empty_cache()
        c = cases[-1]
        med = {k: round(sorted(v)[len(v) // 2], 4) for k, v in c["ms"].items()}
        print(f"[variants] {tuple(shape)} sigma {with_sigma} zoom {zoom}: ms {json.dumps(med)}; "
              f"held {json.dumps(c['held'])} | {card}", flush=True)
    report = {"card": card, "other": str(args.other), "cases": cases}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
