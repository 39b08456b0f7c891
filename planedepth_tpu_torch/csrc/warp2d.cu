// Per-plane 2-D bilinear warp of [rgb | logit | sigma], and its adjoint.
//
// Replaces planedepth_tpu/ops/pallas_warp2d.py:_fwd_kernel (forward, behind
// warp2d_sample's _fwd_call) and _bwd_kernel (backward, behind _bwd_call),
// in both of their modes: with_sigma=True (the mixture recipes) and
// with_sigma=False (use_mixture_loss=False: [rgb | logit] only, no sigma
// load, store or scatter), one template instance each.
// For output element (b, n, y, x), with xs = x + dx, ys = y + dy:
//   valid = xs > -1 && xs < W && ys > -1 && ys < H   (false for NaN)
//   m     = mask * valid
//   rgb[b, n, c, y, x] = m * bilinear(src[b, c], xs, ys)
//   logit[b, n, y, x]  = m * bilinear(logits[b, n], xs, ys)
//   sigma[b, n, y, x]  = m * bilinear(sigma[b, n], xs, ys)
// where bilinear reads 0 outside the image (grid_sample's zero padding, in
// pixel units).  `valid` is prepare_coords' fold of fully-outside samples
// (pallas_warp2d.py:99-122), done here per element: a sample outside the
// open box has four outside taps and is 0 anyway, so the fold only keeps a
// degenerate coordinate (1e12, NaN) from reaching the tap arithmetic.
// Unlike the TPU kernel every sample is exact: there is no tap window, so
// nothing is clamped to a spread bound (pallas_warp2d.py:34-40).
//
// Adjoint, given g_rgb, g_logit, g_sigma (each masked by m):
//   d_logits, d_sigma (B, N, H, W): each sample's bilinear weights times its
//     cotangent, scattered to its four taps;
//   d_dx = sum_c g_c ((1 - fy)(v01 - v00) + fy (v11 - v10)), d_dy its y
//     twin, over the 5 channels, with outside taps reading 0: grid_sample's
//     gradient with respect to the grid, in pixel units.
// src and mask get no cotangent (the train step differentiates neither).
//
// Bound: device memory.  Forward: dx, dy, mask, logits, sigma read and 5
// maps written, ~2.49 GB at (8, 63, 192, 640), ~0.74 ms at 3.35 TB/s.
// Backward: 10 maps read and 4 written, ~3.47 GB, ~1.04 ms.  Without sigma:
// 8 maps forward (~1.99 GB, ~0.60 ms), 11 backward (~2.74 GB, ~0.82 ms).
// Neither direction holds a matrix product, so no tensor cores.
//
// Forward design: one thread per output element, threads along W, so the
// loads of dx, dy, mask and every store are coalesced; the taps of a smooth
// warp are neighbours of the neighbouring threads' taps, and src (11.8 MB)
// stays in L2.  The entry point launches at most 65535 planes (the grid's
// z axis) at a time, in whole images.
//
// Backward design.  A homography has no reverse window to gather over, so
// the adjoint of the taps is a scatter, and its sums are float atomics into
// buffers the wrapper zeroes (cudaMemsetAsync in the entry point measured
// 0.03-0.05 ms slower than PyTorch's fill).  One thread an output element;
// grid (row segments, rows, planes), so the blocks in flight cover a plane
// or two: the gathered planes and the scatter's lines stay in L2.  Offsets
// are 32-bit within a plane, from one base pointer a map; a tap pair stays
// two 4-byte loads, since neighbouring lanes start their pairs at
// alternating 8-byte parity and a paired load would split the warp.  Blocks
// stay 128 threads on one row.  With sigma, neighbouring lanes combine
// their shared taps before the atomics (lane x's right taps are lane x +
// 1's left ones when the warp is smooth); without sigma that measured no
// gain (within 2% either way), so its lanes add their own taps.  At most 40
// registers: 12 blocks, 48 warps an SM; the kernel is latency-bound
// (layouts with 16 warps an SM ran ~2x slower).
// The atomics cost ~0.85 ms at the mono shape, and by the instruction more
// than by the lane: dropping the right-tap atomics, which after the
// combining have few lanes left, saves 0.40 ms; keeping every atomic on
// half the lanes saves 0.29 ms; a red.global.add.v4.f32 a tap costs 40%
// more.  Measured and dropped (NVIDIA H100 80GB HBM3, 700 W, on
// scripts/compare_sweep.py's warp inputs, against 2.09 ms for the first
// kernel alone and 2.22 ms with its zeroing):
//  - a cluster of 8 blocks a plane holding the plane's d_logits and d_sigma
//    in distributed shared memory, each element written once: 2.86 ms.
//    sm_90 has no native float add on shared memory (red.shared.add.f32 is
//    a compare-and-swap loop, ATOMS.CAST.SPIN, local or remote), a 123 KB
//    band a block leaves 32 warps an SM, and 15 planes in flight push the
//    gathers out of L2: without any atomics that layout still took 2.15 ms;
//  - the same clusters zeroing their plane just before their global
//    atomics: 2.38-2.82 ms; zeroing in chunks of 8-63 planes between
//    launches: slower (each launch drains the card);
//  - 2-D tiles (32 x 4 to 32 x 16, 64 x 4 pixels) accumulating their
//    footprint in shared memory, then one vector atomic a quad: 2.30-2.65
//    ms (with the zeroing) against 2.17, the compare-and-swap loops again;
//  - atomics aimed at one L2-resident plane (wrong sums, a probe): only
//    0.15 ms less, so the atomics cost their issue and L2 work, not HBM.
// The order of the f32 sums at a tap is not fixed from run to run.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;

// The bilinear taps of one sample: corner offsets into a (H, W) map, their
// weights and whether each lies inside the image.
struct Taps {
  int64_t off[4];   // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
  bool in[4];
  float fx, fy;
};

__device__ __forceinline__ Taps make_taps(float xs, float ys, int H, int W) {
  Taps t;
  const float x0f = floorf(xs), y0f = floorf(ys);
  t.fx = xs - x0f;
  t.fy = ys - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;   // in [-1, W - 1] x [-1, H - 1]
  const bool inx[2] = {x0 >= 0, x0 + 1 < W};
  const bool iny[2] = {y0 >= 0, y0 + 1 < H};
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    t.in[k] = iny[dy] && inx[dx];
    t.off[k] = (int64_t)(y0 + dy) * W + (x0 + dx);
  }
  return t;
}

// The four corner values v00, v01, v10, v11 of `img` (0 outside).
__device__ __forceinline__ void corners(const float* __restrict__ img, const Taps& t,
                                        float v[4]) {
  for (int k = 0; k < 4; ++k) v[k] = t.in[k] ? __ldg(img + t.off[k]) : 0.f;
}

__device__ __forceinline__ float lerp2(const float v[4], float fx, float fy) {
  return (1.f - fy) * ((1.f - fx) * v[0] + fx * v[1]) + fy * ((1.f - fx) * v[2] + fx * v[3]);
}

// Adds one channel's cotangent gc times d(lerp2)/dfx and d(lerp2)/dfy.
__device__ __forceinline__ void add_coord_grads(const float v[4], float gc, float fx,
                                                float fy, float& gx, float& gy) {
  gx += gc * ((1.f - fy) * (v[1] - v[0]) + fy * (v[3] - v[2]));
  gy += gc * ((1.f - fx) * (v[2] - v[0]) + fx * (v[3] - v[1]));
}

// SIGMA: the mixture mode; without it the sigma pointers are not touched.
template <bool SIGMA>
__global__ void warp2d_fwd_kernel(const float* __restrict__ src,
                                  const float* __restrict__ logits,
                                  const float* __restrict__ sigma,
                                  const float* __restrict__ dx,
                                  const float* __restrict__ dy,
                                  const float* __restrict__ mask,
                                  float* __restrict__ rgb,
                                  float* __restrict__ logit_out,
                                  float* __restrict__ sigma_out,
                                  int N, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int bn = blockIdx.z;                  // b * N + n
  if (x >= W) return;
  const int b = bn / N;
  const int64_t plane = (int64_t)H * W;
  const int64_t at = (int64_t)y * W + x;
  const int64_t pix = bn * plane + at;

  const float xs = x + dx[pix], ys = y + dy[pix];
  const bool valid = xs > -1.f && xs < (float)W && ys > -1.f && ys < (float)H;
  const float m = valid ? mask[pix] : 0.f;
  float out[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (m != 0.f) {
    const Taps t = make_taps(xs, ys, H, W);
    float v[4];
    for (int c = 0; c < 3; ++c) {
      corners(src + ((int64_t)b * 3 + c) * plane, t, v);
      out[c] = m * lerp2(v, t.fx, t.fy);
    }
    corners(logits + bn * plane, t, v);
    out[3] = m * lerp2(v, t.fx, t.fy);
    if (SIGMA) {
      corners(sigma + bn * plane, t, v);
      out[4] = m * lerp2(v, t.fx, t.fy);
    }
  }
  for (int c = 0; c < 3; ++c) rgb[(bn * 3 + c) * plane + at] = out[c];
  logit_out[pix] = out[3];
  if (SIGMA) sigma_out[pix] = out[4];
}

constexpr int kBwdThreads = 128;
constexpr int kBwdMinBlocks = 12;   // blocks an SM: at most 40 registers

// The taps of one sample in 32-bit plane offsets, for the backward.
struct Taps32 {
  int off[4];   // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
  bool in[4];
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ Taps32 make_taps32(float xs, float ys, int H, int W) {
  Taps32 t;
  const float x0f = floorf(xs), y0f = floorf(ys);
  t.fx = xs - x0f;
  t.fy = ys - y0f;
  t.x0 = (int)x0f;                          // in [-1, W - 1]
  t.y0 = (int)y0f;                          // in [-1, H - 1]
  const bool inx[2] = {t.x0 >= 0, t.x0 + 1 < W};
  const bool iny[2] = {t.y0 >= 0, t.y0 + 1 < H};
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    t.in[k] = iny[dy] && inx[dx];
    t.off[k] = (t.y0 + dy) * W + (t.x0 + dx);
  }
  return t;
}

__device__ __forceinline__ void corners32(const float* __restrict__ img, const Taps32& t,
                                          float v[4]) {
  for (int k = 0; k < 4; ++k) v[k] = t.in[k] ? __ldg(img + t.off[k]) : 0.f;
}

// One thread an output element of a row segment: grid (segments, H, planes
// of this launch), so the blocks in flight cover a plane or two and its
// gathers and scatter stay in L2.  With sigma the lanes combine their shared
// taps before the atomics (COMBINE).
template <bool SIGMA>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
warp2d_bwd_kernel(const float* __restrict__ src, const float* __restrict__ logits,
                  const float* __restrict__ sigma, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ mask,
                  const float* __restrict__ g_rgb, const float* __restrict__ g_logit,
                  const float* __restrict__ g_sigma, float* __restrict__ d_logits,
                  float* __restrict__ d_sigma, float* __restrict__ d_dx,
                  float* __restrict__ d_dy, int N, int H, int W) {
  constexpr bool COMBINE = SIGMA;
  const int x = blockIdx.x * kBwdThreads + threadIdx.x;
  if (!COMBINE && x >= W) return;
  const int y = blockIdx.y;
  const int bn = blockIdx.z;
  const int plane = H * W;                   // < 2^31: the wrapper checks
  const int64_t base = (int64_t)bn * plane;
  const int at = y * W + x;
  float* dlp = d_logits + base;
  float* dsp = SIGMA ? d_sigma + base : nullptr;
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
      const float* srcb = src + (int64_t)(bn / N) * 3 * plane;
      const float* grp = g_rgb + 3 * base + at;
      float v[4];
      for (int c = 0; c < 3; ++c) {
        corners32(srcb + c * plane, t, v);
        add_coord_grads(v, m * grp[c * plane], t.fx, t.fy, gx, gy);
      }
      const float gl = m * g_logit[base + at];
      corners32(logits + base, t, v);
      add_coord_grads(v, gl, t.fx, t.fy, gx, gy);
      float gs = 0.f;
      if (SIGMA) {
        gs = m * g_sigma[base + at];
        corners32(sigma + base, t, v);
        add_coord_grads(v, gs, t.fx, t.fy, gx, gy);
      }
      for (int k = 0; k < 4; ++k) {
        const float w = t.in[k] ? ((k & 1) ? t.fx : 1.f - t.fx) *
                                      ((k & 2) ? t.fy : 1.f - t.fy)
                                : 0.f;
        wl[k] = w * gl;
        ws[k] = w * gs;
        if (!COMBINE && t.in[k]) {
          atomicAdd(dlp + t.off[k], wl[k]);
          if (SIGMA) atomicAdd(dsp + t.off[k], ws[k]);
        }
      }
    }
    d_dx[base + at] = gx;
    d_dy[base + at] = gy;
  }
  if (!COMBINE) return;
  // Where the previous lane's sample has its taps one column to the left in
  // the same rows (a smooth warp's usual case), its right taps are this
  // lane's left ones: this lane adds both, that lane skips them.  The key
  // (y0 + 1)(W + 2) + x0 + 1 keeps a row's keys apart from the next row's.
  const int lane = threadIdx.x & 31;
  const int key = live ? (t.y0 + 1) * (W + 2) + t.x0 + 1 : -2;
  const bool take = __shfl_up_sync(0xffffffffu, key, 1) + 1 == key && lane > 0;
  const float up0 = __shfl_up_sync(0xffffffffu, wl[1], 1);
  const float up1 = __shfl_up_sync(0xffffffffu, wl[3], 1);
  const float up2 = __shfl_up_sync(0xffffffffu, ws[1], 1);
  const float up3 = __shfl_up_sync(0xffffffffu, ws[3], 1);
  const bool skip = __shfl_down_sync(0xffffffffu, (int)take, 1) && lane < 31;
  if (!live) return;
  if (take) {
    wl[0] += up0;
    wl[2] += up1;
    ws[0] += up2;
    ws[2] += up3;
  }
  for (int k = 0; k < 4; ++k) {
    if (!t.in[k] || ((k & 1) && skip)) continue;
    atomicAdd(dlp + t.off[k], wl[k]);
    if (SIGMA) atomicAdd(dsp + t.off[k], ws[k]);
  }
}

}  // namespace

// src: (B, 3, H, W); logits, sigma, dx, dy, mask: (B, N, H, W); outputs rgb:
// (B, N, 3, H, W), logit_out, sigma_out: (B, N, H, W); all f32 contiguous,
// every output element written.  With with_sigma 0, sigma and sigma_out may
// be null and are not touched.  Refuses N or H above 65535 (the grid's z and
// y axes) with cudaErrorInvalidValue.  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launches.
extern "C" int pdt_warp2d_fwd(const float* src, const float* logits, const float* sigma,
                              const float* dx, const float* dy, const float* mask,
                              float* rgb, float* logit_out, float* sigma_out,
                              int B, int N, int H, int W, int with_sigma, void* stream) {
  if (N > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const int64_t plane = (int64_t)H * W;
  const int images = 65535 / N;              // whole images a launch
  for (int b0 = 0; b0 < B; b0 += images) {
    const int nb = std::min(images, B - b0);
    const int64_t o = (int64_t)b0 * N * plane;
    const dim3 grid((W + kThreads - 1) / kThreads, H, nb * N);
    const float* s = src + (int64_t)b0 * 3 * plane;
    if (with_sigma)
      warp2d_fwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          s, logits + o, sigma + o, dx + o, dy + o, mask + o, rgb + 3 * o, logit_out + o,
          sigma_out + o, N, H, W);
    else
      warp2d_fwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          s, logits + o, nullptr, dx + o, dy + o, mask + o, rgb + 3 * o, logit_out + o,
          nullptr, N, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// Inputs as pdt_warp2d_fwd's plus the cotangents g_rgb: (B, N, 3, H, W),
// g_logit, g_sigma: (B, N, H, W).  d_logits and d_sigma (B, N, H, W) must be
// zeroed by the caller (the kernel adds into them); d_dx, d_dy (B, N, H, W)
// are written.  With with_sigma 0, sigma, g_sigma and d_sigma may be null
// and are not touched.  Refuses N or H above 65535 with
// cudaErrorInvalidValue.  Launches on `stream`; returns cudaGetLastError().
extern "C" int pdt_warp2d_bwd(const float* src, const float* logits, const float* sigma,
                              const float* dx, const float* dy, const float* mask,
                              const float* g_rgb, const float* g_logit,
                              const float* g_sigma, float* d_logits, float* d_sigma,
                              float* d_dx, float* d_dy, int B, int N, int H, int W,
                              int with_sigma, void* stream) {
  if (N > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t plane = (int64_t)H * W;
  const int images = 65535 / N;              // whole images a launch
  for (int b0 = 0; b0 < B; b0 += images) {
    const int nb = std::min(images, B - b0);
    const int64_t o = (int64_t)b0 * N * plane;
    const dim3 grid((W + kBwdThreads - 1) / kBwdThreads, H, nb * N);
    const float* s = src + (int64_t)b0 * 3 * plane;
    if (with_sigma)
      warp2d_bwd_kernel<true><<<grid, kBwdThreads, 0, st>>>(
          s, logits + o, sigma + o, dx + o, dy + o, mask + o, g_rgb + 3 * o, g_logit + o,
          g_sigma + o, d_logits + o, d_sigma + o, d_dx + o, d_dy + o, N, H, W);
    else
      warp2d_bwd_kernel<false><<<grid, kBwdThreads, 0, st>>>(
          s, logits + o, nullptr, dx + o, dy + o, mask + o, g_rgb + 3 * o, g_logit + o,
          nullptr, d_logits + o, nullptr, d_dx + o, d_dy + o, N, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// The backward kernel as the compiler and the occupancy calculator see it:
// out = {registers, spill bytes, threads a block, blocks an SM}.
extern "C" int pdt_warp2d_bwd_kernel_info(int with_sigma, int* out) {
  const void* fn = with_sigma ? (const void*)warp2d_bwd_kernel<true>
                              : (const void*)warp2d_bwd_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBwdThreads, 0);
  const int vals[4] = {attr.numRegs, (int)attr.localSizeBytes, kBwdThreads, blocks};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  return (int)e;
}
