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
// Forward design (float32): one thread per output element, threads along W,
// so the loads of dx, dy, mask and every store are coalesced; the taps of a
// smooth warp are neighbours of the neighbouring threads' taps, and src
// (11.8 MB) stays in L2.  The entry point launches at most 65535 planes (the
// grid's z axis) at a time, in whole images.
//
// The bf16 forward (pdt_warp2d_fwd_bf16, redesigned; its one-thread-an-
// element predecessor was this file's float32 kernel on bf16) is bound by
// its load and store instructions and their latency, not by its bytes: one
// thread an element issued 16 predicated 2-byte gathers a sample without
// sigma (4 taps x 3 rgb planes + 4 logit taps; 20 with sigma) and 4 (5)
// 2-byte stores, and bf16 saved only 9-25% of the float32 instance's time
// on half its bytes.  So the entry first packs src, once a call, pixel-
// interleaved with a zero border (pack_pixels_kernel: (B, H + 2, W + 2)
// entries of r, g, b, 0, 7.97 MB at the mono shape, in L2 while the 63
// planes of an image read it): one 8-byte load gives a tap's three
// channels, and the border reads 0 where a tap leaves the image, so the rgb
// taps need no bounds test.  Then each thread warps four adjacent columns
// of a row: one float4 load each of dx, dy and mask, one 8-byte store of
// four bf16 to each output plane; a sample's four rgb taps are four 8-byte
// loads and its head taps the 2-byte predicated loads they were (no load
// outside a plane), with 32-bit offsets within a plane.  Where W % 4 != 0
// or a float32 map or an output is not aligned to its vector, the whole
// launch loads and stores element by element.  Blocks of 32 x 4 threads
// (128 columns of 4 rows), at most 48 registers: 10 blocks, 40 warps an
// SM.  The per-sample arithmetic is the float32 kernel's (the same lerp2
// and m *), so the outputs are the parent's bit for bit.  Gathers a sample
// 16 -> 8 without sigma, 20 -> 12 with it; stores a sample 4 -> 1 (5 ->
// 1.25).  Bytes at (8, 63, 192, 640): the bound's 1.37 GB without sigma
// (1.62 GB with), plus the packing's ~14 MB.  Measured on NVIDIA H100 80GB
// HBM3, 700.00 W, the packing included, alone, scripts/compare_sweep.py's
// warp inputs: 0.5154-0.5204 ms without sigma (79% of the 0.4085 ms bound)
// against the parent's 0.8824-0.8868; 0.6401-0.6426 ms with sigma (75% of
// 0.4824) against 0.9612-0.9688; zoom 200: 0.4983-0.4998 / 0.5903-0.5960
// against 0.7867-0.7892 / 0.8535-0.8541; (4, 63, 384, 1280): 0.9845-0.9936
// / 1.2342-1.2353 against 1.7054-1.7122 / 1.8971-1.9025.  Measured and
// dropped (scripts/warp_fwd_variants.py, same card, one call: this design
// 0.5107 ms without sigma, 0.6363 with, 0.4920 at zoom 200), each slower
// without sigma or within 3% either way:
//  - a row's head tap pair one 4-byte load where it is inside and 4-byte
//    aligned, else two 2-byte loads: 0.6249 / 0.8007 / 0.5580 ms (the lanes
//    of a warp split by their taps' parity and issue both paths);
//  - src in 16-byte pairs of horizontally neighbouring pixels, a sample's
//    rgb two 16-byte loads (16 MB of scratch): 0.5196 / 0.6272 / 0.5108;
//    with two columns a thread in blocks of 64 x 2 (the first design):
//    0.5738 / 0.6735 / 0.5165;
//  - two and one columns a thread (64 x 2, 64 x 4, 128 x 1 threads):
//    0.5428 / 0.7276, 0.5322 / 0.7191, 0.6606 / 0.7911 ms;
//  - no minimum of blocks an SM (48 / 40 registers), 12 blocks (40):
//    0.5388 / 0.6340, 0.5401 / 0.6580; blocks of 32 x 8 and 16 x 8 threads:
//    0.5243 / 0.6171, 0.5097 / 0.6418;
//  - streaming cache hints on dx, dy, mask and the stores: 0.5599 / 0.6881.
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
//
// Element types.  The float32 kernels are templates on T, the type of src,
// the plane heads and the three warped stacks (and of their cotangents):
// float, or bf16, the JAX package's default arithmetic (pallas_warp2d.py:
// 369-370, 505, 516, 532: bf16 stacks from bf16 operands); the bf16 forward
// (above) and the bf16 backward's tile kernel are kernels of their own.  A
// bf16 kernel widens every load to float and rounds each stored stack
// element to bf16 (nearest even); dx, dy, mask, d_dx and d_dy stay float32.
// Its bytes are the float instance's less half of src, the heads and the
// stacks.
//
// The bf16 backward (pdt_warp2d_bwd_bf16) sums the taps in float32 as the JAX
// kernel does (pallas_warp2d.py:_bwd_kernel's float32 d_ls block, rounded
// once by _w2d_bwd), in a scratch the entry clears, then rounds them into the
// bf16 d_logits and d_sigma, each element written once.  With sigma a tap's
// logit and sigma sums sit side by side, (B, N, H, W, 2), so one
// red.global.add.v2.f32 adds both where the float instance issues two scalar
// atomics, and the lanes of a 16 x 2 tile combine the taps they share across
// rows as well as along them (warp2d_bwd_tile_kernel); without sigma
// warp2d_bwd_kernel<false, bf16> adds into a (B, N, H, W) scratch.  The
// rounding pass reads the sums 16 bytes a load.  Bytes at (8, 63, 192, 640):
// the bound's 2.36 GB with sigma (1.99 GB without) plus the scratch's
// clearing, its atomics' lines and its read-back, ~1.49 GB (~0.74 GB).
// Measured on NVIDIA H100 80GB HBM3, 700 W, at (8, 63, 192, 640),
// scripts/compare_sweep.py's warp inputs, alone (the entry, its clearing
// included): 2.10-2.13 ms with sigma and 1.42-1.44 ms without, against an
// earlier design's float32 atomics into two caller-zeroed maps and a rounding
// pass, 2.25-2.29 ms and 1.40-1.43 ms alone, 2.39-2.41 ms and 1.47-1.48 ms
// with the zeroing.  Measured and dropped (scripts/warp_bwd_variants.py, same
// card; 2.10 and 1.43 ms for this design in that call):
//  - the sums of each plane in one slot of a ring of 16 L2-resident plane
//    slots, rounded and cleared inside the same launch, work taken in
//    tickets from a counter, every wait on earlier tickets' counts: 2.67 ms
//    with sigma, 2.28 without; with no waits and no counts at all (wrong
//    sums, a probe of the floor) still 2.31 and 1.74.  Polling the counts
//    with acquire loads invalidates the SM's L1, which holds the gathers,
//    and one counter line serialises every count: both were slower still;
//    a slot read and cleared in the same ticket stalls on the load;
//  - tiles of 1 x 32 and 4 x 8 lanes: 2.14 and 2.24 ms (the taller tile
//    issues fewer reductions but loads partial sectors).
#include <cuda_bf16.h>
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

__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The four corner values v00, v01, v10, v11 of `img` (0 outside).
template <typename T>
__device__ __forceinline__ void corners(const T* __restrict__ img, const Taps& t,
                                        float v[4]) {
  for (int k = 0; k < 4; ++k) v[k] = t.in[k] ? ldg_f(img + t.off[k]) : 0.f;
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
// T: the type of src, the heads and the three outputs.
template <bool SIGMA, typename T>
__global__ void warp2d_fwd_kernel(const T* __restrict__ src,
                                  const T* __restrict__ logits,
                                  const T* __restrict__ sigma,
                                  const float* __restrict__ dx,
                                  const float* __restrict__ dy,
                                  const float* __restrict__ mask,
                                  T* __restrict__ rgb,
                                  T* __restrict__ logit_out,
                                  T* __restrict__ sigma_out,
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
  for (int c = 0; c < 3; ++c) rgb[(bn * 3 + c) * plane + at] = from_f<T>(out[c]);
  logit_out[pix] = from_f<T>(out[3]);
  if (SIGMA) sigma_out[pix] = from_f<T>(out[4]);
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

template <typename T>
__device__ __forceinline__ void corners32(const T* __restrict__ img, const Taps32& t,
                                          float v[4]) {
  for (int k = 0; k < 4; ++k) v[k] = t.in[k] ? ldg_f(img + t.off[k]) : 0.f;
}

// One thread an output element of a row segment: grid (segments, H, planes
// of this launch), so the blocks in flight cover a plane or two and its
// gathers and scatter stay in L2.  With sigma the lanes combine their shared
// taps before the atomics (COMBINE).  T: the type of src, the heads and the
// cotangents; d_logits and d_sigma are float32 sums in either type.
template <bool SIGMA, typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
warp2d_bwd_kernel(const T* __restrict__ src, const T* __restrict__ logits,
                  const T* __restrict__ sigma, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ mask,
                  const T* __restrict__ g_rgb, const T* __restrict__ g_logit,
                  const T* __restrict__ g_sigma, float* __restrict__ d_logits,
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
      const T* srcb = src + (int64_t)(bn / N) * 3 * plane;
      const T* grp = g_rgb + 3 * base + at;
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

// The bf16 backward with sigma on a tile of ROWS rows a warp (32 / ROWS
// columns each; four warps side by side a block), so that vertically
// neighbouring lanes also share taps: in a smooth warp a sample's bottom
// taps are the top taps of the sample below.  Each lane below takes the
// bottom taps of the lane above where they fall on its own top taps; then
// each lane takes its left neighbour's right taps within the row (as
// warp2d_bwd_kernel's lanes do; the bottom-right one only where it still
// holds its own bottom-left one), and only the lanes left holding a tap add
// it, one v2 reduction a tap for the logit and sigma sums side by side:
// about 1.6 reductions a sample at ROWS = 2 (16 x 2 lanes), against about 2
// on one row of 32.  The per-sample arithmetic, d_dx and d_dy are
// warp2d_bwd_kernel's.
constexpr int kTileRows = 2;   // rows a warp's tile

template <int ROWS>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
warp2d_bwd_tile_kernel(const __nv_bfloat16* __restrict__ src,
                       const __nv_bfloat16* __restrict__ logits,
                       const __nv_bfloat16* __restrict__ sigma, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ g_rgb,
                       const __nv_bfloat16* __restrict__ g_logit,
                       const __nv_bfloat16* __restrict__ g_sigma, float* __restrict__ acc,
                       float* __restrict__ d_dx, float* __restrict__ d_dy, int N, int H,
                       int W) {
  using T = __nv_bfloat16;
  constexpr int COLS = 32 / ROWS;            // columns a warp
  const int lane = threadIdx.x & 31;
  const int col = lane % COLS, row = lane / COLS;
  const int x = (blockIdx.x * (kBwdThreads / 32) + (threadIdx.x >> 5)) * COLS + col;
  const int y = blockIdx.y * ROWS + row;
  const int bn = blockIdx.z;
  const int plane = H * W;                   // < 2^31: the wrapper checks
  const int64_t base = (int64_t)bn * plane;
  const int at = y * W + x;
  float* accp = acc + 2 * base;
  Taps32 t;
  float wl[4] = {0.f, 0.f, 0.f, 0.f}, ws[4] = {0.f, 0.f, 0.f, 0.f};
  bool live = false;
  if (x < W && y < H) {
    const float xs = x + dx[base + at], ys = y + dy[base + at];
    const bool valid = xs > -1.f && xs < (float)W && ys > -1.f && ys < (float)H;
    const float m = valid ? mask[base + at] : 0.f;
    float gx = 0.f, gy = 0.f;
    if (m != 0.f) {
      live = true;
      t = make_taps32(xs, ys, H, W);
      const T* srcb = src + (int64_t)(bn / N) * 3 * plane;
      const T* grp = g_rgb + 3 * base + at;
      float v[4];
      for (int c = 0; c < 3; ++c) {
        corners32(srcb + c * plane, t, v);
        add_coord_grads(v, m * to_f(grp[c * plane]), t.fx, t.fy, gx, gy);
      }
      const float gl = m * to_f(g_logit[base + at]);
      corners32(logits + base, t, v);
      add_coord_grads(v, gl, t.fx, t.fy, gx, gy);
      const float gs = m * to_f(g_sigma[base + at]);
      corners32(sigma + base, t, v);
      add_coord_grads(v, gs, t.fx, t.fy, gx, gy);
      for (int k = 0; k < 4; ++k) {
        const float w = t.in[k] ? ((k & 1) ? t.fx : 1.f - t.fx) *
                                      ((k & 2) ? t.fy : 1.f - t.fy)
                                : 0.f;
        wl[k] = w * gl;
        ws[k] = w * gs;
      }
    }
    d_dx[base + at] = gx;
    d_dy[base + at] = gy;
  }
  // (y0 + 1)(W + 2) + x0 + 1 keeps a row's keys apart from the next row's; a
  // lane without taps holds a key no neighbour's can match
  const int key = live ? (t.y0 + 1) * (W + 2) + t.x0 + 1 : -(1 << 30);
  // the lane above's bottom taps, where they are this lane's top taps
  const bool vtake = __shfl_up_sync(0xffffffffu, key, COLS) + (W + 2) == key && row > 0;
  const float a2 = __shfl_up_sync(0xffffffffu, wl[2], COLS);
  const float a3 = __shfl_up_sync(0xffffffffu, wl[3], COLS);
  const float b2 = __shfl_up_sync(0xffffffffu, ws[2], COLS);
  const float b3 = __shfl_up_sync(0xffffffffu, ws[3], COLS);
  const bool vgive = __shfl_down_sync(0xffffffffu, (int)vtake, COLS) && row < ROWS - 1;
  if (vtake) {
    wl[0] += a2;
    wl[1] += a3;
    ws[0] += b2;
    ws[1] += b3;
  }
  if (vgive) {
    wl[2] = wl[3] = ws[2] = ws[3] = 0.f;
  }
  // then the left neighbour's right taps, within the row: its top-right
  // tap always (this lane's top-left one stays), its bottom-right one only
  // where this lane still holds its own bottom-left one
  const bool htake = __shfl_up_sync(0xffffffffu, key, 1) + 1 == key && col > 0;
  const bool htake3 = htake && !vgive;
  const float c1 = __shfl_up_sync(0xffffffffu, wl[1], 1);
  const float c3 = __shfl_up_sync(0xffffffffu, wl[3], 1);
  const float d1 = __shfl_up_sync(0xffffffffu, ws[1], 1);
  const float d3 = __shfl_up_sync(0xffffffffu, ws[3], 1);
  const bool give1 = __shfl_down_sync(0xffffffffu, (int)htake, 1) && col < COLS - 1;
  const bool give3 = __shfl_down_sync(0xffffffffu, (int)htake3, 1) && col < COLS - 1;
  if (!live) return;
  if (htake) {
    wl[0] += c1;
    ws[0] += d1;
  }
  if (htake3) {
    wl[2] += c3;
    ws[2] += d3;
  }
  const bool gone[4] = {false, give1, vgive, vgive || give3};
  for (int k = 0; k < 4; ++k) {
    if (!t.in[k] || gone[k]) continue;
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(accp + 2 * t.off[k]),
                 "f"(wl[k]), "f"(ws[k])
                 : "memory");
  }
}

// Rounds the accumulator into the bf16 d_logits (and d_sigma), four pixels a
// thread: 16-byte loads, 4-byte bf16 pair stores (n a multiple of 4, the
// outputs 8-byte aligned: the entry checks; else one pixel a thread).
template <bool SIGMA, bool VEC>
__global__ void round_sums_kernel(const float* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ d_logits,
                                  __nv_bfloat16* __restrict__ d_sigma, int64_t n) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * (VEC ? 4 : 1);
  if (i >= n) return;
  if (!VEC) {
    d_logits[i] = __float2bfloat16_rn(acc[(SIGMA ? 2 : 1) * i]);
    if (SIGMA) d_sigma[i] = __float2bfloat16_rn(acc[2 * i + 1]);
    return;
  }
  auto* dl = reinterpret_cast<__nv_bfloat162*>(d_logits + i);
  if (SIGMA) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(acc + 2 * i));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(acc + 2 * i) + 1);
    auto* ds = reinterpret_cast<__nv_bfloat162*>(d_sigma + i);
    dl[0] = __floats2bfloat162_rn(a.x, a.z);
    dl[1] = __floats2bfloat162_rn(b.x, b.z);
    ds[0] = __floats2bfloat162_rn(a.y, a.w);
    ds[1] = __floats2bfloat162_rn(b.y, b.w);
  } else {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(acc + i));
    dl[0] = __floats2bfloat162_rn(a.x, a.y);
    dl[1] = __floats2bfloat162_rn(a.z, a.w);
  }
}

int64_t bf16_bwd_scratch_bytes(int B, int N, int H, int W, int with_sigma) {
  return (int64_t)B * N * H * W * (with_sigma ? 2 : 1) * (int64_t)sizeof(float);
}

// The bf16 forward.  Its source is packed once a call, pixel-interleaved
// with a zero border: entry (b, yy, xx) of a (B, H + 2, W + 2) grid holds
// pixel (yy - 1, xx - 1) of image b as r, g, b, 0 (8 bytes), every channel 0
// outside the image, so that one 8-byte load gives a tap's three channels
// and a sample's four taps, at entries (y0 + 1, x0 + 1) to (y0 + 2, x0 + 2),
// need no bounds test.  A thread warps kFwdCols adjacent columns of one row.
constexpr int kFwdCols = 4;                       // columns a thread
constexpr int kFwdLanes = 32;                     // threads along a row
constexpr int kFwdRows = 4;                       // rows a block
constexpr int kFwdThreads = kFwdLanes * kFwdRows;
constexpr int kFwdMinBlocks = 10;                 // blocks an SM: at most 48 registers
constexpr int kPackThreads = 256;

int64_t bf16_fwd_scratch_bytes(int B, int H, int W) {
  return (int64_t)B * (H + 2) * (W + 2) * (int64_t)sizeof(uint2);
}

__global__ void pack_pixels_kernel(const __nv_bfloat16* __restrict__ src,
                                   uint2* __restrict__ pix, int H, int W, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kPackThreads + threadIdx.x;
  if (i >= n) return;
  const int img = (H + 2) * (W + 2);              // < 2^31: the entry checks
  const int64_t b = i / img;
  const int j = (int)(i - b * img);
  const int y = j / (W + 2) - 1, x = j % (W + 2) - 1;
  unsigned int c[3] = {0u, 0u, 0u};
  if (y >= 0 && y < H && x >= 0 && x < W) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src) + b * 3 * H * W;
    for (int ch = 0; ch < 3; ++ch) c[ch] = __ldg(s + ((int64_t)ch * H + y) * W + x);
  }
  pix[i] = make_uint2(c[0] | c[1] << 16, c[2]);
}

// bf16 bits in the low or high half of a word, widened (exactly) to float.
__device__ __forceinline__ float bf_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }

// kFwdCols floats from p (VEC: one aligned vector load), or `cnt` scalars.
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* p, int cnt, float (&v)[kFwdCols]) {
  if (VEC) {
    if constexpr (kFwdCols == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else if constexpr (kFwdCols == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = __ldg(p);
    }
    return;
  }
  for (int k = 0; k < kFwdCols; ++k) v[k] = k < cnt ? __ldg(p + k) : 0.f;
}

// kFwdCols values rounded to bf16 into p (VEC: one aligned vector store).
template <bool VEC>
__device__ __forceinline__ void store_cols(__nv_bfloat16* p, int cnt,
                                           const float (&v)[kFwdCols]) {
  if (VEC) {
    if constexpr (kFwdCols == 4) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      uint2 w;
      w.x = *reinterpret_cast<const unsigned int*>(&a);
      w.y = *reinterpret_cast<const unsigned int*>(&b);
      *reinterpret_cast<uint2*>(p) = w;
    } else if constexpr (kFwdCols == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    } else {
      *p = __float2bfloat16_rn(v[0]);
    }
    return;
  }
  for (int k = 0; k < kFwdCols; ++k)
    if (k < cnt) p[k] = __float2bfloat16_rn(v[k]);
}

// VEC: W a multiple of kFwdCols and every float32 map and output aligned to
// its vector (the entry decides), so no row ends inside a thread's columns.
template <bool SIGMA, bool VEC>
__device__ __forceinline__ void warp_fwd_bf16_cols(
    const uint2* __restrict__ pix, const __nv_bfloat16* __restrict__ lp,
    const __nv_bfloat16* __restrict__ sp, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ rgb, __nv_bfloat16* __restrict__ logit_out,
    __nv_bfloat16* __restrict__ sigma_out, int x, int y, int cnt, int H, int W,
    int64_t plane) {
  float ddx[kFwdCols], ddy[kFwdCols], mk[kFwdCols];
  load_cols<VEC>(dx, cnt, ddx);
  load_cols<VEC>(dy, cnt, ddy);
  load_cols<VEC>(mask, cnt, mk);
  float out[5][kFwdCols];
#pragma unroll
  for (int k = 0; k < kFwdCols; ++k) {
    for (int c = 0; c < 5; ++c) out[c][k] = 0.f;
    const float xs = (x + k) + ddx[k], ys = y + ddy[k];
    const bool valid = xs > -1.f && xs < (float)W && ys > -1.f && ys < (float)H;
    const float m = valid ? mk[k] : 0.f;
    if (m == 0.f) continue;
    const Taps32 t = make_taps32(xs, ys, H, W);
    const uint2* q = pix + (t.y0 + 1) * (W + 2) + (t.x0 + 1);
    const uint2 p[4] = {__ldg(q), __ldg(q + 1), __ldg(q + (W + 2)), __ldg(q + (W + 3))};
    float v[4] = {bf_lo(p[0].x), bf_lo(p[1].x), bf_lo(p[2].x), bf_lo(p[3].x)};
    out[0][k] = m * lerp2(v, t.fx, t.fy);
    for (int i = 0; i < 4; ++i) v[i] = bf_hi(p[i].x);
    out[1][k] = m * lerp2(v, t.fx, t.fy);
    for (int i = 0; i < 4; ++i) v[i] = bf_lo(p[i].y);
    out[2][k] = m * lerp2(v, t.fx, t.fy);
    corners32(lp, t, v);
    out[3][k] = m * lerp2(v, t.fx, t.fy);
    if (SIGMA) {
      corners32(sp, t, v);
      out[4][k] = m * lerp2(v, t.fx, t.fy);
    }
  }
  for (int c = 0; c < 3; ++c) store_cols<VEC>(rgb + c * plane, cnt, out[c]);
  store_cols<VEC>(logit_out, cnt, out[3]);
  if (SIGMA) store_cols<VEC>(sigma_out, cnt, out[4]);
}

// grid (column groups of kFwdLanes * kFwdCols, row groups of kFwdRows,
// planes of this launch); `pix` is the packed source of this launch's first
// image.
template <bool SIGMA>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
warp2d_fwd_bf16_kernel(const uint2* __restrict__ pix,
                       const __nv_bfloat16* __restrict__ logits,
                       const __nv_bfloat16* __restrict__ sigma, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ mask,
                       __nv_bfloat16* __restrict__ rgb, __nv_bfloat16* __restrict__ logit_out,
                       __nv_bfloat16* __restrict__ sigma_out, int N, int H, int W, int vec) {
  const int x = (blockIdx.x * kFwdLanes + threadIdx.x) * kFwdCols;
  const int y = blockIdx.y * kFwdRows + threadIdx.y;
  const int bn = blockIdx.z;                     // b * N + n
  if (x >= W || y >= H) return;
  const int64_t plane = (int64_t)H * W;
  const int64_t base = bn * plane;
  const int at = y * W + x;
  const int cnt = min(kFwdCols, W - x);
  const uint2* pp = pix + (int64_t)(bn / N) * (H + 2) * (W + 2);
  const __nv_bfloat16* sp = SIGMA ? sigma + base : nullptr;
  __nv_bfloat16* so = SIGMA ? sigma_out + base + at : nullptr;
  if (vec)
    warp_fwd_bf16_cols<SIGMA, true>(pp, logits + base, sp, dx + base + at, dy + base + at,
                                    mask + base + at, rgb + 3 * base + at,
                                    logit_out + base + at, so, x, y, cnt, H, W, plane);
  else
    warp_fwd_bf16_cols<SIGMA, false>(pp, logits + base, sp, dx + base + at, dy + base + at,
                                     mask + base + at, rgb + 3 * base + at,
                                     logit_out + base + at, so, x, y, cnt, H, W, plane);
}

// Packs src into the scratch, then warps at most 65535 planes a launch, in
// whole images.
int warp_fwd_bf16(const __nv_bfloat16* src, const __nv_bfloat16* logits,
                  const __nv_bfloat16* sigma, const float* dx, const float* dy,
                  const float* mask, __nv_bfloat16* rgb, __nv_bfloat16* logit_out,
                  __nv_bfloat16* sigma_out, void* scratch, int B, int N, int H, int W,
                  int with_sigma, cudaStream_t st) {
  if (N > 65535 || H > 65535 || (int64_t)(H + 2) * (W + 2) >= (int64_t)1 << 31 ||
      (uintptr_t)scratch % 8 != 0)
    return (int)cudaErrorInvalidValue;
  uint2* pix = (uint2*)scratch;
  const int64_t img = (int64_t)(H + 2) * (W + 2), n = B * img;
  pack_pixels_kernel<<<(unsigned)((n + kPackThreads - 1) / kPackThreads), kPackThreads, 0,
                       st>>>(src, pix, H, W, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto al = [](const void* p, int bytes) { return (uintptr_t)p % bytes == 0; };
  const int fb = 4 * kFwdCols, bb = 2 * kFwdCols;  // a vector of floats, of bf16
  const int vec = W % kFwdCols == 0 && al(dx, fb) && al(dy, fb) && al(mask, fb) &&
                  al(rgb, bb) && al(logit_out, bb) && (!with_sigma || al(sigma_out, bb));
  const int64_t plane = (int64_t)H * W;
  const int images = 65535 / N;                  // whole images a launch
  const dim3 block(kFwdLanes, kFwdRows);
  for (int b0 = 0; b0 < B; b0 += images) {
    const int nb = std::min(images, B - b0);
    const int64_t o = (int64_t)b0 * N * plane;
    const dim3 grid((W + kFwdLanes * kFwdCols - 1) / (kFwdLanes * kFwdCols),
                    (H + kFwdRows - 1) / kFwdRows, nb * N);
    if (with_sigma)
      warp2d_fwd_bf16_kernel<true><<<grid, block, 0, st>>>(
          pix + b0 * img, logits + o, sigma + o, dx + o, dy + o, mask + o, rgb + 3 * o,
          logit_out + o, sigma_out + o, N, H, W, vec);
    else
      warp2d_fwd_bf16_kernel<false><<<grid, block, 0, st>>>(
          pix + b0 * img, logits + o, nullptr, dx + o, dy + o, mask + o, rgb + 3 * o,
          logit_out + o, nullptr, N, H, W, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// registers, spill bytes, threads a block and blocks an SM of `fn`.
int kernel_info(const void* fn, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  const int vals[4] = {attr.numRegs, (int)attr.localSizeBytes, threads, blocks};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
  return (int)e;
}

template <typename T>
int warp_fwd(const T* src, const T* logits, const T* sigma, const float* dx, const float* dy,
             const float* mask, T* rgb, T* logit_out, T* sigma_out, int B, int N, int H,
             int W, int with_sigma, cudaStream_t st) {
  if (N > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const int64_t plane = (int64_t)H * W;
  const int images = 65535 / N;              // whole images a launch
  for (int b0 = 0; b0 < B; b0 += images) {
    const int nb = std::min(images, B - b0);
    const int64_t o = (int64_t)b0 * N * plane;
    const dim3 grid((W + kThreads - 1) / kThreads, H, nb * N);
    const T* s = src + (int64_t)b0 * 3 * plane;
    if (with_sigma)
      warp2d_fwd_kernel<true, T><<<grid, kThreads, 0, st>>>(
          s, logits + o, sigma + o, dx + o, dy + o, mask + o, rgb + 3 * o, logit_out + o,
          sigma_out + o, N, H, W);
    else
      warp2d_fwd_kernel<false, T><<<grid, kThreads, 0, st>>>(
          s, logits + o, nullptr, dx + o, dy + o, mask + o, rgb + 3 * o, logit_out + o,
          nullptr, N, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

template <typename T>
int warp_bwd(const T* src, const T* logits, const T* sigma, const float* dx, const float* dy,
             const float* mask, const T* g_rgb, const T* g_logit, const T* g_sigma,
             float* d_logits, float* d_sigma, float* d_dx, float* d_dy, int B, int N, int H,
             int W, int with_sigma, cudaStream_t st) {
  if (N > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const int64_t plane = (int64_t)H * W;
  const int images = 65535 / N;              // whole images a launch
  for (int b0 = 0; b0 < B; b0 += images) {
    const int nb = std::min(images, B - b0);
    const int64_t o = (int64_t)b0 * N * plane;
    const dim3 grid((W + kBwdThreads - 1) / kBwdThreads, H, nb * N);
    const T* s = src + (int64_t)b0 * 3 * plane;
    if (with_sigma)
      warp2d_bwd_kernel<true, T><<<grid, kBwdThreads, 0, st>>>(
          s, logits + o, sigma + o, dx + o, dy + o, mask + o, g_rgb + 3 * o, g_logit + o,
          g_sigma + o, d_logits + o, d_sigma + o, d_dx + o, d_dy + o, N, H, W);
    else
      warp2d_bwd_kernel<false, T><<<grid, kBwdThreads, 0, st>>>(
          s, logits + o, nullptr, dx + o, dy + o, mask + o, g_rgb + 3 * o, g_logit + o,
          nullptr, d_logits + o, nullptr, d_dx + o, d_dy + o, N, H, W);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// The bf16 backward: clears the accumulator (the scratch), scatters into it
// (at most 65535 planes a launch, in whole images: with sigma the tile
// kernel, without it warp2d_bwd_kernel's instance, whose tap sums need no
// pairing), then rounds it.
int warp_bwd_bf16(const __nv_bfloat16* src, const __nv_bfloat16* logits,
                  const __nv_bfloat16* sigma, const float* dx, const float* dy,
                  const float* mask, const __nv_bfloat16* g_rgb, const __nv_bfloat16* g_logit,
                  const __nv_bfloat16* g_sigma, __nv_bfloat16* d_logits, __nv_bfloat16* d_sigma,
                  float* d_dx, float* d_dy, void* scratch, int B, int N, int H, int W,
                  int with_sigma, cudaStream_t st) {
  if (N > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const int64_t plane = (int64_t)H * W, n = (int64_t)B * N * plane;
  const int C = with_sigma ? 2 : 1;
  float* acc = (float*)scratch;
  cudaError_t e = cudaMemsetAsync(acc, 0, bf16_bwd_scratch_bytes(B, N, H, W, with_sigma), st);
  if (e != cudaSuccess) return (int)e;
  const int images = 65535 / N;              // whole images a launch
  for (int b0 = 0; b0 < B; b0 += images) {
    const int nb = std::min(images, B - b0);
    const int64_t o = (int64_t)b0 * N * plane;
    const __nv_bfloat16* s = src + (int64_t)b0 * 3 * plane;
    if (with_sigma) {
      constexpr int cols = kBwdThreads / kTileRows;      // a block's tile columns
      const dim3 grid((W + cols - 1) / cols, (H + kTileRows - 1) / kTileRows, nb * N);
      warp2d_bwd_tile_kernel<kTileRows><<<grid, kBwdThreads, 0, st>>>(
          s, logits + o, sigma + o, dx + o, dy + o, mask + o, g_rgb + 3 * o, g_logit + o,
          g_sigma + o, acc + C * o, d_dx + o, d_dy + o, N, H, W);
    } else {                                 // warp2d_bwd_kernel's instance, into acc
      const dim3 grid((W + kBwdThreads - 1) / kBwdThreads, H, nb * N);
      warp2d_bwd_kernel<false, __nv_bfloat16><<<grid, kBwdThreads, 0, st>>>(
          s, logits + o, nullptr, dx + o, dy + o, mask + o, g_rgb + 3 * o, g_logit + o,
          nullptr, acc + o, nullptr, d_dx + o, d_dy + o, N, H, W);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const bool vec = n % 4 == 0 && (uintptr_t)d_logits % 8 == 0 &&
                   (!with_sigma || (uintptr_t)d_sigma % 8 == 0) && (uintptr_t)acc % 16 == 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)(((vec ? n / 4 : n) + threads - 1) / threads);
  if (with_sigma && vec)
    round_sums_kernel<true, true><<<blocks, threads, 0, st>>>(acc, d_logits, d_sigma, n);
  else if (with_sigma)
    round_sums_kernel<true, false><<<blocks, threads, 0, st>>>(acc, d_logits, d_sigma, n);
  else if (vec)
    round_sums_kernel<false, true><<<blocks, threads, 0, st>>>(acc, d_logits, nullptr, n);
  else
    round_sums_kernel<false, false><<<blocks, threads, 0, st>>>(acc, d_logits, nullptr, n);
  return (int)cudaGetLastError();
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
  return warp_fwd<float>(src, logits, sigma, dx, dy, mask, rgb, logit_out, sigma_out, B, N,
                         H, W, with_sigma, (cudaStream_t)stream);
}

// pdt_warp2d_fwd in bf16: src, logits, sigma and the three outputs are bf16
// (__nv_bfloat16), dx, dy and mask float32; every output element written,
// each the float32 sample rounded once to nearest even.  `scratch`: at least
// pdt_warp2d_fwd_bf16_scratch_bytes(B, H, W) bytes of device memory, 8-byte
// aligned, into which the entry packs src (contents on entry do not matter).
// Also refuses (H + 2)(W + 2) >= 2^31 and a misaligned scratch.
extern "C" int pdt_warp2d_fwd_bf16(const void* src, const void* logits, const void* sigma,
                                   const float* dx, const float* dy, const float* mask,
                                   void* rgb, void* logit_out, void* sigma_out, void* scratch,
                                   int B, int N, int H, int W, int with_sigma, void* stream) {
  using bf = __nv_bfloat16;
  return warp_fwd_bf16((const bf*)src, (const bf*)logits, (const bf*)sigma, dx, dy, mask,
                       (bf*)rgb, (bf*)logit_out, (bf*)sigma_out, scratch, B, N, H, W,
                       with_sigma, (cudaStream_t)stream);
}

// The scratch pdt_warp2d_fwd_bf16 takes: src pixel-interleaved, 8 bytes an
// entry of a (B, H + 2, W + 2) grid.
extern "C" long long pdt_warp2d_fwd_bf16_scratch_bytes(int B, int H, int W) {
  return bf16_fwd_scratch_bytes(B, H, W);
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
  return warp_bwd<float>(src, logits, sigma, dx, dy, mask, g_rgb, g_logit, g_sigma,
                         d_logits, d_sigma, d_dx, d_dy, B, N, H, W, with_sigma,
                         (cudaStream_t)stream);
}

// pdt_warp2d_bwd in bf16: src, logits, sigma, the cotangents g_rgb,
// g_logit, g_sigma and the outputs d_logits, d_sigma are bf16, each element
// of the latter written once (the float32 sum of its taps, rounded to
// nearest even); d_dx, d_dy are float32.  `scratch`: at least
// pdt_warp2d_bwd_bf16_scratch_bytes(B, N, H, W, with_sigma) bytes of device
// memory, 16-byte aligned, which the entry clears on `stream` and the
// kernels use for the float32 tap sums (contents on entry do not matter).
// Refuses N or H above 65535 with cudaErrorInvalidValue.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int pdt_warp2d_bwd_bf16(const void* src, const void* logits, const void* sigma,
                                   const float* dx, const float* dy, const float* mask,
                                   const void* g_rgb, const void* g_logit,
                                   const void* g_sigma, void* d_logits, void* d_sigma,
                                   float* d_dx, float* d_dy, void* scratch, int B, int N,
                                   int H, int W, int with_sigma, void* stream) {
  using bf = __nv_bfloat16;
  return warp_bwd_bf16((const bf*)src, (const bf*)logits, (const bf*)sigma, dx, dy, mask,
                       (const bf*)g_rgb, (const bf*)g_logit, (const bf*)g_sigma,
                       (bf*)d_logits, (bf*)d_sigma, d_dx, d_dy, scratch, B, N, H, W,
                       with_sigma, (cudaStream_t)stream);
}

// The scratch pdt_warp2d_bwd_bf16 takes: the float32 tap sums, 2 (with
// sigma) or 1 a pixel.
extern "C" long long pdt_warp2d_bwd_bf16_scratch_bytes(int B, int N, int H, int W,
                                                       int with_sigma) {
  return bf16_bwd_scratch_bytes(B, N, H, W, with_sigma);
}

// The backward kernel as the compiler and the occupancy calculator see it:
// out = {registers, spill bytes, threads a block, blocks an SM}.
extern "C" int pdt_warp2d_bwd_kernel_info(int with_sigma, int* out) {
  return kernel_info(with_sigma ? (const void*)warp2d_bwd_kernel<true, float>
                                : (const void*)warp2d_bwd_kernel<false, float>,
                     kBwdThreads, out);
}

// pdt_warp2d_bwd_kernel_info of the bf16 backward's scatter kernel.
extern "C" int pdt_warp2d_bwd_kernel_info_bf16(int with_sigma, int* out) {
  return kernel_info(with_sigma ? (const void*)warp2d_bwd_tile_kernel<kTileRows>
                                : (const void*)warp2d_bwd_kernel<false, __nv_bfloat16>,
                     kBwdThreads, out);
}

// pdt_warp2d_bwd_kernel_info of the float32 forward kernel.
extern "C" int pdt_warp2d_fwd_kernel_info(int with_sigma, int* out) {
  return kernel_info(with_sigma ? (const void*)warp2d_fwd_kernel<true, float>
                                : (const void*)warp2d_fwd_kernel<false, float>,
                     kThreads, out);
}

// pdt_warp2d_bwd_kernel_info of the bf16 forward's warp kernel.
extern "C" int pdt_warp2d_fwd_kernel_info_bf16(int with_sigma, int* out) {
  return kernel_info(with_sigma ? (const void*)warp2d_fwd_bf16_kernel<true>
                                : (const void*)warp2d_fwd_bf16_kernel<false>,
                     kFwdThreads, out);
}
