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
//   d_logits, d_sigma (B, N, H, W): the bilinear weights scattered to the
//     four taps with atomicAdd into buffers the caller zeroed.  A warp
//     through a plane homography has no reverse window to gather over, so
//     the scatter is the simple form; the order of the f32 sums at a tap is
//     not fixed from run to run.
//   d_dx = sum_c g_c ((1 - fy)(v01 - v00) + fy (v11 - v10)), d_dy its y
//     twin, over the 5 channels, with outside taps reading 0: grid_sample's
//     gradient with respect to the grid, in pixel units.
// src and mask get no cotangent (the train step differentiates neither).
//
// Bound: device memory.  Forward: dx, dy, mask, logits, sigma read and 5
// maps written, ~2.49 GB at (8, 63, 192, 640), ~0.74 ms at 3.35 TB/s.
// Backward: 10 maps read and 4 written, ~3.47 GB, ~1.04 ms.  Without sigma:
// 8 maps forward (~1.99 GB, ~0.60 ms), 11 backward (~2.74 GB, ~0.82 ms).
// Design: one
// thread per output element, threads along W, so the loads of dx, dy, mask
// and the cotangents and every store are coalesced; the taps of a smooth
// warp are neighbours of the neighbouring threads' taps, and src (11.8 MB)
// stays in L2.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
__device__ __forceinline__ void add_coord_grads(const float v[4], float gc, const Taps& t,
                                                float& gx, float& gy) {
  gx += gc * ((1.f - t.fy) * (v[1] - v[0]) + t.fy * (v[3] - v[2]));
  gy += gc * ((1.f - t.fx) * (v[2] - v[0]) + t.fx * (v[3] - v[1]));
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

template <bool SIGMA>
__global__ void warp2d_bwd_kernel(const float* __restrict__ src,
                                  const float* __restrict__ logits,
                                  const float* __restrict__ sigma,
                                  const float* __restrict__ dx,
                                  const float* __restrict__ dy,
                                  const float* __restrict__ mask,
                                  const float* __restrict__ g_rgb,
                                  const float* __restrict__ g_logit,
                                  const float* __restrict__ g_sigma,
                                  float* __restrict__ d_logits,
                                  float* __restrict__ d_sigma,
                                  float* __restrict__ d_dx,
                                  float* __restrict__ d_dy,
                                  int N, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int bn = blockIdx.z;
  if (x >= W) return;
  const int b = bn / N;
  const int64_t plane = (int64_t)H * W;
  const int64_t at = (int64_t)y * W + x;
  const int64_t pix = bn * plane + at;

  const float xs = x + dx[pix], ys = y + dy[pix];
  const bool valid = xs > -1.f && xs < (float)W && ys > -1.f && ys < (float)H;
  const float m = valid ? mask[pix] : 0.f;
  float gx = 0.f, gy = 0.f;
  if (m != 0.f) {
    const Taps t = make_taps(xs, ys, H, W);
    float v[4];
    for (int c = 0; c < 3; ++c) {
      corners(src + ((int64_t)b * 3 + c) * plane, t, v);
      add_coord_grads(v, m * g_rgb[(bn * 3 + c) * plane + at], t, gx, gy);
    }
    const float w[4] = {(1.f - t.fx) * (1.f - t.fy), t.fx * (1.f - t.fy),
                        (1.f - t.fx) * t.fy, t.fx * t.fy};
    const float gl = m * g_logit[pix];
    corners(logits + bn * plane, t, v);
    add_coord_grads(v, gl, t, gx, gy);
    float gs = 0.f;
    if (SIGMA) {
      gs = m * g_sigma[pix];
      corners(sigma + bn * plane, t, v);
      add_coord_grads(v, gs, t, gx, gy);
    }
    for (int k = 0; k < 4; ++k) {
      if (!t.in[k]) continue;
      atomicAdd(d_logits + bn * plane + t.off[k], w[k] * gl);
      if (SIGMA) atomicAdd(d_sigma + bn * plane + t.off[k], w[k] * gs);
    }
  }
  d_dx[pix] = gx;
  d_dy[pix] = gy;
}

}  // namespace

// src: (B, 3, H, W); logits, sigma, dx, dy, mask: (B, N, H, W); outputs rgb:
// (B, N, 3, H, W), logit_out, sigma_out: (B, N, H, W); all f32 contiguous,
// every output element written.  With with_sigma 0, sigma and sigma_out may
// be null and are not touched.  Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int pdt_warp2d_fwd(const float* src, const float* logits, const float* sigma,
                              const float* dx, const float* dy, const float* mask,
                              float* rgb, float* logit_out, float* sigma_out,
                              int B, int N, int H, int W, int with_sigma, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B * N);
  if (with_sigma)
    warp2d_fwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, logits, sigma, dx, dy, mask, rgb, logit_out, sigma_out, N, H, W);
  else
    warp2d_fwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, logits, nullptr, dx, dy, mask, rgb, logit_out, nullptr, N, H, W);
  return (int)cudaGetLastError();
}

// Inputs as pdt_warp2d_fwd's plus the cotangents g_rgb: (B, N, 3, H, W),
// g_logit, g_sigma: (B, N, H, W).  d_logits and d_sigma (B, N, H, W) must be
// zeroed by the caller (the kernel adds into them); d_dx, d_dy (B, N, H, W)
// are written.  With with_sigma 0, sigma, g_sigma and d_sigma may be null
// and are not touched.  Launches on `stream`; returns cudaGetLastError().
extern "C" int pdt_warp2d_bwd(const float* src, const float* logits, const float* sigma,
                              const float* dx, const float* dy, const float* mask,
                              const float* g_rgb, const float* g_logit,
                              const float* g_sigma, float* d_logits, float* d_sigma,
                              float* d_dx, float* d_dy, int B, int N, int H, int W,
                              int with_sigma, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B * N);
  if (with_sigma)
    warp2d_bwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, logits, sigma, dx, dy, mask, g_rgb, g_logit, g_sigma, d_logits, d_sigma,
        d_dx, d_dy, N, H, W);
  else
    warp2d_bwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, logits, nullptr, dx, dy, mask, g_rgb, g_logit, nullptr, d_logits, nullptr,
        d_dx, d_dy, N, H, W);
  return (int)cudaGetLastError();
}
