// Expected-disparity head: softmax + mixture reweight + contraction, and its
// adjoint.
//
// The forward replaces planedepth_tpu/ops/pallas_disp.py:_disp_fwd_kernel
// (the TPU kernel behind disp_head_fwd).  Per output pixel (b, h, x), over N planes:
//   p = softmax(l);  u_n = p_n * m_n / s_n;  U = sum u;  D = sum u_n * d_n
//   disp = U > 1e-7 ? D / max(U, 1e-7) : 0
// with U and D normalised by the softmax sum exactly as the TPU kernel
// computes them, so the guard compares the same quantity.  Logits arrive
// already multiplied by the padding mask: masked planes enter the softmax
// with logit 0.
//
// Bound: device memory.  Each pixel reads 2*N floats (logits and sigma,
// 504 B at N = 63) and writes one; at (8, 63, 384, 1280) that is ~2.0 GB
// read.  Design: one thread per pixel, threads along W so every plane read
// of the (B, N, H, W) operands is coalesced; the row's N plane disparities
// and mask values (constant along W) sit in shared memory, loaded once per
// block; the softmax is online (one running max, the three sums rescaled
// when it grows) so each operand is read exactly once and nothing but disp
// is written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1e-7f;

__global__ void disp_head_fwd_kernel(const float* __restrict__ logits,
                                     const float* __restrict__ sigma,
                                     const float* __restrict__ disp_rows,
                                     const float* __restrict__ mask_rows,
                                     float* __restrict__ out,
                                     int N, int H, int W) {
  extern __shared__ float smem[];
  float* d_row = smem;        // N plane disparities of row (b, h)
  float* m_row = smem + N;    // N mask values of row (b, h)

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const int64_t row = (int64_t)b * H + h;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    d_row[n] = disp_rows[row * N + n];
    m_row[n] = mask_rows[row * N + n];
  }
  __syncthreads();
  if (x >= W) return;

  const int64_t plane = (int64_t)H * W;
  const int64_t pix = (int64_t)b * N * plane + (int64_t)h * W + x;
  const float* lp = logits + pix;
  const float* sp = sigma + pix;

  // Online softmax: mx is the running max; se, us, ud are sum e, sum u and
  // sum u*d relative to it.  One exp per plane: t = exp(-|l - mx|) is
  // either the new term's weight or the old sums' rescale factor.
  float mx = -INFINITY, se = 0.f, us = 0.f, ud = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const float l = __ldg(lp + n * plane);
    const float s = __ldg(sp + n * plane);
    const float dl = l - mx;
    const float t = expf(-fabsf(dl));
    const bool grow = dl > 0.f;
    const float keep = grow ? t : 1.f;
    const float e = grow ? 1.f : t;
    mx = grow ? l : mx;
    const float u = e * m_row[n] / s;
    se = se * keep + e;
    us = us * keep + u;
    ud = ud * keep + u * d_row[n];
  }
  const float U = us / se;
  const float D = ud / se;
  out[(int64_t)b * plane + (int64_t)h * W + x] =
      U > kEps ? D / fmaxf(U, kEps) : 0.f;
}

// The adjoint (planedepth_tpu/ops/pallas_disp.py:_disp_bwd_kernel, behind
// disp_head_bwd).  With g = d(disp) and the forward's quantities, per pixel:
//   du_n = g (d_n - disp) / U,  dp_n = du_n m_n / s_n,  S = sum_n dp_n p_n
//   d_logits_n = p_n (dp_n - S),  d_sigma_n = -du_n u_n / s_n
//   d_disp_rows[b, h, n] = sum_x g u_n / U
// and every adjoint is 0 where U <= 1e-7 (the forward's guard).
//
// Bound: device memory.  Each pixel reads logits and sigma (2N floats) and
// g, and writes d_logits and d_sigma (2N floats); at (8, 63, 192, 640) that
// is ~0.99 GB, ~0.30 ms at 3.35 TB/s.  Design: one block per image row
// (b, h), its threads along W in a loop, so the per-row reduction over x of
// d_disp_rows stays inside the block: each thread keeps its own running sum
// per plane in a shared-memory column (N x kBwdThreads floats), and at the
// end one warp per plane adds the columns in a fixed order (a fixed
// sequence of lane sums, then a butterfly) -- deterministic, no atomics.
// Three passes over the planes per pixel: the online softmax of the forward
// (max and the three sums), the sum S, then the outputs.  The second and
// third re-read logits and sigma, which the row's block has just read (the
// row's 2 N W floats, 322 KB at N = 63, W = 640, mostly still in L2);
// keeping p in registers would take N of them per thread.
constexpr int kBwdThreads = 128;
// The most planes that fit: (2 + kBwdThreads) N floats of shared memory
// within the default 48 KB a launch may take without an opt-in.
constexpr int kBwdMaxPlanes = 48 * 1024 / ((2 + kBwdThreads) * (int)sizeof(float));

__global__ void disp_head_bwd_kernel(const float* __restrict__ logits,
                                     const float* __restrict__ sigma,
                                     const float* __restrict__ disp_rows,
                                     const float* __restrict__ mask_rows,
                                     const float* __restrict__ g,
                                     float* __restrict__ d_logits,
                                     float* __restrict__ d_sigma,
                                     float* __restrict__ d_rows,
                                     int N, int H, int W) {
  extern __shared__ float smem[];
  float* d_row = smem;                    // N plane disparities of the row
  float* m_row = smem + N;                // N mask values
  float* acc = smem + 2 * N;              // acc[n * kBwdThreads + tid]

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t row = (int64_t)b * H + h;
  for (int n = tid; n < N; n += kBwdThreads) {
    d_row[n] = disp_rows[row * N + n];
    m_row[n] = mask_rows[row * N + n];
  }
  for (int n = 0; n < N; ++n) acc[n * kBwdThreads + tid] = 0.f;
  __syncthreads();

  const int64_t plane = (int64_t)H * W;
  for (int x = tid; x < W; x += kBwdThreads) {
    const int64_t pix = (int64_t)b * N * plane + (int64_t)h * W + x;
    const float* lp = logits + pix;
    const float* sp = sigma + pix;

    float mx = -INFINITY, se = 0.f, us = 0.f, ud = 0.f;
    for (int n = 0; n < N; ++n) {
      const float l = lp[n * plane];
      const float s = sp[n * plane];
      const float dl = l - mx;
      const float t = expf(-fabsf(dl));
      const bool grow = dl > 0.f;
      const float keep = grow ? t : 1.f;
      const float e = grow ? 1.f : t;
      mx = grow ? l : mx;
      const float u = e * m_row[n] / s;
      se = se * keep + e;
      us = us * keep + u;
      ud = ud * keep + u * d_row[n];
    }
    const float inv_se = 1.f / se;
    const float U = us * inv_se;
    const bool live = U > kEps;
    const float disp = live ? (ud * inv_se) / fmaxf(U, kEps) : 0.f;
    const float gU = live ? g[row * W + x] / fmaxf(U, kEps) : 0.f;

    float S = 0.f;
    for (int n = 0; n < N; ++n) {
      const float p = expf(lp[n * plane] - mx) * inv_se;
      S += gU * (d_row[n] - disp) * m_row[n] / sp[n * plane] * p;
    }
    for (int n = 0; n < N; ++n) {
      const float p = expf(lp[n * plane] - mx) * inv_se;
      const float s = sp[n * plane];
      const float u = p * m_row[n] / s;
      const float du = gU * (d_row[n] - disp);
      const float dp = du * m_row[n] / s;
      d_logits[pix + n * plane] = p * (dp - S);
      d_sigma[pix + n * plane] = -du * u / s;
      acc[n * kBwdThreads + tid] += gU * u;
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int n = tid >> 5; n < N; n += kBwdThreads / 32) {
    float v = 0.f;
    for (int k = lane; k < kBwdThreads; k += 32) v += acc[n * kBwdThreads + k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) d_rows[row * N + n] = v;
  }
}

}  // namespace

// logits, sigma: (B, N, H, W) f32 contiguous; disp_rows, mask_rows: (B, H, N)
// f32 contiguous; out: (B, 1, H, W) f32.  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() of the launch.
extern "C" int pdt_disp_head_fwd(const float* logits, const float* sigma,
                                 const float* disp_rows, const float* mask_rows,
                                 float* out, int B, int N, int H, int W,
                                 void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  const size_t smem = 2 * (size_t)N * sizeof(float);
  disp_head_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      logits, sigma, disp_rows, mask_rows, out, N, H, W);
  return (int)cudaGetLastError();
}

// Inputs as pdt_disp_head_fwd's, plus g: (B, 1, H, W) f32; outputs d_logits,
// d_sigma: (B, N, H, W) and d_rows: (B, H, N), f32 contiguous, each element
// written.  Refuses N above pdt_disp_head_bwd_max_planes() with
// cudaErrorInvalidValue.  Launches on `stream`; returns cudaGetLastError().
extern "C" int pdt_disp_head_bwd(const float* logits, const float* sigma,
                                 const float* disp_rows, const float* mask_rows,
                                 const float* g, float* d_logits, float* d_sigma,
                                 float* d_rows, int B, int N, int H, int W,
                                 void* stream) {
  if (N > kBwdMaxPlanes) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  const size_t smem = (2 + (size_t)kBwdThreads) * N * sizeof(float);
  disp_head_bwd_kernel<<<grid, kBwdThreads, smem, (cudaStream_t)stream>>>(
      logits, sigma, disp_rows, mask_rows, g, d_logits, d_sigma, d_rows, N, H, W);
  return (int)cudaGetLastError();
}

extern "C" int pdt_disp_head_bwd_max_planes() { return kBwdMaxPlanes; }
