// Expected-disparity head, forward: softmax + mixture reweight + contraction.
//
// Replaces planedepth_tpu/ops/pallas_disp.py:_disp_fwd_kernel (the TPU
// kernel behind disp_head_fwd).  Per output pixel (b, h, x), over N planes:
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
