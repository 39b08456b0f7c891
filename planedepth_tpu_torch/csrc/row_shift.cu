// Per-plane row shift, forward: a signed, clipped 2-tap sample along W.
//
// Replaces planedepth_tpu/ops/pallas_shift.py:_shift_kernel (the TPU kernel
// behind rowshift_planes_fwd).  For every row (b, n, h) of the plane-first
// maps (B, N, H, W) and its shift s = clip(shift[b, h, n], -lim, lim):
//   k = floor(s), f = s - k
//   out[b, n, h, x] = (1 - f) * maps[b, n, h, x + k] + f * maps[b, n, h, x + k + 1]
// with samples outside [0, W) read as zero.  lim = round128(pad) - 2, the
// TPU kernel's clip; shifts are signed (the teacher warps by -disparity).
//
// Bound: device memory.  Each row is read once and written once (2 * W
// floats) for 3 flops a pixel; at (4, 63, 384, 1280) that is 991 MB moved.
// Design: one block per row.  The row is staged in shared memory with
// 16-byte loads, so the two taps of every output pixel (at any shift, both
// signs) are shared-memory reads, and each thread writes 4 neighbouring
// outputs with one 16-byte store: global traffic is coalesced in both
// directions whatever the shift.  Rows are sampled exactly: the TPU's
// 128-lane windows, rolls and vertical/ground split have no counterpart.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float tap(const float* row, int i, int W) {
  return (unsigned)i < (unsigned)W ? row[i] : 0.f;
}

// vec: W % 4 == 0 and both pointers 16-byte aligned (checked by the host).
template <bool vec>
__global__ void row_shift_fwd_kernel(const float* __restrict__ maps,
                                     const float* __restrict__ shift,
                                     float* __restrict__ out, int N, int H,
                                     int W, float lim) {
  extern __shared__ float row[];
  const int64_t r = blockIdx.x;               // row id (b * N + n) * H + h
  const int h = (int)(r % H);
  const int64_t bn = r / H;
  const int n = (int)(bn % N);
  const int64_t b = bn / N;
  const float* src = maps + r * W;
  float* dst = out + r * W;

  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* r4 = reinterpret_cast<float4*>(row);
    for (int i = threadIdx.x; i < W / 4; i += blockDim.x) r4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < W; i += blockDim.x) row[i] = __ldg(src + i);
  }
  const float s = fminf(fmaxf(__ldg(shift + (b * H + h) * N + n), -lim), lim);
  const float kf = floorf(s);
  const float f = s - kf;
  const int k = (int)kf;
  __syncthreads();

  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < W / 4; i += blockDim.x) {
      const int x = 4 * i + k;
      const float t0 = tap(row, x, W), t1 = tap(row, x + 1, W);
      const float t2 = tap(row, x + 2, W), t3 = tap(row, x + 3, W);
      const float t4 = tap(row, x + 4, W);
      d4[i] = make_float4((1.f - f) * t0 + f * t1, (1.f - f) * t1 + f * t2,
                          (1.f - f) * t2 + f * t3, (1.f - f) * t3 + f * t4);
    }
  } else {
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      dst[x] = (1.f - f) * tap(row, x + k, W) + f * tap(row, x + k + 1, W);
    }
  }
}

}  // namespace

// maps, out: (B, N, H, W) f32 contiguous; shift: (B, H, N) f32 contiguous.
// lim: the shift clip.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch.
extern "C" int pdt_row_shift_fwd(const float* maps, const float* shift,
                                 float* out, int B, int N, int H, int W,
                                 float lim, void* stream) {
  const int64_t rows = (int64_t)B * N * H;
  if (rows == 0 || W == 0) return 0;
  const size_t smem = (size_t)W * sizeof(float);
  const bool vec = (W % 4 == 0) && ((uintptr_t)maps % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    row_shift_fwd_kernel<true><<<(unsigned)rows, kThreads, smem, st>>>(
        maps, shift, out, N, H, W, lim);
  } else {
    row_shift_fwd_kernel<false><<<(unsigned)rows, kThreads, smem, st>>>(
        maps, shift, out, N, H, W, lim);
  }
  return (int)cudaGetLastError();
}
