// The plane heads' epilogue, forward and backward: the padding mask on the
// logits and the mixture sigma's clip(sigmoid(x), 0.01, 1).
//
// Replaces planedepth_tpu/ops/pallas_relayout.py:_fwd_kernel (behind
// relayout_pad_nchw) and :_bwd_kernel (behind relayout_nhwc).  On the TPU
// those kernels take the raw merged head conv from its NHWC layout to the
// sweep's zero-padded NCHW operand, adding the bias and applying the sigma
// epilogue on the way, and take the cotangent back.  Here the head convs
// already write plane-first NCHW with their bias, and the plane sweep reads
// outside [0, W) as zero, so no relayout and no pad are left: what remains
// of the function is the elementwise epilogue, done in one pass each way.
//
// Forward, per element of the (B, N, H, W) heads:
//   logits = raw_l * mask          mask (B, N, H, 1) row-constant, or (B, N, H, W)
//   sigma  = clip(sigmoid(raw_s), 0.01, 1)
// Backward:
//   d_raw_l = g_l * mask
//   d_raw_s = g_s * sigma * (1 - sigma) where 0.01 < sigma < 1, else 0
// (the saved sigma decides the clip's gate; a sigmoid of exactly 0.01 before
// the clip, a set of measure zero, counts as clipped).  Without a sigma head
// (raw_s null) only the logits are computed.
//
// Bound: device memory.  Design: a grid-stride loop over 16-byte vectors of
// four neighbouring pixels of one row (W % 4 == 0 and 16-byte aligned
// pointers, checked by the host; else one pixel at a time), so every load
// and store is coalesced; the row-constant mask is one cached load per
// vector.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigma_epilogue(float x) {
  const float s = 1.f / (1.f + expf(-x));
  return s < 0.01f ? 0.01f : (s > 1.f ? 1.f : s);   // NaN passes through
}

__device__ __forceinline__ float sigma_grad(float g, float s) {
  return (s > 0.01f && s < 1.f) ? g * s * (1.f - s) : 0.f;
}

__device__ __forceinline__ float4 ld4(const float* p, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

__device__ __forceinline__ void st4(float* p, int64_t i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}

// One (4-wide when vec) group of pixels of one row: the mask values.
template <bool vec>
__device__ __forceinline__ float4 mask_of(const float* mask, int64_t e, int W,
                                          bool full) {
  if (!full) {
    const float m = __ldg(mask + e / W);
    return make_float4(m, m, m, m);
  }
  if (vec) return ld4(mask, e / 4);
  return make_float4(__ldg(mask + e), 0.f, 0.f, 0.f);
}

template <bool vec>
__global__ void head_epilogue_fwd_kernel(const float* __restrict__ raw_l,
                                         const float* __restrict__ raw_s,
                                         const float* __restrict__ mask,
                                         float* __restrict__ logits,
                                         float* __restrict__ sigma,
                                         int64_t n, int W, bool mask_full) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = vec ? n / 4 : n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups;
       i += step) {
    const int64_t e = vec ? 4 * i : i;
    const float4 m = mask_of<vec>(mask, e, W, mask_full);
    if (vec) {
      const float4 l = ld4(raw_l, i);
      st4(logits, i, make_float4(l.x * m.x, l.y * m.y, l.z * m.z, l.w * m.w));
      if (raw_s != nullptr) {
        const float4 s = ld4(raw_s, i);
        st4(sigma, i, make_float4(sigma_epilogue(s.x), sigma_epilogue(s.y),
                                  sigma_epilogue(s.z), sigma_epilogue(s.w)));
      }
    } else {
      logits[e] = __ldg(raw_l + e) * m.x;
      if (raw_s != nullptr) sigma[e] = sigma_epilogue(__ldg(raw_s + e));
    }
  }
}

template <bool vec>
__global__ void head_epilogue_bwd_kernel(const float* __restrict__ g_l,
                                         const float* __restrict__ g_s,
                                         const float* __restrict__ sigma,
                                         const float* __restrict__ mask,
                                         float* __restrict__ d_l,
                                         float* __restrict__ d_s,
                                         int64_t n, int W, bool mask_full) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t groups = vec ? n / 4 : n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups;
       i += step) {
    const int64_t e = vec ? 4 * i : i;
    const float4 m = mask_of<vec>(mask, e, W, mask_full);
    if (vec) {
      const float4 g = ld4(g_l, i);
      st4(d_l, i, make_float4(g.x * m.x, g.y * m.y, g.z * m.z, g.w * m.w));
      if (g_s != nullptr) {
        const float4 gs = ld4(g_s, i), s = ld4(sigma, i);
        st4(d_s, i, make_float4(sigma_grad(gs.x, s.x), sigma_grad(gs.y, s.y),
                                sigma_grad(gs.z, s.z), sigma_grad(gs.w, s.w)));
      }
    } else {
      d_l[e] = __ldg(g_l + e) * m.x;
      if (g_s != nullptr) d_s[e] = sigma_grad(__ldg(g_s + e), __ldg(sigma + e));
    }
  }
}

bool aligned(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

unsigned blocks_for(int64_t groups) {
  const int64_t b = (groups + kThreads - 1) / kThreads;
  return (unsigned)(b < 65536 * 16 ? b : 65536 * 16);   // grid-stride beyond
}

}  // namespace

// raw_l, logits: (B, N, H, W) f32 contiguous; raw_s, sigma: the same, or
// both null (no sigma head); mask: (B, N, H) when mask_full == 0, else
// (B, N, H, W).  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch.
extern "C" int pdt_head_epilogue_fwd(const float* raw_l, const float* raw_s,
                                     const float* mask, float* logits,
                                     float* sigma, int B, int N, int H, int W,
                                     int mask_full, void* stream) {
  const int64_t n = (int64_t)B * N * H * W;
  if (n == 0) return 0;
  const bool vec = W % 4 == 0 && aligned(raw_l) && aligned(raw_s) &&
                   aligned(logits) && aligned(sigma) && (!mask_full || aligned(mask));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    head_epilogue_fwd_kernel<true><<<blocks_for(n / 4), kThreads, 0, st>>>(
        raw_l, raw_s, mask, logits, sigma, n, W, mask_full != 0);
  } else {
    head_epilogue_fwd_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(
        raw_l, raw_s, mask, logits, sigma, n, W, mask_full != 0);
  }
  return (int)cudaGetLastError();
}

// g_l, d_l: (B, N, H, W); g_s, sigma, d_s: the same, or all null; mask as
// in the forward.
extern "C" int pdt_head_epilogue_bwd(const float* g_l, const float* g_s,
                                     const float* sigma, const float* mask,
                                     float* d_l, float* d_s, int B, int N,
                                     int H, int W, int mask_full, void* stream) {
  const int64_t n = (int64_t)B * N * H * W;
  if (n == 0) return 0;
  const bool vec = W % 4 == 0 && aligned(g_l) && aligned(g_s) && aligned(sigma) &&
                   aligned(d_l) && aligned(d_s) && (!mask_full || aligned(mask));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    head_epilogue_bwd_kernel<true><<<blocks_for(n / 4), kThreads, 0, st>>>(
        g_l, g_s, sigma, mask, d_l, d_s, n, W, mask_full != 0);
  } else {
    head_epilogue_bwd_kernel<false><<<blocks_for(n), kThreads, 0, st>>>(
        g_l, g_s, sigma, mask, d_l, d_s, n, W, mask_full != 0);
  }
  return (int)cudaGetLastError();
}
