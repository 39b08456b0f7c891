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
// is ~0.99 GB, ~0.30 ms at 3.35 TB/s.  No matrix product: no tensor cores.
//
// Design.  The first design took one block per row and three passes over
// the planes per pixel, each re-reading logits and sigma from global memory
// (the row's 322 KB at N = 63, W = 640, partly back from HBM), with
// loop-carried loads, full-precision expf and IEEE divisions.  Here a block
// takes a segment of kBwdTile = 128 pixels of one row (b, h), one thread a
// pixel, and copies the segment's logits and sigma of up to kBwdResident =
// 72 planes into shared memory with cp.async, every plane in flight at once
// (16-byte copies when W is a multiple of 4, else 4-byte ones; 64 KB at
// N = 63, three blocks an SM).  The passes then read shared memory: (1) the
// max, then the sums, storing e = exp(l - max) over l and 1/s over s, so
// that a pixel-plane takes one exponential and one reciprocal; (2) S; (3)
// the outputs.  exp and 1/x are ex2.approx.ftz (log2 e prescaled) and
// rcp.approx.ftz (~2 ulp).  More planes than 72 go in equal chunks of at
// most 72: then (1) is an online softmax across the chunks and every pass
// copies each chunk again.  d_disp_rows: in pass (3) each thread leaves
// g u_n / U in its own column of the staged rows, and one warp a plane sums
// the 128 columns in a fixed order (four a lane, then a butterfly) into a
// (B, H, tiles, N) scratch that a second kernel sums over the tiles in
// order (straight into d_disp_rows when W fits one tile).  No atomics: two
// runs are bit-identical.
constexpr int kBwdTile = 128;       // pixels, and threads, a block
constexpr int kBwdResident = 72;    // planes staged at once
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fexp(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v * kLog2e));
  return r;
}

__device__ __forceinline__ float frcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Copies planes [n0, n0 + nc) of the segment (lseg, sseg: plane 0's first
// pixel) into Ls, Ss ([n][kBwdTile]); columns from `cols` on get l = 0,
// s = 1.  Waits for the copies and publishes them to the block.
__device__ __forceinline__ void stage(const float* lseg, const float* sseg, int64_t plane,
                                      float* Ls, float* Ss, int n0, int nc, int cols,
                                      bool vec) {
  __syncthreads();                          // the previous chunk's readers are done
  if (vec) {
    for (int i = threadIdx.x; i < nc * (kBwdTile / 4); i += kBwdTile) {
      const int n = i / (kBwdTile / 4), col = (i % (kBwdTile / 4)) * 4;
      float* ld = Ls + n * kBwdTile + col;
      float* sd = Ss + n * kBwdTile + col;
      if (col < cols) {
        cp_async16(ld, lseg + (n0 + n) * plane + col);
        cp_async16(sd, sseg + (n0 + n) * plane + col);
      } else {
        *reinterpret_cast<float4*>(ld) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(sd) = make_float4(1.f, 1.f, 1.f, 1.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nc * kBwdTile; i += kBwdTile) {
      const int n = i / kBwdTile, col = i % kBwdTile;
      if (col < cols) {
        cp_async4(Ls + i, lseg + (n0 + n) * plane + col);
        cp_async4(Ss + i, sseg + (n0 + n) * plane + col);
      } else {
        Ls[i] = 0.f;
        Ss[i] = 1.f;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// grid.x = B * H * tiles; nc planes a chunk.  Shared memory: the row's N
// plane disparities and mask values (each padded to a multiple of 4), then
// the staged logits and sigma, nc * kBwdTile floats each.
__global__ void __launch_bounds__(kBwdTile)
disp_head_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ sigma,
                     const float* __restrict__ disp_rows, const float* __restrict__ mask_rows,
                     const float* __restrict__ g, float* __restrict__ d_logits,
                     float* __restrict__ d_sigma, float* __restrict__ partial, int N, int H,
                     int W, int tiles, int nc_max, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int npad = (N + 3) & ~3;
  float* d_row = smem;
  float* m_row = smem + npad;
  float* Ls = smem + 2 * npad;
  float* Ss = Ls + nc_max * kBwdTile;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const int64_t row = blockIdx.x / tiles;   // b * H + h
  const int b = (int)(row / H), h = (int)(row - (int64_t)b * H);
  const int x0 = tile * kBwdTile;
  const int cols = min(kBwdTile, W - x0);
  const bool in = tid < cols;
  for (int n = tid; n < N; n += kBwdTile) {
    d_row[n] = disp_rows[row * N + n];
    m_row[n] = mask_rows[row * N + n];
  }                                         // published by stage's first barrier
  const int64_t plane = (int64_t)H * W;
  const int64_t seg = (int64_t)b * N * plane + (int64_t)h * W + x0;
  const float* lseg = logits + seg;
  const float* sseg = sigma + seg;
  const int chunks = (N + nc_max - 1) / nc_max;
  const bool resident = chunks == 1;
  float* Lc = Ls + tid;                     // this thread's column
  float* Sc = Ss + tid;

  // (1) the max and the sums, online across chunks
  float mx = -INFINITY, se = 0.f, us = 0.f, ud = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int n0 = c * nc_max, nc = min(nc_max, N - n0);
    stage(lseg, sseg, plane, Ls, Ss, n0, nc, cols, vec);
    float cm = -INFINITY;
#pragma unroll 8
    for (int n = 0; n < nc; ++n) cm = fmaxf(cm, Lc[n * kBwdTile]);
    const float nm = fmaxf(mx, cm);
    const float keep = fexp(mx - nm);       // 0 at the first chunk
    se *= keep;
    us *= keep;
    ud *= keep;
    mx = nm;
#pragma unroll 4
    for (int n = 0; n < nc; ++n) {
      const float e = fexp(Lc[n * kBwdTile] - mx);
      const float r = frcp(Sc[n * kBwdTile]);
      const float u = e * m_row[n0 + n] * r;
      se += e;
      us += u;
      ud = fmaf(u, d_row[n0 + n], ud);
      if (resident) {
        Lc[n * kBwdTile] = e;
        Sc[n * kBwdTile] = r;
      }
    }
  }
  const float inv_se = frcp(se);
  const float U = us * inv_se;
  const bool live = in && U > kEps;
  const float inv_U = frcp(fmaxf(U, kEps));
  const float disp = live ? ud * inv_se * inv_U : 0.f;
  const float gU = live ? g[row * W + x0 + tid] * inv_U : 0.f;

  // (2) S
  float S = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int n0 = c * nc_max, nc = min(nc_max, N - n0);
    if (!resident) stage(lseg, sseg, plane, Ls, Ss, n0, nc, cols, vec);
#pragma unroll 4
    for (int n = 0; n < nc; ++n) {
      const float e = resident ? Lc[n * kBwdTile] : fexp(Lc[n * kBwdTile] - mx);
      const float r = resident ? Sc[n * kBwdTile] : frcp(Sc[n * kBwdTile]);
      S += gU * (d_row[n0 + n] - disp) * m_row[n0 + n] * r * (e * inv_se);
    }
  }

  // (3) the outputs, and each plane's sum over the segment of g u / U
  float* dl = d_logits + seg + tid;
  float* ds = d_sigma + seg + tid;
  const int lane = tid & 31;
  for (int c = 0; c < chunks; ++c) {
    const int n0 = c * nc_max, nc = min(nc_max, N - n0);
    if (!resident) stage(lseg, sseg, plane, Ls, Ss, n0, nc, cols, vec);
#pragma unroll 4
    for (int n = 0; n < nc; ++n) {
      const float e = resident ? Lc[n * kBwdTile] : fexp(Lc[n * kBwdTile] - mx);
      const float r = resident ? Sc[n * kBwdTile] : frcp(Sc[n * kBwdTile]);
      const float p = e * inv_se;
      const float m = m_row[n0 + n];
      const float u = p * m * r;
      const float du = gU * (d_row[n0 + n] - disp);
      const float dp = du * m * r;
      if (in) {
        dl[(n0 + n) * plane] = p * (dp - S);
        ds[(n0 + n) * plane] = -du * u * r;
      }
      Lc[n * kBwdTile] = gU * u;
    }
    __syncthreads();
    for (int n = tid >> 5; n < nc; n += kBwdTile / 32) {
      const float* col = Ls + n * kBwdTile + lane;
      float v = col[0] + col[32] + col[64] + col[96];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) partial[(row * tiles + tile) * N + n0 + n] = v;
    }
  }
}

// d_rows[r, n] = sum over t of partial[r, t, n], t in order.
__global__ void disp_rows_sum_kernel(const float* __restrict__ partial,
                                     float* __restrict__ d_rows, int64_t total, int N,
                                     int tiles) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t r = i / N;
  const float* p = partial + r * tiles * N + (i - r * N);
  float v = 0.f;
  for (int t = 0; t < tiles; ++t) v += p[(int64_t)t * N];
  d_rows[i] = v;
}

// The backward's launch plan at (N, W).
struct BwdPlan {
  int tiles, nc;
  size_t smem;
};

BwdPlan bwd_plan(int N, int W) {
  BwdPlan pl;
  pl.tiles = (W + kBwdTile - 1) / kBwdTile;
  const int chunks = (N + kBwdResident - 1) / kBwdResident;
  pl.nc = (N + chunks - 1) / chunks;
  pl.smem = (2 * (size_t)((N + 3) & ~3) + 2 * (size_t)pl.nc * kBwdTile) * sizeof(float);
  return pl;
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
// written; scratch: pdt_disp_head_bwd_scratch_floats(B, N, H, W) floats (may
// be null when that is 0), overwritten.  Takes any N the forward takes.
// Launches on `stream`; returns cudaGetLastError() of the launches.
extern "C" int pdt_disp_head_bwd(const float* logits, const float* sigma,
                                 const float* disp_rows, const float* mask_rows,
                                 const float* g, float* d_logits, float* d_sigma,
                                 float* d_rows, float* scratch, int B, int N, int H, int W,
                                 void* stream) {
  const BwdPlan pl = bwd_plan(N, W);
  const int64_t blocks = (int64_t)B * H * pl.tiles;
  if (blocks > 0x7fffffff || (pl.tiles > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(disp_head_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = W % 4 == 0 && ((uintptr_t)logits & 15) == 0 && ((uintptr_t)sigma & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  disp_head_bwd_kernel<<<(unsigned)blocks, kBwdTile, pl.smem, st>>>(
      logits, sigma, disp_rows, mask_rows, g, d_logits, d_sigma,
      pl.tiles > 1 ? scratch : d_rows, N, H, W, pl.tiles, pl.nc, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || pl.tiles == 1) return (int)e;
  const int64_t total = (int64_t)B * H * N;
  disp_rows_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      scratch, d_rows, total, N, pl.tiles);
  return (int)cudaGetLastError();
}

extern "C" long long pdt_disp_head_bwd_scratch_floats(int B, int N, int H, int W) {
  const BwdPlan pl = bwd_plan(N, W);
  return pl.tiles > 1 ? (long long)B * H * pl.tiles * N : 0;
}

// The backward kernel at (N, W) as the compiler and the occupancy calculator
// see it: out = {registers, spill bytes, threads a block, blocks an SM,
// shared bytes a block, planes a chunk}.
extern "C" int pdt_disp_head_bwd_kernel_info(int N, int W, int* out) {
  const BwdPlan pl = bwd_plan(N, W);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, disp_head_bwd_kernel);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(disp_head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, disp_head_bwd_kernel, kBwdTile,
                                                    pl.smem);
  const int vals[6] = {attr.numRegs, (int)attr.localSizeBytes, kBwdTile, blocks,
                       (int)pl.smem, pl.nc};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return (int)e;
}
