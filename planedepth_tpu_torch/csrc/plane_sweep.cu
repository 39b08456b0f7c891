// Fused plane sweep: 2-tap warp + online-softmax composite + mixture NLL +
// centre expected disparity (forward), and its single-pass adjoint
// (backward), for the stereo training step.
//
// Replaces planedepth_tpu/ops/pallas_sweep.py:_fwd_kernel and _bwd_kernel
// (v1 unpacked layout, nonneg shifts, image_grads=False), in both of their
// modes: with_mixture=True (the mixture recipes) and with_mixture=False
// (B1', fused_plane_sweep_nomix: FalNet and use_mixture_loss=False), one
// template instance each.  Per pixel (b, h, x) and plane n, with
// s = clip(shift[b,h,n], 0, shift_max), k = floor(s), f = s - k,
// m = mask[b,h,n] and every sample zero outside [0, W):
//   l_n = ((1-f) L[x+k] + f L[x+k+1]) m
//   s_n = clip(((1-f) S[x+k] + f S[x+k+1]) m, 0.01, 1)    (mixture)
//   s_n = 1                                               (no mixture)
//   c_n = ((1-f) src[x+k] + f src[x+k+1]) m          (3 channels)
//   pi = softmax_n(l), u_n = pi_n / s_n, U = sum u
//   rgb = sum u c / U (0 where U <= 1e-7)
//   nll = -log(max(M, 0) + 1e-7), M = sum pi 0.5 exp(-e_n/s_n)/s_n,
//         e_n = mean_c |c_n - tgt|;  nll_auto the same with e = |src - tgt|
//   disp: the disp head over the unshifted samples, the clipped shift
//         doubling as the plane disparity.  The output's guard uses the
//         MASKED normaliser (sum e0 m), the saved stats the unmasked one,
//         exactly as the TPU kernel writes them (pallas_sweep.py:487-537).
//         Without the mixture it is the plain softmax expectation over
//         l0 = L[x] m, with no mask or sigma in the weights (:480-489).
// The no-mixture operand holds logits only: sigma is the literal 1, never
// loaded, so the composite is exact at the borders, where a warped all-ones
// map would shrink under the zero padding (pallas_sweep.py:1703-1709); its
// backward writes no d_sigma.
// The backward consumes the forward's 7 per-pixel statistics and its rgb
// output (A = U * (G . rgb)), so every plane's adjoint is local; the
// cotangent of a sample at x+k lands back on the source row by a reverse
// window, d[x'] = (1-f) g[x'-k] + f g[x'-k-1] (pallas_sweep.py:1340-1358).
//
// Bound at the stage-1 shape (B, N, H, W) = (8, 63, 192, 640), f32:
//   forward moves ~566 MB (logits + sigma 495 MB, images 24 MB, outputs
//   and stats 47 MB) -> ~0.17 ms at 3.35 TB/s;
//   backward ~1.07 GB (reads 578 MB, writes d_logits + d_sigma 495 MB)
//   -> ~0.32 ms.  ~3 exps per pixel-plane is far below the SFU rate.
//   Without the mixture the sigma map drops out of both: ~248 MB forward,
//   ~453 MB backward at FalNet's (8, 49, 192, 640).
// Design: one block per (b, h) image row, threads along W (PX pixels a
// thread), all N planes looped in registers.  The row's clipped shifts,
// masks and source pixels sit in shared memory; every plane read of
// logits/sigma is a shifted contiguous window of one row, so it coalesces
// and its halo stays in L1.  The backward stages each plane's per-pixel
// adjoints in a shared row, then each thread gathers the reverse window of
// its own output pixel: every output element is written by exactly one
// block, with no atomics, so the result is deterministic.  d_shift is a
// fixed-order block reduction per (row, plane).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float clip_sigma(float v) {
  return fminf(fmaxf(v, 0.01f), 1.f);
}

__device__ __forceinline__ float sgn(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

// Online-softmax step sharing one exp (pallas_sweep.py:_online_e): returns
// the rescale of the old sums in *corr and the new term's weight in *e.
__device__ __forceinline__ void online(float l, float& mx, float* corr,
                                       float* e) {
  const float d = l - mx;
  const float t = expf(-fabsf(d));
  const bool grow = d > 0.f;
  *corr = grow ? t : 1.f;
  *e = grow ? 1.f : t;
  mx = grow ? l : mx;
}

// Loads the row's clipped shifts and masks (N each) and its source pixels
// (3 x W) into shared memory.
__device__ __forceinline__ void load_row(const float* shift, const float* mask,
                                         const float* src, float* sh_shift,
                                         float* sh_mask, float* sh_src, int b,
                                         int h, int N, int H, int W,
                                         float shift_max) {
  const int64_t row = (int64_t)b * H + h;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    sh_shift[n] = fminf(fmaxf(shift[row * N + n], 0.f), shift_max);
    sh_mask[n] = mask[row * N + n];
  }
  for (int i = threadIdx.x; i < 3 * W; i += blockDim.x) {
    const int c = i / W, x = i - c * W;
    sh_src[i] = src[(((int64_t)b * 3 + c) * H + h) * W + x];
  }
}

// MIX: the mixture mode (sigma operand, clipped sigma); without it sigma is
// the literal 1 and the sigma pointer is not read.
template <int PX, bool MIX>
__global__ void __launch_bounds__(kMaxThreads)
sweep_fwd_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const float* __restrict__ logits,
                 const float* __restrict__ sigma,
                 const float* __restrict__ shift,
                 const float* __restrict__ mask, float* __restrict__ rgb,
                 float* __restrict__ nll, float* __restrict__ nll_auto,
                 float* __restrict__ disp, float* __restrict__ stats, int N,
                 int H, int W, float shift_max, int with_auto, int with_disp) {
  extern __shared__ float smem[];
  float* sh_shift = smem;
  float* sh_mask = smem + N;
  float* sh_src = smem + 2 * N;
  const int h = blockIdx.x, b = blockIdx.y;
  load_row(shift, mask, src, sh_shift, sh_mask, sh_src, b, h, N, H, W,
           shift_max);
  __syncthreads();

  const int64_t plane = (int64_t)H * W;
  const int64_t pix_row = (int64_t)h * W;   // offset of row h in one plane
  float t[PX][3], e_auto[PX];
  float mx[PX], se[PX], us[PX], acc[PX][3], M[PX], Ma[PX];
  float mx0[PX], se0[PX], us0[PX], ud0[PX], se0r[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = min((int)(threadIdx.x + p * blockDim.x), W - 1);
    float ea = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t[p][c] = tgt[((int64_t)b * 3 + c) * plane + pix_row + x];
      ea += fabsf(sh_src[c * W + x] - t[p][c]);
      acc[p][c] = 0.f;
    }
    e_auto[p] = ea / 3.f;
    mx[p] = -1e30f; se[p] = 0.f; us[p] = 0.f; M[p] = 0.f; Ma[p] = 0.f;
    mx0[p] = -1e30f; se0[p] = 0.f; us0[p] = 0.f; ud0[p] = 0.f; se0r[p] = 0.f;
  }

  for (int n = 0; n < N; ++n) {
    const float s = sh_shift[n];
    const int k = (int)floorf(s);
    const float f = s - (float)k, w0 = 1.f - f, m = sh_mask[n];
    const float* lrow = logits + ((int64_t)b * N + n) * plane + pix_row;
    const float* srow = MIX ? sigma + ((int64_t)b * N + n) * plane + pix_row : nullptr;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int x = (int)(threadIdx.x + p * blockDim.x);
      if (x >= W) continue;
      const int i0 = x + k, i1 = i0 + 1;
      const bool v0 = i0 < W, v1 = i1 < W;
      const float lt0 = v0 ? __ldg(lrow + i0) : 0.f;
      const float lt1 = v1 ? __ldg(lrow + i1) : 0.f;
      const float l = (w0 * lt0 + f * lt1) * m;
      float sg = 1.f;
      if (MIX) {
        const float st0 = v0 ? __ldg(srow + i0) : 0.f;
        const float st1 = v1 ? __ldg(srow + i1) : 0.f;
        sg = clip_sigma((w0 * st0 + f * st1) * m);
      }
      float c[3], err = 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float c0 = v0 ? sh_src[ch * W + i0] : 0.f;
        const float c1 = v1 ? sh_src[ch * W + i1] : 0.f;
        c[ch] = (w0 * c0 + f * c1) * m;
        err += fabsf(c[ch] - t[p][ch]);
      }
      err /= 3.f;
      float corr, e;
      online(l, mx[p], &corr, &e);
      const float r = MIX ? 1.f / sg : 1.f;
      const float u = e * r;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[p][ch] = acc[p][ch] * corr + u * c[ch];
      M[p] = M[p] * corr + e * 0.5f * expf(-err * r) * r;
      se[p] = se[p] * corr + e;
      us[p] = us[p] * corr + u;
      if (with_auto) Ma[p] = Ma[p] * corr + e * 0.5f * expf(-e_auto[p] * r) * r;
      if (with_disp) {
        const float l0 = __ldg(lrow + x) * m;
        const float s0 = MIX ? clip_sigma(__ldg(srow + x)) : 1.f;
        float corr0, e0;
        online(l0, mx0[p], &corr0, &e0);
        // no mixture: the plain softmax expectation, no mask in the weights
        const float u0 = MIX ? e0 * m * (1.f / s0) : e0;
        se0[p] = se0[p] * corr0 + u0 * s0;      // masked normaliser
        us0[p] = us0[p] * corr0 + u0;
        ud0[p] = ud0[p] * corr0 + u0 * s;
        se0r[p] = se0r[p] * corr0 + e0;         // unmasked normaliser
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = (int)(threadIdx.x + p * blockDim.x);
    if (x >= W) continue;
    const int64_t o = (int64_t)b * plane + pix_row + x;
    const float inv_se = 1.f / se[p];
    const float U = us[p] * inv_se;
    const float inv_us = U > kEps ? 1.f / fmaxf(us[p], 1e-30f) : 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb[((int64_t)b * 3 + ch) * plane + pix_row + x] = acc[p][ch] * inv_us;
    const float Mn = M[p] * inv_se;
    nll[o] = -logf(fmaxf(Mn, 0.f) + kEps);
    const float Man = with_auto ? Ma[p] * inv_se : 0.f;
    if (with_auto) nll_auto[o] = -logf(fmaxf(Man, 0.f) + kEps);
    float* st = stats + (int64_t)b * (with_disp ? 7 : 4) * plane + pix_row + x;
    st[0] = mx[p] + logf(se[p]);
    st[plane] = U;
    st[2 * plane] = Mn;
    st[3 * plane] = Man;
    if (with_disp) {
      const float U0 = us0[p] / se0[p];      // NaN (so 0 below) if all masked
      const float inv_us0 = U0 > kEps ? 1.f / fmaxf(us0[p], 1e-30f) : 0.f;
      disp[o] = ud0[p] * inv_us0;
      const float U0b = us0[p] / se0r[p];
      st[4 * plane] = mx0[p] + logf(se0r[p]);
      st[5 * plane] = U0b;
      st[6 * plane] = U0b > kEps ? ud0[p] / fmaxf(us0[p], 1e-30f) : 0.f;
    }
  }
}

// MIX as in sweep_fwd_kernel; without it d_sigma is not written (and may be
// null), and the sigma staging row is not used.
template <int PX, bool MIX>
__global__ void __launch_bounds__(kMaxThreads)
sweep_bwd_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const float* __restrict__ logits,
                 const float* __restrict__ sigma,
                 const float* __restrict__ shift,
                 const float* __restrict__ mask,
                 const float* __restrict__ stats,
                 const float* __restrict__ rgb,
                 const float* __restrict__ g_rgb,
                 const float* __restrict__ g_nll,
                 const float* __restrict__ g_disp,
                 float* __restrict__ d_logits, float* __restrict__ d_sigma,
                 float* __restrict__ d_shift, int N, int H, int W,
                 float shift_max, int with_disp) {
  extern __shared__ float smem[];
  float* sh_shift = smem;
  float* sh_mask = smem + N;
  float* sh_src = smem + 2 * N;
  float* sh_gl = sh_src + 3 * W;      // this plane's d l_n (times m) by x
  float* sh_gs = sh_gl + W;           // this plane's gated d s_n (times m)
  float* sh_red = sh_gs + W;          // one partial d_shift per warp
  const int h = blockIdx.x, b = blockIdx.y;
  load_row(shift, mask, src, sh_shift, sh_mask, sh_src, b, h, N, H, W,
           shift_max);
  __syncthreads();

  const int64_t plane = (int64_t)H * W;
  const int64_t pix_row = (int64_t)h * W;
  const int64_t row = (int64_t)b * H + h;
  const int nst = with_disp ? 7 : 4;

  // per-pixel globals from the forward statistics (pallas_sweep.py:663-681)
  float t[PX][3], G[PX][3], L[PX], inv_u[PX], dM[PX], dU[PX], S[PX];
  float L0[PX], gu0[PX], disp0[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = min((int)(threadIdx.x + p * blockDim.x), W - 1);
    const float* st = stats + (int64_t)b * nst * plane + pix_row + x;
    L[p] = st[0];
    const float U = st[plane], M = st[2 * plane];
    float gr = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t o = ((int64_t)b * 3 + c) * plane + pix_row + x;
      t[p][c] = tgt[o];
      G[p][c] = g_rgb[o];
      gr += G[p][c] * rgb[o];
    }
    const float A = U * gr;
    const bool live = U > kEps;
    inv_u[p] = live ? 1.f / fmaxf(U, kEps) : 0.f;
    const float gN = g_nll[(int64_t)b * plane + pix_row + x];
    dM[p] = M > 0.f ? -gN / (fmaxf(M, 0.f) + kEps) : 0.f;
    dU[p] = live ? -(inv_u[p] * inv_u[p]) * A : 0.f;
    S[p] = inv_u[p] * A + dM[p] * M + dU[p] * U;
    if (with_disp) {
      L0[p] = st[4 * plane];
      const float U0 = st[5 * plane];
      disp0[p] = st[6 * plane];
      const float gD = U0 > kEps ? g_disp[(int64_t)b * plane + pix_row + x] : 0.f;
      gu0[p] = gD / fmaxf(U0, kEps);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int n = 0; n < N; ++n) {
    const float s = sh_shift[n];
    const int k = (int)floorf(s);
    const float f = s - (float)k, w0 = 1.f - f, m = sh_mask[n];
    const int64_t plane_off = ((int64_t)b * N + n) * plane + pix_row;
    const float* lrow = logits + plane_off;
    const float* srow = MIX ? sigma + plane_off : nullptr;
    float dsh = 0.f, dl0[PX], ds0[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      dl0[p] = 0.f;
      ds0[p] = 0.f;
      const int x = (int)(threadIdx.x + p * blockDim.x);
      if (x >= W) continue;
      const int i0 = x + k, i1 = i0 + 1;
      const bool v0 = i0 < W, v1 = i1 < W;
      const float lt0 = v0 ? __ldg(lrow + i0) : 0.f;
      const float lt1 = v1 ? __ldg(lrow + i1) : 0.f;
      const float l = (w0 * lt0 + f * lt1) * m;
      const float ld = (lt1 - lt0) * m;
      float sg = 1.f, sd = 0.f;
      if (MIX) {
        const float st0 = v0 ? __ldg(srow + i0) : 0.f;
        const float st1 = v1 ? __ldg(srow + i1) : 0.f;
        sg = clip_sigma((w0 * st0 + f * st1) * m);
        sd = (st1 - st0) * m;
      }
      float c[3], cd[3], err = 0.f, dwgt = 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float c0 = v0 ? sh_src[ch * W + i0] : 0.f;
        const float c1 = v1 ? sh_src[ch * W + i1] : 0.f;
        c[ch] = (w0 * c0 + f * c1) * m;
        cd[ch] = (c1 - c0) * m;
        err += fabsf(c[ch] - t[p][ch]);
        dwgt += G[p][ch] * c[ch];
      }
      err /= 3.f;
      // per-plane algebra of pallas_sweep.py:_bwd_kernel.plane_grads
      const float pi = expf(l - L[p]);
      const float r = MIX ? 1.f / sg : 1.f;
      const float lap = 0.5f * expf(-err * r) * r;
      const float wgt = pi * r * inv_u[p];
      const float du = dwgt * inv_u[p] + dU[p];
      const float dpi = du * r + dM[p] * lap;
      const float dl = pi * (dpi - S[p]);
      const float dlap = dM[p] * pi;
      const float de = -dlap * lap * r;
      // sigma is the constant 1 without the mixture: no gradient
      const float ds = (dlap * lap * (err - sg) - du * pi) * (r * r);
      const float dsg = (MIX && sg > 0.01f && sg < 1.f) ? ds : 0.f;
      float dc_cd = 0.f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        dc_cd += (G[p][ch] * wgt + sgn(c[ch] - t[p][ch]) * (de / 3.f)) * cd[ch];
      dsh += dl * ld + dsg * sd + dc_cd;
      if (with_disp) {
        // centre disp head (pallas_sweep.py:731-755); the softmax
        // coupling vanishes, the sigma gate is on the RAW centre sigma.
        // Without the mixture the weights carry neither mask nor sigma,
        // but l0 = L m still chains the mask into d_logits.
        const float l0 = __ldg(lrow + x) * m;
        const float p0 = expf(l0 - L0[p]);
        const float du0 = gu0[p] * (s - disp0[p]);
        if (MIX) {
          const float s0raw = __ldg(srow + x);
          const float r0 = 1.f / clip_sigma(s0raw);
          dl0[p] = p0 * (du0 * m * r0);
          ds0[p] = (s0raw > 0.01f && s0raw < 1.f) ? -du0 * p0 * m * (r0 * r0) : 0.f;
          dsh += gu0[p] * p0 * m * r0;
        } else {
          dl0[p] = p0 * du0 * m;
          dsh += gu0[p] * p0;
        }
      }
      sh_gl[x] = dl * m;
      if (MIX) sh_gs[x] = dsg * m;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dsh += __shfl_down_sync(0xffffffffu, dsh, off);
    if (lane == 0) sh_red[warp] = dsh;
    __syncthreads();

#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int x = (int)(threadIdx.x + p * blockDim.x);
      if (x >= W) continue;
      const int j0 = x - k, j1 = j0 - 1;       // j0 < W since k >= 0
      float gl = 0.f, gs = 0.f;
      if (j0 >= 0) { gl += w0 * sh_gl[j0]; if (MIX) gs += w0 * sh_gs[j0]; }
      if (j1 >= 0) { gl += f * sh_gl[j1]; if (MIX) gs += f * sh_gs[j1]; }
      d_logits[plane_off + x] = gl + dl0[p];
      if (MIX) d_sigma[plane_off + x] = gs + ds0[p];
    }
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < nwarps; ++w) sum += sh_red[w];
      d_shift[row * N + n] = sum;
    }
    __syncthreads();
  }
}

int pixels_per_thread(int W) {
  return W <= kMaxThreads ? 1 : W <= 2 * kMaxThreads ? 2 : 4;
}

dim3 block_for(int W, int px) {
  const int threads = (W + px - 1) / px;
  return dim3(((threads + 31) / 32) * 32);
}

}  // namespace

// Shapes (all f32, contiguous): src, tgt (B, 3, H, W); logits, sigma
// (B, N, H, W); shift, mask (B, H, N), shift UNclipped (clipped here to
// [0, shift_max]); outputs rgb (B, 3, H, W), nll, nll_auto, disp (B, H, W),
// stats (B, 7 or 4, H, W).  nll_auto/disp may be null when their flag is 0;
// with_mixture 0 is the no-mixture mode (sigma may be null, with_auto must
// be 0).  W <= 4 * 512.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch.
extern "C" int pdt_plane_sweep_fwd(const float* src, const float* tgt,
                                   const float* logits, const float* sigma,
                                   const float* shift, const float* mask,
                                   float* rgb, float* nll, float* nll_auto,
                                   float* disp, float* stats, int B, int N,
                                   int H, int W, float shift_max, int with_auto,
                                   int with_disp, int with_mixture, void* stream) {
  if (!with_mixture && with_auto) return (int)cudaErrorInvalidValue;
  const int px = pixels_per_thread(W);
  const dim3 grid(H, B), block = block_for(W, px);
  const size_t smem = (2 * (size_t)N + 3 * (size_t)W) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define PDT_FWD(P, MIX)                                                     \
  sweep_fwd_kernel<P, MIX><<<grid, block, smem, st>>>(                      \
      src, tgt, logits, sigma, shift, mask, rgb, nll, nll_auto, disp, stats, \
      N, H, W, shift_max, with_auto, with_disp)
  if (with_mixture) {
    if (px == 1) PDT_FWD(1, true); else if (px == 2) PDT_FWD(2, true); else PDT_FWD(4, true);
  } else {
    if (px == 1) PDT_FWD(1, false); else if (px == 2) PDT_FWD(2, false); else PDT_FWD(4, false);
  }
#undef PDT_FWD
  return (int)cudaGetLastError();
}

// Adjoint of pdt_plane_sweep_fwd for the head operands: d_logits, d_sigma
// (B, N, H, W) and d_shift (B, H, N), each element written once.  stats and
// rgb are the forward's; g_rgb (B, 3, H, W), g_nll, g_disp (B, H, W) the
// cotangents (g_disp may be null when with_disp is 0).  With with_mixture 0
// sigma and d_sigma may be null; d_sigma is not written.
extern "C" int pdt_plane_sweep_bwd(const float* src, const float* tgt,
                                   const float* logits, const float* sigma,
                                   const float* shift, const float* mask,
                                   const float* stats, const float* rgb,
                                   const float* g_rgb, const float* g_nll,
                                   const float* g_disp, float* d_logits,
                                   float* d_sigma, float* d_shift, int B, int N,
                                   int H, int W, float shift_max, int with_disp,
                                   int with_mixture, void* stream) {
  const int px = pixels_per_thread(W);
  const dim3 grid(H, B), block = block_for(W, px);
  const size_t smem = (2 * (size_t)N + 5 * (size_t)W + 32) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define PDT_BWD(P, MIX)                                                     \
  sweep_bwd_kernel<P, MIX><<<grid, block, smem, st>>>(                      \
      src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll,       \
      g_disp, d_logits, d_sigma, d_shift, N, H, W, shift_max, with_disp)
  if (with_mixture) {
    if (px == 1) PDT_BWD(1, true); else if (px == 2) PDT_BWD(2, true); else PDT_BWD(4, true);
  } else {
    if (px == 1) PDT_BWD(1, false); else if (px == 2) PDT_BWD(2, false); else PDT_BWD(4, false);
  }
#undef PDT_BWD
  return (int)cudaGetLastError();
}
