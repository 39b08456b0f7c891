// Fused plane sweep: 2-tap warp + online-softmax composite + mixture NLL +
// centre expected disparity (forward), and its single-pass adjoint
// (backward), for the stereo training step.
//
// Replaces planedepth_tpu/ops/pallas_sweep.py:_fwd_kernel and _bwd_kernel
// (v1 unpacked layout, nonneg shifts; the backward with image_grads False
// and, with the mixture and the automask, True), in both of their modes: with_mixture=True (the mixture recipes) and with_mixture=False
// (B1', fused_plane_sweep_nomix: FalNet and use_mixture_loss=False), one
// template instance each.  At 1280x384 they also compute the function of the
// TPU's quad kernels (pallas_sweep_quad.py:_fwd_kernel_q, _bwd_kernel_q), fed
// by csrc/head_epilogue.cu.  Per pixel (b, h, x) and plane n, with
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
// The backward consumes the forward's 7 per-pixel statistics (4 without the
// disp) and its rgb output (A = U * (G . rgb)), so every plane's adjoint is
// local; the cotangent of a sample at x+k lands back on the source row by a
// reverse window, d[x'] = (1-f) g[x'-k] + f g[x'-k-1]
// (pallas_sweep.py:1340-1358).
// The image-gradient backward (IMG, pallas_sweep.py:540-882 with
// image_grads=True; the mixture with the automask only, as JAX asserts)
// also writes d_src and d_tgt: d_tgt += -sgn(c_n - tgt) de_n / 3 at x;
// d_src is the same reverse window of dc_n m, the per-channel adjoint of
// the source sample, that d_logits takes of dl_n m; and the automask's
// identity error e_auto = mean_c |src - tgt| adds t = sgn(src - tgt) dEa
// dMa / 3 to d_src and -t to d_tgt, where dEa = -sum_n pi_n lapa_n r_n,
// lapa_n = 0.5 exp(-e_auto r_n) r_n, r_n = 1 / s_n (pi and sigma held
// constant, as the reference holds them) and dMa = -g_nll_auto / (Ma + eps)
// from the forward's stats entry 3.
//
// Bound.  Stage 1, (B, N, H, W) = (8, 63, 192, 640), f32: the forward moves
// ~566 MB (logits + sigma 495 MB, images 24 MB, outputs and stats 47 MB),
// 0.169 ms at 3.35 TB/s; the backward ~1.07 GB, 0.321 ms.  Stage 3,
// (4, 63, 384, 1280): 0.338 / 0.641 ms.  Without the mixture the sigma map
// drops out: ~248 / ~453 MB at FalNet's (8, 49, 192, 640).  A second floor
// is the special-function unit: ~5 MUFU operations (ex2, rcp) per
// pixel-plane each way, at 16 per SM per clock ~0.15-0.2 ms at stage 3,
// under the byte bound but not far.  There is no matrix product in this
// function, so wgmma and the tensor cores have no place here.
//
// Design.  Counted in SASS, the kernels are bound by instruction issue
// before bytes: ~100 instructions a pixel-plane each way once the taps share
// one address, against ~20 bytes of logits and sigma, so every instruction
// off the per-plane chain counts.
// - One block per (b, h) image row, threads along W, PX = 1 pixel a thread
//   up to W = 640 (2 up to 1280, 4 up to 2048): a row is one block, so the
//   backward's reverse window and its d_shift sum never leave the block (no
//   cluster, no atomics), and a thread's online-softmax state is 17 floats
//   a pixel.  At PX = 1 the register budget leaves 2 blocks (40 warps) an SM.
// - Each plane's logits row (and sigma row under MIX) streams into a ring of
//   shared-memory slots by cp.async (16-byte granules when the rows are
//   16-byte aligned, 4-byte otherwise), counted in commit groups: a group
//   of planes a block barrier (forward 4, backward 2), the ring prefetching
//   two groups ahead, so later planes load while plane n computes.  Every
//   thread copies a fixed share of each group's granules, its (row,
//   granule) worked out once.  One __syncthreads a group both
//   publishes the group's copies (cp.async.wait_group, then the barrier)
//   and frees the slots of the group before it, so no mbarrier is needed:
//   every thread is producer and consumer alike.
// - Both taps, the unshifted centre sample of the disp head and the source
//   pixels are read from shared memory rows of a compile-time stride
//   (Tile<PX>::stride: the widest row + 2, rounded up), whose entries W and W + 1 are 0: a
//   tap past the edge is one clamped index, and all twelve loads of a
//   pixel-plane share one address with immediate offsets.
// - The backward is pipelined by one group: after the barrier of group j,
//   each thread gathers group j's reverse windows from the adjoint rows
//   that group j staged (dl m, dsg m, double-buffered, two zeros in front
//   for the positions left of the row) and then computes group j+1's
//   adjoints into the other buffer, so one barrier serves a group.
//   d_shift: each warp sums its lanes in a fixed shuffle tree, one warp a
//   plane then sums the warps' partials in a fixed tree: deterministic.
// - IMG stages dc m (3 channels) beside the adjoint rows of each group,
//   double-buffered like them (2 x group x 3 rows: ~31 KB at W = 640, ~62 KB
//   at 1280; the rows of W > 1280 no longer fit a block, and the wrapper
//   refuses them), gathers d_src's reverse window after the group's
//   barrier with d_logits', and keeps d_src, d_tgt and dEa in registers
//   across the planes: each pixel's 6 image gradients are written once.
//   One more ex2 a pixel-plane (the automask's Laplacian).  Its instance
//   asks the compiler for one block an SM (__launch_bounds__ min 1), so the
//   7 more accumulators a pixel cost no spills.
// - exp and 1/x in the per-plane chain are ex2.approx.ftz and
//   rcp.approx.ftz (~2 ulp; results under 2^-126 flush to 0, far below
//   the 1e-7 guards); the per-pixel epilogue keeps logf and IEEE division.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-7f;
// the channel mean as a product: an IEEE division is ~8 instructions
constexpr float kThird = 1.f / 3.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxW = 2048;
// forward: 4 planes a barrier, a ring of 3 groups (12 plane slots)
constexpr int kFwdGroup = 4, kFwdRingGroups = 3;
// backward: 2 planes a barrier, a ring of 3 groups (6 plane slots)
constexpr int kBwdGroup = 2, kBwdRingGroups = 3;

// At PX pixels a thread: the most threads a block, the blocks an SM that
// the register budget must leave room for, and the shared-memory row
// stride (the widest row plus the two zeros, 16-byte aligned).
template <int PX> struct Tile;
template <> struct Tile<1> { static constexpr int threads = 640, blocks = 2, stride = 644; };
template <> struct Tile<2> { static constexpr int threads = 640, blocks = 1, stride = 1284; };
template <> struct Tile<4> { static constexpr int threads = 512, blocks = 1, stride = 2052; };

int pixels_per_thread(int W) { return W <= 640 ? 1 : W <= 1280 ? 2 : 4; }

int row_stride(int W) {
  const int px = pixels_per_thread(W);
  return px == 1 ? Tile<1>::stride : px == 2 ? Tile<2>::stride : Tile<4>::stride;
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared-memory layout, in floats, rows of stride S: clipped shifts and
// masks (N each), the source row (3 channels), the ring of plane slots
// (logits, then sigma under MIX), then for the backward the double-buffered
// adjoint rows (dl m, and dsg m under MIX: 2 x group rows each; under IMG
// dc m: 2 x 3 x group rows, buffer, channel, plane), all contiguous, and
// the d_shift partials (2 x group x 32 warps).
struct Layout {
  int shift, mask, src, ring, slot, adj_l, adj_s, adj_c, red, total;
  __host__ __device__ Layout(int N, int S, bool mix, int slots, int group, bool bwd,
                             bool img = false) {
    shift = 0;
    mask = N;
    src = round4(2 * N);
    ring = src + 3 * S;
    slot = S * (mix ? 2 : 1);
    adj_l = ring + slots * slot;
    adj_s = adj_l + (bwd ? 2 * group * S : 0);
    adj_c = adj_s + (bwd && mix ? 2 * group * S : 0);
    red = adj_c + (bwd && img ? 2 * 3 * group * S : 0);
    total = red + (bwd ? 2 * group * 32 : 0);
  }
  // adjoint rows (each with its two leading zeros) from adj_l to red
  __host__ __device__ int adj_rows(int S) const { return (red - adj_l) / S; }
  size_t bytes() const { return (size_t)total * sizeof(float); }
};

__device__ __forceinline__ float clip_sigma(float v) {
  return fminf(fmaxf(v, 0.01f), 1.f);
}

__device__ __forceinline__ float sgn(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

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

// Online-softmax step sharing one exp (pallas_sweep.py:_online_e): returns
// the rescale of the old sums in *corr and the new term's weight in *e.
__device__ __forceinline__ void online(float l, float& mx, float* corr,
                                       float* e) {
  const float d = l - mx;
  const float t = fexp(-fabsf(d));
  const bool grow = d > 0.f;
  *corr = grow ? t : 1.f;
  *e = grow ? 1.f : t;
  mx = grow ? l : mx;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Loads the row's clipped shifts and masks and its source pixels (0 from W
// on), and zeroes entries W and W + 1 of every ring row.
template <int S>
__device__ __forceinline__ void load_row(const float* shift, const float* mask,
                                         const float* src, float* smem,
                                         const Layout& L, int slot_rows,
                                         int b, int h, int N, int H, int W,
                                         float shift_max) {
  const int64_t row = (int64_t)b * H + h;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    smem[L.shift + n] = fminf(fmaxf(shift[row * N + n], 0.f), shift_max);
    smem[L.mask + n] = mask[row * N + n];
  }
  for (int i = threadIdx.x; i < 3 * S; i += blockDim.x) {
    const int c = i / S, x = i - c * S;
    smem[L.src + i] = x < W ? src[(((int64_t)b * 3 + c) * H + h) * W + x] : 0.f;
  }
  for (int r = threadIdx.x; r < 2 * slot_rows; r += blockDim.x)
    smem[L.ring + (r >> 1) * S + W + (r & 1)] = 0.f;
}

// Which granule of a group's rows this thread copies first, and how far its
// next one is: the group's rows (G planes, logits and sigma interleaved
// under MIX) hold nq granules each, of 4 floats when vec, else of one.
struct CopyPlan {
  int nq, total, r0, q0, dr, dq;
  __device__ CopyPlan(int W, int rows, bool vec) {
    nq = vec ? W >> 2 : W;
    total = rows * nq;
    r0 = (int)threadIdx.x / nq;
    q0 = (int)threadIdx.x - r0 * nq;
    dr = (int)blockDim.x / nq;
    dq = (int)blockDim.x - dr * nq;
  }
};

// Issues the copies of group j (planes j*G ..) into its ring slots and
// commits them as one group (an empty group past the last plane keeps the
// wait counts uniform).
template <int S, int G, int P, bool MIX>
__device__ __forceinline__ void issue_group(float* smem, const Layout& L,
                                            const CopyPlan& cp,
                                            const float* logits,
                                            const float* sigma, int64_t rowbase,
                                            int64_t plane, int j, int N,
                                            bool vec) {
  if (j * G < N) {
    float* slots = smem + L.ring + (j % P) * G * L.slot;
    int r = cp.r0, q = cp.q0;
    for (int t = threadIdx.x; t < cp.total; t += blockDim.x) {
      const int g = MIX ? r >> 1 : r;
      const int n = j * G + g;
      if (n < N) {
        const bool sg = MIX && (r & 1);
        const float* row = (sg ? sigma : logits) + rowbase + n * plane;
        float* dst = slots + g * L.slot + (sg ? S : 0);
        if (vec)
          cp_async16(dst + 4 * q, row + 4 * q);
        else
          cp_async4(dst + q, row + q);
      }
      r += cp.dr;
      q += cp.dq;
      if (q >= cp.nq) { q -= cp.nq; ++r; }
    }
  }
  cp_async_commit();
}

}  // namespace

namespace {

// MIX: the mixture mode (sigma operand, clipped sigma); without it sigma is
// the literal 1 and the sigma pointer is not read.  vec: every logits/sigma
// row is 16-byte aligned (W % 4 == 0 and aligned bases).
template <int PX, bool MIX>
__global__ void __launch_bounds__(Tile<PX>::threads, Tile<PX>::blocks)
sweep_fwd_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const float* __restrict__ logits,
                 const float* __restrict__ sigma,
                 const float* __restrict__ shift,
                 const float* __restrict__ mask, float* __restrict__ rgb,
                 float* __restrict__ nll, float* __restrict__ nll_auto,
                 float* __restrict__ disp, float* __restrict__ stats, int N,
                 int H, int W, float shift_max, int with_auto, int with_disp,
                 int vec) {
  constexpr int G = kFwdGroup, P = kFwdRingGroups, S = Tile<PX>::stride;
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, S, MIX, G * P, G, false);
  const int h = blockIdx.x, b = blockIdx.y;
  load_row<S>(shift, mask, src, smem, L, G * P * (MIX ? 2 : 1), b, h, N, H, W,
              shift_max);

  const int64_t plane = (int64_t)H * W;
  const int64_t pix_row = (int64_t)h * W;   // offset of row h in one plane
  const int64_t rowbase = (int64_t)b * N * plane + pix_row;
  const int ngroups = (N + G - 1) / G;
  const CopyPlan cp(W, G * (MIX ? 2 : 1), vec);
#pragma unroll
  for (int j = 0; j < P - 1; ++j)
    issue_group<S, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane, j, N, vec);

  const float* sh_src = smem + L.src;
  __syncthreads();                          // load_row's stores
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
      ea += fabsf(sh_src[c * S + x] - t[p][c]);
      acc[p][c] = 0.f;
    }
    e_auto[p] = ea / 3.f;
    mx[p] = -1e30f; se[p] = 0.f; us[p] = 0.f; M[p] = 0.f; Ma[p] = 0.f;
    mx0[p] = -1e30f; se0[p] = 0.f; us0[p] = 0.f; ud0[p] = 0.f; se0r[p] = 0.f;
  }

  for (int i = 0; i < ngroups; ++i) {
    cp_async_wait<P - 2>();   // this thread's copies of group i have landed
    __syncthreads();          // everyone's; group i-1's slots are free
    issue_group<S, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane,
                              i + P - 1, N, vec);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = i * G + g;
      if (n >= N) break;
      const float s = smem[L.shift + n];
      const int k = (int)floorf(s);
      const float f = s - (float)k, w0 = 1.f - f, m = smem[L.mask + n];
      const float* lr = smem + L.ring + ((i % P) * G + g) * L.slot;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int x = (int)(threadIdx.x + p * blockDim.x);
        if (x >= W) continue;
        const int i0 = min(x + k, W);     // entries W, W + 1 are 0
        const float* a = lr + i0;
        const float* cs = sh_src + i0;
        const float l = (w0 * a[0] + f * a[1]) * m;
        const float sg = MIX ? clip_sigma((w0 * a[S] + f * a[S + 1]) * m) : 1.f;
        float c[3], err = 0.f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          c[ch] = (w0 * cs[ch * S] + f * cs[ch * S + 1]) * m;
          err += fabsf(c[ch] - t[p][ch]);
        }
        err *= kThird;
        float corr, e;
        online(l, mx[p], &corr, &e);
        const float r = MIX ? frcp(sg) : 1.f;
        const float u = e * r;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[p][ch] = acc[p][ch] * corr + u * c[ch];
        M[p] = M[p] * corr + e * 0.5f * fexp(-err * r) * r;
        se[p] = se[p] * corr + e;
        us[p] = us[p] * corr + u;
        if (with_auto) Ma[p] = Ma[p] * corr + e * 0.5f * fexp(-e_auto[p] * r) * r;
        if (with_disp) {
          const float l0 = lr[x] * m;
          const float s0 = MIX ? clip_sigma(lr[S + x]) : 1.f;
          float corr0, e0;
          online(l0, mx0[p], &corr0, &e0);
          // no mixture: the plain softmax expectation, no mask in the weights
          const float u0 = MIX ? e0 * m * frcp(s0) : e0;
          se0[p] = se0[p] * corr0 + u0 * s0;      // masked normaliser
          us0[p] = us0[p] * corr0 + u0;
          ud0[p] = ud0[p] * corr0 + u0 * s;
          se0r[p] = se0r[p] * corr0 + e0;         // unmasked normaliser
        }
      }
    }
  }
  cp_async_wait<0>();

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

}  // namespace

namespace {

// MIX as in sweep_fwd_kernel; without it d_sigma is not written (and may be
// null), and no sigma row is staged.  IMG (only with MIX, and the forward's
// automask): also d_src and d_tgt (B, 3, H, W), from g_nll_auto (B, H, W);
// one block an SM, for the registers.
template <int PX, bool MIX, bool IMG>
__global__ void __launch_bounds__(Tile<PX>::threads, IMG ? 1 : Tile<PX>::blocks)
sweep_bwd_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const float* __restrict__ logits,
                 const float* __restrict__ sigma,
                 const float* __restrict__ shift,
                 const float* __restrict__ mask,
                 const float* __restrict__ stats,
                 const float* __restrict__ rgb,
                 const float* __restrict__ g_rgb,
                 const float* __restrict__ g_nll,
                 const float* __restrict__ g_nll_auto,
                 const float* __restrict__ g_disp,
                 float* __restrict__ d_src, float* __restrict__ d_tgt,
                 float* __restrict__ d_logits, float* __restrict__ d_sigma,
                 float* __restrict__ d_shift, int N, int H, int W,
                 float shift_max, int with_disp, int vec) {
  static_assert(MIX || !IMG, "the image gradients exist only with the mixture");
  constexpr int G = kBwdGroup, P = kBwdRingGroups, S = Tile<PX>::stride;
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, S, MIX, G * P, G, true, IMG);
  const int h = blockIdx.x, b = blockIdx.y;
  load_row<S>(shift, mask, src, smem, L, G * P * (MIX ? 2 : 1), b, h, N, H, W,
              shift_max);
  // positions -2 and -1 of every adjoint row are 0 (the reverse window's
  // taps left of the row)
  for (int r = threadIdx.x; r < 2 * L.adj_rows(S); r += blockDim.x)
    smem[L.adj_l + (r >> 1) * S + (r & 1)] = 0.f;

  const int64_t plane = (int64_t)H * W;
  const int64_t pix_row = (int64_t)h * W;
  const int64_t row = (int64_t)b * H + h;
  const int64_t rowbase = (int64_t)b * N * plane + pix_row;
  const int ngroups = (N + G - 1) / G;
  const CopyPlan cp(W, G * (MIX ? 2 : 1), vec);
#pragma unroll
  for (int j = 0; j < P - 1; ++j)
    issue_group<S, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane, j, N, vec);

  const int nst = with_disp ? 7 : 4;
  const float* sh_src = smem + L.src;

  // per-pixel globals from the forward statistics (pallas_sweep.py:663-681)
  float t[PX][3], G3[PX][3], Ls[PX], inv_u[PX], dM[PX], dU[PX], Sg[PX];
  float L0[PX], gu0[PX], disp0[PX];
  // IMG: d_src and d_tgt of this thread's pixels, dEa, e_auto and dMa
  float dsr[PX][3], dtg[PX][3], dEa[PX], e_auto[PX], dMa[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = min((int)(threadIdx.x + p * blockDim.x), W - 1);
    const float* st = stats + (int64_t)b * nst * plane + pix_row + x;
    Ls[p] = st[0];
    if (IMG) {
      const float Ma = st[3 * plane];
      const float gA = g_nll_auto[(int64_t)b * plane + pix_row + x];
      dMa[p] = Ma > 0.f ? -gA / (fmaxf(Ma, 0.f) + kEps) : 0.f;
      dEa[p] = e_auto[p] = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) dsr[p][c] = dtg[p][c] = 0.f;
    }
    const float U = st[plane], M = st[2 * plane];
    float gr = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t o = ((int64_t)b * 3 + c) * plane + pix_row + x;
      t[p][c] = tgt[o];
      G3[p][c] = g_rgb[o];
      gr += G3[p][c] * rgb[o];
    }
    const float A = U * gr;
    const bool live = U > kEps;
    inv_u[p] = live ? 1.f / fmaxf(U, kEps) : 0.f;
    const float gN = g_nll[(int64_t)b * plane + pix_row + x];
    dM[p] = M > 0.f ? -gN / (fmaxf(M, 0.f) + kEps) : 0.f;
    dU[p] = live ? -(inv_u[p] * inv_u[p]) * A : 0.f;
    Sg[p] = inv_u[p] * A + dM[p] * M + dU[p] * U;
    L0[p] = gu0[p] = disp0[p] = 0.f;
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
  // the centre (unshifted) terms of d_logits / d_sigma at this thread's
  // pixels, from the group's compute to its gather
  float dl0[G][PX], ds0[G][PX];

  // group j's per-plane adjoints: dl m and dsg m at sample position p into
  // entry p + 2 of buffer j % 2, the centre terms into dl0/ds0, the warps'
  // d_shift partials
  auto compute = [&](int j) {
    float* adj_l = smem + L.adj_l + (j & 1) * G * S + 2;
    float* adj_s = smem + L.adj_s + (j & 1) * G * S + 2;
    float* adj_c = smem + L.adj_c + (j & 1) * 3 * G * S + 2;
    float* red = smem + L.red + (j & 1) * G * 32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = j * G + g;
      float dsh = 0.f;
#pragma unroll
      for (int p = 0; p < PX; ++p) dl0[g][p] = ds0[g][p] = 0.f;
      if (n < N) {
        const float s = smem[L.shift + n];
        const int k = (int)floorf(s);
        const float f = s - (float)k, w0 = 1.f - f, m = smem[L.mask + n];
        const float* lr = smem + L.ring + ((j % P) * G + g) * L.slot;
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int x = (int)(threadIdx.x + p * blockDim.x);
          if (x >= W) continue;
          const int i0 = min(x + k, W);     // entries W, W + 1 are 0
          const float* a = lr + i0;
          const float* cs = sh_src + i0;
          const float lt0 = a[0], lt1 = a[1];
          const float l = (w0 * lt0 + f * lt1) * m;
          const float ld = (lt1 - lt0) * m;
          float sg = 1.f, sd = 0.f;
          if (MIX) {
            const float st0 = a[S], st1 = a[S + 1];
            sg = clip_sigma((w0 * st0 + f * st1) * m);
            sd = (st1 - st0) * m;
          }
          float c[3], cd[3], err = 0.f, dwgt = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float c0 = cs[ch * S], c1 = cs[ch * S + 1];
            c[ch] = (w0 * c0 + f * c1) * m;
            cd[ch] = (c1 - c0) * m;
            err += fabsf(c[ch] - t[p][ch]);
            dwgt += G3[p][ch] * c[ch];
          }
          err *= kThird;
          // per-plane algebra of pallas_sweep.py:_bwd_kernel.plane_grads
          const float pi = fexp(l - Ls[p]);
          const float r = MIX ? frcp(sg) : 1.f;
          const float lap = 0.5f * fexp(-err * r) * r;
          const float wgt = pi * r * inv_u[p];
          const float du = dwgt * inv_u[p] + dU[p];
          const float dpi = du * r + dM[p] * lap;
          const float dl = pi * (dpi - Sg[p]);
          const float dlap = dM[p] * pi;
          const float de = -dlap * lap * r;
          // sigma is the constant 1 without the mixture: no gradient
          const float ds = (dlap * lap * (err - sg) - du * pi) * (r * r);
          const float dsg = (MIX && sg > 0.01f && sg < 1.f) ? ds : 0.f;
          float dc_cd = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float de_c = sgn(c[ch] - t[p][ch]) * (de * kThird);
            const float dc = G3[p][ch] * wgt + de_c;
            dc_cd += dc * cd[ch];
            if (IMG) {
              adj_c[(ch * G + g) * S + x] = dc * m;
              dtg[p][ch] -= de_c;
            }
          }
          // the automask's Laplacian at this plane's (constant) pi, sigma
          if (IMG) dEa[p] -= pi * (0.5f * fexp(-e_auto[p] * r) * r) * r;
          dsh += dl * ld + dsg * sd + dc_cd;
          if (with_disp) {
            // centre disp head (pallas_sweep.py:731-755); the softmax
            // coupling vanishes, the sigma gate is on the RAW centre sigma.
            // Without the mixture the weights carry neither mask nor sigma,
            // but l0 = L m still chains the mask into d_logits.
            const float l0 = lr[x] * m;
            const float p0 = fexp(l0 - L0[p]);
            const float du0 = gu0[p] * (s - disp0[p]);
            if (MIX) {
              const float s0raw = lr[S + x];
              const float r0 = frcp(clip_sigma(s0raw));
              dl0[g][p] = p0 * (du0 * m * r0);
              ds0[g][p] = (s0raw > 0.01f && s0raw < 1.f) ? -du0 * p0 * m * (r0 * r0) : 0.f;
              dsh += gu0[p] * p0 * m * r0;
            } else {
              dl0[g][p] = p0 * du0 * m;
              dsh += gu0[p] * p0;
            }
          }
          adj_l[g * S + x] = dl * m;
          if (MIX) adj_s[g * S + x] = dsg * m;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dsh += __shfl_down_sync(0xffffffffu, dsh, off);
      if (lane == 0) red[g * 32 + warp] = dsh;
    }
  };

  // group j's outputs: each pixel's reverse window over the staged adjoint
  // rows plus its centre term; one warp a plane sums the d_shift partials
  auto gather = [&](int j) {
    const float* adj_l = smem + L.adj_l + (j & 1) * G * S + 2;
    const float* adj_s = smem + L.adj_s + (j & 1) * G * S + 2;
    const float* adj_c = smem + L.adj_c + (j & 1) * 3 * G * S + 2;
    const float* red = smem + L.red + (j & 1) * G * 32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = j * G + g;
      if (n >= N) break;
      const float s = smem[L.shift + n];
      const int k = (int)floorf(s);
      const float f = s - (float)k, w0 = 1.f - f;
      const int64_t plane_off = rowbase + n * plane;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int x = (int)(threadIdx.x + p * blockDim.x);
        if (x >= W) continue;
        // taps at x - k and x - k - 1; left of the row they read the zeros
        const int j0 = max(x - k, -1);
        d_logits[plane_off + x] = w0 * adj_l[g * S + j0] + f * adj_l[g * S + j0 - 1]
                                  + dl0[g][p];
        if (MIX)
          d_sigma[plane_off + x] = w0 * adj_s[g * S + j0] + f * adj_s[g * S + j0 - 1]
                                   + ds0[g][p];
        if (IMG) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float* ac = adj_c + (ch * G + g) * S;
            dsr[p][ch] += w0 * ac[j0] + f * ac[j0 - 1];
          }
        }
      }
    }
    for (int g = warp; g < G; g += nwarps) {
      const int n = j * G + g;
      if (n >= N) break;
      float v = lane < nwarps ? red[g * 32 + lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) d_shift[row * N + n] = v;
    }
  };

  cp_async_wait<P - 2>();     // group 0 has landed
  __syncthreads();            // everyone's copies, and load_row's stores
  issue_group<S, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane, P - 1, N, vec);
  if (IMG) {
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int x = min((int)(threadIdx.x + p * blockDim.x), W - 1);
      float ea = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) ea += fabsf(sh_src[c * S + x] - t[p][c]);
      e_auto[p] = ea / 3.f;
    }
  }
  compute(0);
  for (int i = 0; i < ngroups; ++i) {
    // group i's adjoints and group i+1's rows are complete; group i's ring
    // slots and buffer i+1 (read by gather(i-1)) are free
    cp_async_wait<P - 2>();
    __syncthreads();
    issue_group<S, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane, i + P, N,
                              vec);
    gather(i);
    if (i + 1 < ngroups) compute(i + 1);
  }
  cp_async_wait<0>();
  if (IMG) {
    // the automask's identity-error adjoint lands on both images at x
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      const int x = (int)(threadIdx.x + p * blockDim.x);
      if (x >= W) continue;
      const float ta = dEa[p] * dMa[p] / 3.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int64_t o = ((int64_t)b * 3 + c) * plane + pix_row + x;
        const float t_auto = sgn(sh_src[c * S + x] - t[p][c]) * ta;
        d_src[o] = dsr[p][c] + t_auto;
        d_tgt[o] = dtg[p][c] - t_auto;
      }
    }
  }
}

}  // namespace

namespace {

size_t smem_bytes(int backward, int mix, int N, int W, int img = 0) {
  const int S = row_stride(W);
  return backward ? Layout(N, S, mix, kBwdGroup * kBwdRingGroups, kBwdGroup, true,
                           img).bytes()
                  : Layout(N, S, mix, kFwdGroup * kFwdRingGroups, kFwdGroup, false).bytes();
}

dim3 block_for(int W) {
  const int px = pixels_per_thread(W);
  const int threads = (W + px - 1) / px;
  return dim3(((threads + 31) / 32) * 32);
}

// Raises the kernel's dynamic shared-memory cap to `bytes` when it is above
// the default 48 KB (every launch: the cap is the function's, and
// pdt_plane_sweep_kernel_info sets it too).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int PX, bool MIX>
int launch_fwd(const float* src, const float* tgt, const float* logits,
               const float* sigma, const float* shift, const float* mask,
               float* rgb, float* nll, float* nll_auto, float* disp,
               float* stats, int B, int N, int H, int W, float shift_max,
               int with_auto, int with_disp, int vec, cudaStream_t st) {
  const size_t smem = smem_bytes(0, MIX, N, W);
  const cudaError_t e = allow_smem(sweep_fwd_kernel<PX, MIX>, smem);
  if (e != cudaSuccess) return (int)e;
  sweep_fwd_kernel<PX, MIX><<<dim3(H, B), block_for(W), smem, st>>>(
      src, tgt, logits, sigma, shift, mask, rgb, nll, nll_auto, disp, stats,
      N, H, W, shift_max, with_auto, with_disp, vec);
  return (int)cudaGetLastError();
}

template <int PX, bool MIX, bool IMG>
int launch_bwd(const float* src, const float* tgt, const float* logits,
               const float* sigma, const float* shift, const float* mask,
               const float* stats, const float* rgb, const float* g_rgb,
               const float* g_nll, const float* g_nll_auto, const float* g_disp,
               float* d_src, float* d_tgt, float* d_logits, float* d_sigma,
               float* d_shift, int B, int N, int H, int W, float shift_max,
               int with_disp, int vec, cudaStream_t st) {
  const size_t smem = smem_bytes(1, MIX, N, W, IMG);
  const cudaError_t e = allow_smem(sweep_bwd_kernel<PX, MIX, IMG>, smem);
  if (e != cudaSuccess) return (int)e;
  sweep_bwd_kernel<PX, MIX, IMG><<<dim3(H, B), block_for(W), smem, st>>>(
      src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll, g_nll_auto,
      g_disp, d_src, d_tgt, d_logits, d_sigma, d_shift, N, H, W, shift_max, with_disp,
      vec);
  return (int)cudaGetLastError();
}

// The widest row the image-gradient backward takes: its staged rows of
// 2 pixels a thread (W <= 1280) fit a block, those of 4 do not.
constexpr int kMaxImgW = 1280;

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Shapes (all f32, contiguous): src, tgt (B, 3, H, W); logits, sigma
// (B, N, H, W); shift, mask (B, H, N), shift UNclipped (clipped here to
// [0, shift_max]); outputs rgb (B, 3, H, W), nll, nll_auto, disp (B, H, W),
// stats (B, 7 or 4, H, W).  nll_auto/disp may be null when their flag is 0;
// with_mixture 0 is the no-mixture mode (sigma may be null, with_auto must
// be 0).  W <= 2048 and pdt_plane_sweep_smem_bytes within the card's
// opt-in limit.  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() of the launch.
extern "C" int pdt_plane_sweep_fwd(const float* src, const float* tgt,
                                   const float* logits, const float* sigma,
                                   const float* shift, const float* mask,
                                   float* rgb, float* nll, float* nll_auto,
                                   float* disp, float* stats, int B, int N,
                                   int H, int W, float shift_max, int with_auto,
                                   int with_disp, int with_mixture, void* stream) {
  if ((!with_mixture && with_auto) || W < 1 || W > kMaxW || N < 1)
    return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && aligned16(logits) && (!with_mixture || aligned16(sigma));
  const int px = pixels_per_thread(W);
  cudaStream_t st = (cudaStream_t)stream;
#define PDT_FWD(P, MIX)                                                       \
  launch_fwd<P, MIX>(src, tgt, logits, sigma, shift, mask, rgb, nll, nll_auto, \
                     disp, stats, B, N, H, W, shift_max, with_auto, with_disp, \
                     vec, st)
  if (with_mixture)
    return px == 1 ? PDT_FWD(1, true) : px == 2 ? PDT_FWD(2, true) : PDT_FWD(4, true);
  return px == 1 ? PDT_FWD(1, false) : px == 2 ? PDT_FWD(2, false) : PDT_FWD(4, false);
#undef PDT_FWD
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
  if (W < 1 || W > kMaxW || N < 1) return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && aligned16(logits) && (!with_mixture || aligned16(sigma));
  const int px = pixels_per_thread(W);
  cudaStream_t st = (cudaStream_t)stream;
#define PDT_BWD(P, MIX)                                                            \
  launch_bwd<P, MIX, false>(src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, \
                            g_nll, nullptr, g_disp, nullptr, nullptr, d_logits,     \
                            d_sigma, d_shift, B, N, H, W, shift_max, with_disp, vec, st)
  if (with_mixture)
    return px == 1 ? PDT_BWD(1, true) : px == 2 ? PDT_BWD(2, true) : PDT_BWD(4, true);
  return px == 1 ? PDT_BWD(1, false) : px == 2 ? PDT_BWD(2, false) : PDT_BWD(4, false);
#undef PDT_BWD
}

// pdt_plane_sweep_bwd's image-gradient mode (the mixture, with the
// forward's automask NLL): the same head gradients, and d_src, d_tgt
// (B, 3, H, W), each element written once, from the cotangents g_rgb,
// g_nll, g_nll_auto (B, H, W) and g_disp.  W <= 1280.
extern "C" int pdt_plane_sweep_bwd_img(const float* src, const float* tgt,
                                       const float* logits, const float* sigma,
                                       const float* shift, const float* mask,
                                       const float* stats, const float* rgb,
                                       const float* g_rgb, const float* g_nll,
                                       const float* g_nll_auto, const float* g_disp,
                                       float* d_src, float* d_tgt, float* d_logits,
                                       float* d_sigma, float* d_shift, int B, int N,
                                       int H, int W, float shift_max, int with_disp,
                                       void* stream) {
  if (W < 1 || W > kMaxImgW || N < 1) return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && aligned16(logits) && aligned16(sigma);
  cudaStream_t st = (cudaStream_t)stream;
#define PDT_BWD_IMG(P)                                                             \
  launch_bwd<P, true, true>(src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, \
                            g_nll, g_nll_auto, g_disp, d_src, d_tgt, d_logits,      \
                            d_sigma, d_shift, B, N, H, W, shift_max, with_disp, vec, st)
  return pixels_per_thread(W) == 1 ? PDT_BWD_IMG(1) : PDT_BWD_IMG(2);
#undef PDT_BWD_IMG
}

// Dynamic shared memory, in bytes, that one launch of the forward (backward
// 0) or backward (1) kernel needs at (N, W), of the backward's
// image-gradient mode with image_grads 1; -1 when W is wider than the
// kernels take (kMaxW).
extern "C" long long pdt_plane_sweep_smem_bytes(int backward, int with_mixture,
                                                int image_grads, int N, int W) {
  if (W < 1 || W > kMaxW) return -1;
  return (long long)smem_bytes(backward, with_mixture, N, W, backward && image_grads);
}

// What the compiler and the occupancy calculator say of the kernel instance
// a launch at (N, W) takes (image_grads 1: the backward's image-gradient
// instance, with the mixture, W <= 1280): out[0] registers a thread, out[1]
// local (spill) bytes a thread, out[2] threads a block, out[3] resident
// blocks an SM, out[4] dynamic shared memory in bytes.  Returns a CUDA error
// code.
extern "C" int pdt_plane_sweep_kernel_info(int backward, int with_mixture,
                                           int image_grads, int N, int W, int* out) {
  const int img = backward && image_grads;
  if (W < 1 || W > (img ? kMaxImgW : kMaxW) || (img && !with_mixture))
    return (int)cudaErrorInvalidValue;
  const void* fn;
  const int px = pixels_per_thread(W);
#define PDT_PICK(P)                                                                \
  fn = backward ? (with_mixture ? (const void*)sweep_bwd_kernel<P, true, false>    \
                                : (const void*)sweep_bwd_kernel<P, false, false>)  \
                : (with_mixture ? (const void*)sweep_fwd_kernel<P, true>           \
                                : (const void*)sweep_fwd_kernel<P, false>)
  if (img)
    fn = px == 1 ? (const void*)sweep_bwd_kernel<1, true, true>
                 : (const void*)sweep_bwd_kernel<2, true, true>;
  else if (px == 1) PDT_PICK(1);
  else if (px == 2) PDT_PICK(2);
  else PDT_PICK(4);
#undef PDT_PICK
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(backward, with_mixture, N, W, img);
  e = allow_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (int)block_for(W).x;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = blocks;
  out[4] = (int)smem;
  return (int)e;
}

// The current card's opt-in limit of dynamic shared memory a block, bytes.
extern "C" int pdt_plane_sweep_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return bytes;
}
