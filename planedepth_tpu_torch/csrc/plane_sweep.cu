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
// Element types: every kernel but the image-gradient backward is a template
// on T, the type of the images, the plane heads, the reconstruction and the
// head gradients: float, or bf16 (the JAX package's default arithmetic,
// _fwd_call and _bwd_call on bf16 operands, pallas_sweep.py:1023-1026,
// 1102-1103).  A bf16 instance's arithmetic is the float instance's: it
// stages its logits and sigma rows raw into a ring of bf16 rows and widens
// each tap exactly as it reads it; it rounds rgb, d_logits and d_sigma to
// bf16 (nearest even) as it writes them, and nll, nll_auto, disp, stats and
// d_shift stay float32.  Its bytes are the float instance's less half of
// the images, heads and their gradients.
// The image-gradient backward (sweep_bwd_img_kernel, pallas_sweep.py:540-882 with
// image_grads=True; the mixture with the automask only, as JAX asserts)
// also writes d_src and d_tgt: d_tgt += -sgn(c_n - tgt) de_n / 3 at x;
// d_src is the same reverse window of dc_n m, the per-channel adjoint of
// the source sample, that d_logits takes of dl_n m (the kernel stages dc_n
// and puts m into the window's weights); and the automask's identity error
// e_auto = mean_c |src - tgt| adds t = sgn(src - tgt) dEa dMa / 3 to d_src
// and -t to d_tgt, where dEa = -sum_n pi_n lapa_n r_n,
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
//   16-byte aligned, 4-byte otherwise; bf16 rows, below), counted in commit
//   groups: a group
//   of planes a block barrier (forward 4, backward 2; with the image
//   gradients 1 or 2), the ring prefetching
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
// - bf16 rows stay bf16 in the ring (Ring<PX, bf16>: rows of 648, 1288 or
//   2056 elements, each 16-byte aligned), staged by the same cp.async
//   pipeline in 16-byte granules of 8 when W % 8 == 0 and the bases are
//   16-byte aligned (the recipes' case), else loaded and stored by each
//   thread an element at a time; a tap is a 16-bit shared load and one shift
//   (bf16 -> float is exact), so the ring prefetches two groups ahead on half
//   the float ring's shared bytes.  Per-thread cp.async rather than TMA bulk
//   copies: at W <= 640 a group's copies are one granule a thread, a few
//   instructions against the group's few hundred of taps and algebra.
// - The backward is pipelined by one group: after the barrier of group j,
//   each thread gathers group j's reverse windows from the adjoint rows
//   that group j staged (dl m, dsg m, double-buffered, two zeros in front
//   for the positions left of the row) and then computes group j+1's
//   adjoints into the other buffer, so one barrier serves a group.
//   d_shift: each warp sums its lanes in a fixed shuffle tree, one warp a
//   plane then sums the warps' partials in a fixed tree: deterministic.
// - The image-gradient kernel (its own function, so that the head-only
//   kernel compiles as before; the two share their per-plane algebra,
//   centre-disp term, d_shift sums and pipeline as inline helpers) keeps
//   the head-only kernel's blocks an SM:
//   at PX = 1 two blocks of 640 threads, so 48 registers a thread, which
//   the head-only kernel already uses, and at most 113 KB a block of the
//   SM's 228 KB.  Its staged adjoint is one float4 a position, (dl m, dc_0,
//   dc_1, dc_2), beside the dsg m row, so the reverse windows of d_logits
//   and d_src are two LDS.128; the source row is one float4 a position (the
//   six taps: two LDS.128), and so are the target pixel's (tgt, -e_auto
//   log2 e) and (g_rgb, 0), read a plane rather than held.  A per-plane
//   table (k, f, w0, m; s, w0 m, f m) replaces every thread's floor and
//   products; the image's planes are addressed by 32-bit offsets, and a
//   thread's one granule of a plane's rows (W <= 640) is a multiply-add and
//   a cp.async.  At PX = 1 (lean, ImgTile) one plane a barrier, and d_tgt,
//   the automask sum and the pixel's head constants sit in float4 rows that
//   only the pixel's own thread touches (no barrier): 105,312 B at N = 63.
//   At PX = 2 two planes a barrier (one block an SM); at PX = 4 one plane
//   a barrier, so that the rows fit a block at W = 2048 (232,096 B at
//   N = 63, under the card's 232,448).  d_src and d_tgt are summed in a
//   fixed plane order and written once: repeated runs are bit-identical.
//   One more ex2 a pixel-plane (the automask's Laplacian); sgn(v) a as a
//   sign flip (three instructions, not six).  Counted in SASS, the address
//   arithmetic of the copies and stores outweighed the image terms: most
//   levers cut instructions, not bytes.
// - exp and 1/x in the per-plane chain are ex2.approx.ftz and
//   rcp.approx.ftz (~2 ulp; results under 2^-126 flush to 0, far below
//   the 1e-7 guards); the per-pixel epilogue keeps logf and IEEE division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The ring of plane rows at element type T: its element (float, or the raw
// bits of a bf16, widened at the taps) and its row stride in elements.  A
// float ring row has the source rows' stride; a bf16 one the widest row + 2
// rounded up to 8 elements (648, 1288, 2056), so that each row starts on 16
// bytes for cp.async.
template <int PX, typename T> struct Ring {
  using E = float;
  static constexpr int stride = Tile<PX>::stride;
};
template <int PX> struct Ring<PX, __nv_bfloat16> {
  using E = unsigned short;
  static constexpr int stride = (Tile<PX>::stride + 7) & ~7;
};

// The image-gradient backward at PX pixels a thread: its planes a barrier,
// and whether it is lean, keeping the pixel's d_tgt, automask sum and head
// constants in shared rows rather than registers (at one pixel a thread,
// where two blocks an SM leave 48 registers a thread).  Four pixels a
// thread take one plane a barrier, so that the rows fit a block at 2048.
template <int PX> struct ImgTile;
template <> struct ImgTile<1> { static constexpr int group = 1, lean = 1; };
template <> struct ImgTile<2> { static constexpr int group = 2, lean = 0; };
template <> struct ImgTile<4> { static constexpr int group = 1, lean = 0; };

int pixels_per_thread(int W) { return W <= 640 ? 1 : W <= 1280 ? 2 : 4; }

int row_stride(int W) {
  const int px = pixels_per_thread(W);
  return px == 1 ? Tile<1>::stride : px == 2 ? Tile<2>::stride : Tile<4>::stride;
}

// A bf16 ring row's stride in floats.
int ring_floats_bf16(int W) {
  using bf = __nv_bfloat16;
  const int px = pixels_per_thread(W);
  return (px == 1 ? Ring<1, bf>::stride : px == 2 ? Ring<2, bf>::stride : Ring<4, bf>::stride) / 2;
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared-memory layout, in floats, rows of stride S: clipped shifts and
// masks (N each; under img a plane table of two float4, (k, f, w0, m) and
// (s, w0 m, f m, 0)), the source row (3 channels; under img one float4 a
// position, the channels and a 0), under img float4 rows of the target
// pixels ((tgt, -e_auto log2 e), (g_rgb, 0); lean also (d_tgt, sum_n pi_n
// r_n^2 exp(-e_auto r_n)) and the head constants (Ls, inv_u, dM, dU), (Sg,
// L0, gu0, disp0)), the ring of plane slots (logits, then sigma under MIX;
// a bf16 ring's rows are Ring<PX, bf16>::stride elements, half as many
// floats), then for the backward the double-buffered adjoint rows (dl m, and dsg m
// under MIX: 2 x group rows each; under img the dl m row holds a float4 a
// position, (dl m, dc_0, dc_1, dc_2)), all contiguous, and the d_shift
// partials (2 x group x 32 warps).
struct Layout {
  int shift, mask, src, pix, ring, slot, adj_l, adj_s, red, total;
  __host__ __device__ Layout(int N, int S, bool mix, int slots, int group, bool bwd,
                             bool img = false, bool lean = false) {
    shift = 0;
    mask = N;
    src = img ? 8 * N : round4(2 * N);
    pix = src + (img ? 4 : 3) * S;
    ring = pix + (img ? (lean ? 20 : 8) * S : 0);
    slot = S * (mix ? 2 : 1);
    adj_l = ring + slots * slot;
    adj_s = adj_l + (bwd ? 2 * group * S * (img ? 4 : 1) : 0);
    red = adj_s + (bwd && mix ? 2 * group * S : 0);
    total = red + (bwd ? 2 * group * 32 : 0);
  }
  // the same with a bf16 ring, whose rows are ring_floats floats apart
  __host__ __device__ Layout(int N, int S, bool mix, int slots, int group, bool bwd,
                             int ring_floats)
      : Layout(N, S, mix, slots, group, bwd) {
    slot = ring_floats * (mix ? 2 : 1);
    adj_l = ring + slots * slot;
    adj_s = adj_l + (bwd ? 2 * group * S : 0);
    red = adj_s + (bwd && mix ? 2 * group * S : 0);
    total = red + (bwd ? 2 * group * 32 : 0);
  }
  // the head-only backward's adjoint rows (each with its two leading zeros)
  // from adj_l to red
  __host__ __device__ int adj_rows(int S) const { return (red - adj_l) / S; }
  size_t bytes() const { return (size_t)total * sizeof(float); }
};

// The layout of the sweep kernels at PX and element type T (a bf16 ring's
// rows half as many floats as its elements).
template <int PX, typename T>
__device__ __forceinline__ Layout layout(int N, bool mix, int slots, int group, bool bwd) {
  if constexpr (std::is_same<T, float>::value)
    return Layout(N, Tile<PX>::stride, mix, slots, group, bwd);
  else
    return Layout(N, Tile<PX>::stride, mix, slots, group, bwd, Ring<PX, T>::stride / 2);
}

__device__ __forceinline__ float clip_sigma(float v) {
  return fminf(fmaxf(v, 0.01f), 1.f);
}

__device__ __forceinline__ float sgn(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

// sgn(v) * a in three instructions: a with its sign flipped where v < 0,
// 0 where v == 0
__device__ __forceinline__ float sgn_times(float v, float a) {
  const float t = __int_as_float(__float_as_int(a) ^ (__float_as_int(v) & 0x80000000));
  return v != 0.f ? t : 0.f;
}

__device__ __forceinline__ float fexp(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v * kLog2e));
  return r;
}

__device__ __forceinline__ float fexp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float frcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The element types of the operands: float, or bf16 (the JAX package's
// default arithmetic: bf16 images and plane heads in, the reconstruction
// and the head gradients out, every sum float32 inside).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A ring element as a float: a bf16's bits are a float's upper half.
__device__ __forceinline__ float ring_f(float v) { return v; }
__device__ __forceinline__ float ring_f(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

__device__ __forceinline__ void cp_async16(unsigned short* dst, const __nv_bfloat16* src) {
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
// on), and zeroes entries W and W + 1 of every ring row (rows RS elements
// apart: bf16 zeros in a bf16 ring).
template <int S, int RS, typename T>
__device__ __forceinline__ void load_row(const float* shift, const float* mask,
                                         const T* src, float* smem,
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
    smem[L.src + i] = x < W ? to_f(src[(((int64_t)b * 3 + c) * H + h) * W + x]) : 0.f;
  }
  using R = typename Ring<1, T>::E;
  R* ring = reinterpret_cast<R*>(smem + L.ring);
  for (int r = threadIdx.x; r < 2 * slot_rows; r += blockDim.x)
    ring[(r >> 1) * RS + W + (r & 1)] = R(0);
}

// load_row for the image-gradient backward: the plane table of two float4
// a plane, (k, f, w0, m) and (s, w0 m, f m, 0), in place of the shifts and
// masks, and the source row as one float4 a position (the 3 channels and a
// 0; 0 from W on).
template <int S>
__device__ __forceinline__ void load_row_img(const float* shift, const float* mask,
                                             const float* src, float* smem,
                                             const Layout& L, int slot_rows,
                                             int b, int h, int N, int H, int W,
                                             float shift_max) {
  const int64_t row = (int64_t)b * H + h;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float s = fminf(fmaxf(shift[row * N + n], 0.f), shift_max), m = mask[row * N + n];
    const int k = (int)floorf(s);
    const float f = s - (float)k, w0 = 1.f - f;
    float4* tab = reinterpret_cast<float4*>(smem) + 2 * n;
    tab[0] = make_float4(__int_as_float(k), f, w0, m);
    tab[1] = make_float4(s, w0 * m, f * m, 0.f);
  }
  for (int i = threadIdx.x; i < 4 * S; i += blockDim.x) {
    const int c = i & 3, x = i >> 2;
    smem[L.src + i] = x < W && c < 3 ? src[(((int64_t)b * 3 + c) * H + h) * W + x] : 0.f;
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

// The copy plan of a ring at element type T: 16-byte granules of 4 floats,
// or of 8 bf16 (half as many as 4 floats of a row half as wide).
template <typename T>
__device__ __forceinline__ CopyPlan copy_plan(int W, int rows, bool vec) {
  if constexpr (std::is_same<T, float>::value)
    return CopyPlan(W, rows, vec);
  else
    return CopyPlan(vec ? W >> 1 : W, rows, vec);
}

// Issues the copies of group j (planes j*G ..) into its ring slots (rows S
// elements apart) and commits them as one group (an empty group past the
// last plane keeps the wait counts uniform).  bf16 rows are staged raw into
// a bf16 ring: 16-byte cp.async granules of 8 when vec, else each element
// loaded and stored by the thread itself, published by the same barrier as
// the copies.
template <int S, int G, int P, bool MIX, typename T>
__device__ __forceinline__ void issue_group(float* smem, const Layout& L,
                                            const CopyPlan& cp,
                                            const T* logits,
                                            const T* sigma, int64_t rowbase,
                                            int64_t plane, int j, int N,
                                            bool vec) {
  using R = typename Ring<1, T>::E;
  constexpr int per = 16 / sizeof(T);   // elements a 16-byte granule
  if (j * G < N) {
    R* slots = reinterpret_cast<R*>(smem + L.ring + (j % P) * G * L.slot);
    const int slot = L.slot * (int)(sizeof(float) / sizeof(R));   // in ring elements
    int r = cp.r0, q = cp.q0;
    for (int t = threadIdx.x; t < cp.total; t += blockDim.x) {
      const int g = MIX ? r >> 1 : r;
      const int n = j * G + g;
      if (n < N) {
        const bool sg = MIX && (r & 1);
        const T* row = (sg ? sigma : logits) + rowbase + n * plane;
        R* dst = slots + g * slot + (sg ? S : 0);
        if (vec)
          cp_async16(dst + per * q, row + per * q);
        else if constexpr (std::is_same<T, float>::value)
          cp_async4(dst + q, row + q);
        else
          dst[q] = __bfloat16_as_ushort(row[q]);
      }
      r += cp.dr;
      q += cp.dq;
      if (q >= cp.nq) { q -= cp.nq; ++r; }
    }
  }
  cp_async_commit();
}

// A pixel's constants of the backward, from the forward statistics
// (pallas_sweep.py:663-681), as the per-plane helpers below read them.
struct HeadConsts { float Ls, inv_u, dM, dU, Sg, L0, gu0, disp0; };

// The per-plane algebra of pallas_sweep.py:_bwd_kernel.plane_grads at one
// pixel: from the plane's sampled logit l, clipped sigma sg (1 without MIX)
// and its colour's err and dwgt.
struct PlaneGrads { float pi, r, wgt, dl, de, dsg; };

template <bool MIX>
__device__ __forceinline__ PlaneGrads plane_grads(float l, float sg, float err, float dwgt,
                                                  const HeadConsts& h) {
  PlaneGrads o;
  o.pi = fexp(l - h.Ls);
  o.r = MIX ? frcp(sg) : 1.f;
  const float lap = 0.5f * fexp(-err * o.r) * o.r;
  o.wgt = o.pi * o.r * h.inv_u;
  const float du = dwgt * h.inv_u + h.dU;
  const float dpi = du * o.r + h.dM * lap;
  o.dl = o.pi * (dpi - h.Sg);
  const float dlap = h.dM * o.pi;
  o.de = -dlap * lap * o.r;
  // sigma is the constant 1 without the mixture: no gradient
  const float ds = (dlap * lap * (err - sg) - du * o.pi) * (o.r * o.r);
  o.dsg = (MIX && sg > 0.01f && sg < 1.f) ? ds : 0.f;
  return o;
}

// The centre disp head's terms at one pixel and plane (pallas_sweep.py:
// 731-755), from the plane's staged logit at lr_x (its sigma S further
// under MIX), mask m and clipped shift s: sets dl0 (and ds0 under MIX) and
// returns the plane's d_shift term.  The softmax coupling vanishes and the
// sigma gate is on the RAW centre sigma.  Without the mixture the weights
// carry neither mask nor sigma, but l0 = L m still chains the mask into
// d_logits.
template <bool MIX, int S, typename R>
__device__ __forceinline__ float centre_disp(const R* lr_x, float m, float s,
                                             const HeadConsts& h, float& dl0, float& ds0) {
  const float l0 = ring_f(lr_x[0]) * m;
  const float p0 = fexp(l0 - h.L0);
  const float du0 = h.gu0 * (s - h.disp0);
  if (MIX) {
    const float s0raw = ring_f(lr_x[S]);
    const float r0 = frcp(clip_sigma(s0raw));
    dl0 = p0 * (du0 * m * r0);
    ds0 = (s0raw > 0.01f && s0raw < 1.f) ? -du0 * p0 * m * (r0 * r0) : 0.f;
    return h.gu0 * p0 * m * r0;
  }
  dl0 = p0 * du0 * m;
  return h.gu0 * p0;
}

// A warp's d_shift partial of plane slot g, summed over its lanes in a fixed
// shuffle tree, into red[g * 32 + warp].
__device__ __forceinline__ void warp_partial(float dsh, float* red, int g, int lane,
                                             int warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dsh += __shfl_down_sync(0xffffffffu, dsh, off);
  if (lane == 0) red[g * 32 + warp] = dsh;
}

// d_shift of group j's planes: one warp a plane sums the warps' partials
// in a fixed tree, so repeated runs are bit-identical.
template <int G>
__device__ __forceinline__ void sum_partials(const float* red, float* d_shift, int64_t row,
                                             int j, int N, int lane, int warp, int nwarps) {
  for (int g = warp; g < G; g += nwarps) {
    const int n = j * G + g;
    if (n >= N) break;
    float v = lane < nwarps ? red[g * 32 + lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) d_shift[row * N + n] = v;
  }
}

// The backward's pipeline over ngroups groups in a ring of P, once groups
// 0 .. P-2 are issued: after the barrier of group i, issue group i + P,
// gather group i and compute group i + 1, so one barrier serves a group.
// With G > 0 the first argument is the planes, group i of G running while
// i G < N: a bound that the kernel's parameters hold, so that no register
// holds the group count (the bf16 instance at PX = 1 spilled it).
template <int P, int G = 0, class Issue, class Compute, class Gather>
__device__ __forceinline__ void run_pipeline(int ngroups, Issue&& issue, Compute&& compute,
                                             Gather&& gather) {
  cp_async_wait<P - 2>();     // group 0 has landed
  __syncthreads();            // everyone's copies, and load_row's stores
  issue(P - 1);
  compute(0);
  for (int i = 0; G ? i * G < ngroups : i < ngroups; ++i) {
    // group i's adjoints and group i+1's rows are complete; group i's ring
    // slots and buffer i+1 (read by gather(i-1)) are free
    cp_async_wait<P - 2>();
    __syncthreads();
    issue(i + P);
    gather(i);
    if (G ? (i + 1) * G < ngroups : i + 1 < ngroups) compute(i + 1);
  }
  cp_async_wait<0>();
}

}  // namespace

namespace {

// MIX: the mixture mode (sigma operand, clipped sigma); without it sigma is
// the literal 1 and the sigma pointer is not read.  vec: every logits/sigma
// row is 16-byte aligned (W % 4 == 0, for bf16 W % 8 == 0, and aligned
// bases).  T: the type of the images, the heads and rgb (float or bf16).
template <int PX, bool MIX, typename T>
__global__ void __launch_bounds__(Tile<PX>::threads, Tile<PX>::blocks)
sweep_fwd_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
                 const T* __restrict__ logits,
                 const T* __restrict__ sigma,
                 const float* __restrict__ shift,
                 const float* __restrict__ mask, T* __restrict__ rgb,
                 float* __restrict__ nll, float* __restrict__ nll_auto,
                 float* __restrict__ disp, float* __restrict__ stats, int N,
                 int H, int W, float shift_max, int with_auto, int with_disp,
                 int vec) {
  constexpr int G = kFwdGroup, P = kFwdRingGroups, S = Tile<PX>::stride;
  // the ring's element and row stride (RS = S for float)
  using R = typename Ring<PX, T>::E;
  constexpr int RS = Ring<PX, T>::stride;
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout<PX, T>(N, MIX, G * P, G, false);
  const int h = blockIdx.x, b = blockIdx.y;
  load_row<S, RS>(shift, mask, src, smem, L, G * P * (MIX ? 2 : 1), b, h, N, H, W,
                  shift_max);

  const int64_t plane = (int64_t)H * W;
  const int64_t pix_row = (int64_t)h * W;   // offset of row h in one plane
  const int64_t rowbase = (int64_t)b * N * plane + pix_row;
  const int ngroups = (N + G - 1) / G;
  const CopyPlan cp = copy_plan<T>(W, G * (MIX ? 2 : 1), vec);
#pragma unroll
  for (int j = 0; j < P - 1; ++j)
    issue_group<RS, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane, j, N, vec);

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
      t[p][c] = to_f(tgt[((int64_t)b * 3 + c) * plane + pix_row + x]);
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
    issue_group<RS, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane,
                               i + P - 1, N, vec);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = i * G + g;
      if (n >= N) break;
      const float s = smem[L.shift + n];
      const int k = (int)floorf(s);
      const float f = s - (float)k, w0 = 1.f - f, m = smem[L.mask + n];
      const R* lr = reinterpret_cast<const R*>(smem + L.ring + ((i % P) * G + g) * L.slot);
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int x = (int)(threadIdx.x + p * blockDim.x);
        if (x >= W) continue;
        const int i0 = min(x + k, W);     // entries W, W + 1 are 0
        const R* a = lr + i0;
        const float* cs = sh_src + i0;
        const float l = (w0 * ring_f(a[0]) + f * ring_f(a[1])) * m;
        const float sg =
            MIX ? clip_sigma((w0 * ring_f(a[RS]) + f * ring_f(a[RS + 1])) * m) : 1.f;
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
          const float l0 = ring_f(lr[x]) * m;
          const float s0 = MIX ? clip_sigma(ring_f(lr[RS + x])) : 1.f;
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
      rgb[((int64_t)b * 3 + ch) * plane + pix_row + x] = from_f<T>(acc[p][ch] * inv_us);
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

// MIX and T as in sweep_fwd_kernel (rgb and g_rgb, d_logits and d_sigma in
// T too); without MIX d_sigma is not written (and may be null), and no
// sigma row is staged.  The head gradients only; the images' are
// sweep_bwd_img_kernel's.
template <int PX, bool MIX, typename T>
__global__ void __launch_bounds__(Tile<PX>::threads, Tile<PX>::blocks)
sweep_bwd_kernel(const T* __restrict__ src, const T* __restrict__ tgt,
                 const T* __restrict__ logits,
                 const T* __restrict__ sigma,
                 const float* __restrict__ shift,
                 const float* __restrict__ mask,
                 const float* __restrict__ stats,
                 const T* __restrict__ rgb,
                 const T* __restrict__ g_rgb,
                 const float* __restrict__ g_nll,
                 const float* __restrict__ g_disp,
                 T* __restrict__ d_logits, T* __restrict__ d_sigma,
                 float* __restrict__ d_shift, int N, int H, int W,
                 float shift_max, int with_disp, int vec) {
  constexpr int G = kBwdGroup, P = kBwdRingGroups, S = Tile<PX>::stride;
  using R = typename Ring<PX, T>::E;
  constexpr int RS = Ring<PX, T>::stride;
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout<PX, T>(N, MIX, G * P, G, true);
  const int h = blockIdx.x, b = blockIdx.y;
  load_row<S, RS>(shift, mask, src, smem, L, G * P * (MIX ? 2 : 1), b, h, N, H, W,
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
  const CopyPlan cp = copy_plan<T>(W, G * (MIX ? 2 : 1), vec);
#pragma unroll
  for (int j = 0; j < P - 1; ++j)
    issue_group<RS, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane, j, N, vec);

  const int nst = with_disp ? 7 : 4;
  const float* sh_src = smem + L.src;

  // per-pixel globals from the forward statistics (pallas_sweep.py:663-681),
  // in arrays rather than HeadConsts: the struct changes this kernel's SASS
  float t[PX][3], G3[PX][3], Ls[PX], inv_u[PX], dM[PX], dU[PX], Sg[PX];
  float L0[PX], gu0[PX], disp0[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = min((int)(threadIdx.x + p * blockDim.x), W - 1);
    const float* st = stats + (int64_t)b * nst * plane + pix_row + x;
    Ls[p] = st[0];
    const float U = st[plane], M = st[2 * plane];
    float gr = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t o = ((int64_t)b * 3 + c) * plane + pix_row + x;
      t[p][c] = to_f(tgt[o]);
      G3[p][c] = to_f(g_rgb[o]);
      gr += G3[p][c] * to_f(rgb[o]);
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
        const R* lr = reinterpret_cast<const R*>(smem + L.ring + ((j % P) * G + g) * L.slot);
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int x = (int)(threadIdx.x + p * blockDim.x);
          if (x >= W) continue;
          const HeadConsts h = {Ls[p], inv_u[p], dM[p], dU[p], Sg[p], L0[p], gu0[p], disp0[p]};
          const int i0 = min(x + k, W);     // entries W, W + 1 are 0
          const R* a = lr + i0;
          const float* cs = sh_src + i0;
          const float lt0 = ring_f(a[0]), lt1 = ring_f(a[1]);
          const float l = (w0 * lt0 + f * lt1) * m;
          const float ld = (lt1 - lt0) * m;
          float sg = 1.f, sd = 0.f;
          if (MIX) {
            const float st0 = ring_f(a[RS]), st1 = ring_f(a[RS + 1]);
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
          const PlaneGrads q = plane_grads<MIX>(l, sg, err, dwgt, h);
          float dc_cd = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float de_c = sgn(c[ch] - t[p][ch]) * (q.de * kThird);
            const float dc = G3[p][ch] * q.wgt + de_c;
            dc_cd += dc * cd[ch];
          }
          dsh += q.dl * ld + q.dsg * sd + dc_cd;
          if (with_disp) dsh += centre_disp<MIX, RS>(lr + x, m, s, h, dl0[g][p], ds0[g][p]);
          adj_l[g * S + x] = q.dl * m;
          if (MIX) adj_s[g * S + x] = q.dsg * m;
        }
      }
      warp_partial(dsh, red, g, lane, warp);
    }
  };

  // group j's outputs: each pixel's reverse window over the staged adjoint
  // rows plus its centre term; one warp a plane sums the d_shift partials
  auto gather = [&](int j) {
    const float* adj_l = smem + L.adj_l + (j & 1) * G * S + 2;
    const float* adj_s = smem + L.adj_s + (j & 1) * G * S + 2;
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
        d_logits[plane_off + x] = from_f<T>(w0 * adj_l[g * S + j0] +
                                            f * adj_l[g * S + j0 - 1] + dl0[g][p]);
        if (MIX)
          d_sigma[plane_off + x] = from_f<T>(w0 * adj_s[g * S + j0] +
                                             f * adj_s[g * S + j0 - 1] + ds0[g][p]);
      }
    }
    sum_partials<G>(smem + L.red + (j & 1) * G * 32, d_shift, row, j, N, lane, warp, nwarps);
  };

  // bf16: the loop's bound from N (run_pipeline)
  constexpr int BY_N = std::is_same<T, float>::value ? 0 : G;
  run_pipeline<P, BY_N>(BY_N ? N : ngroups, [&](int j) {
    issue_group<RS, G, P, MIX>(smem, L, cp, logits, sigma, rowbase, plane, j, N, vec);
  }, compute, gather);
}

// sweep_bwd_kernel<PX, true> with the image gradients (the mixture and the
// forward's automask): also d_src and d_tgt (B, 3, H, W), from g_nll_auto
// (B, H, W), at the head-only kernel's blocks an SM.  Its head gradients
// come from the same helpers (plane_grads, centre_disp, the d_shift sums) on
// the same values, so they are the head-only kernel's bit for bit (the card
// checks hold them equal).
template <int PX>
__global__ void __launch_bounds__(Tile<PX>::threads, Tile<PX>::blocks)
sweep_bwd_img_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
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
  constexpr int G = ImgTile<PX>::group, P = kBwdRingGroups, S = Tile<PX>::stride;
  constexpr bool LEAN = ImgTile<PX>::lean;
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, S, true, G * P, G, true, true, LEAN);
  const int h = blockIdx.x, b = blockIdx.y;
  load_row_img<S>(shift, mask, src, smem, L, G * P * 2, b, h, N, H, W, shift_max);
  // positions -2 and -1 of every adjoint row are 0 (the reverse window's
  // taps left of the row): 8 floats of a (dl m, dc) row, 2 of a dsg m row
  for (int r = threadIdx.x; r < 2 * G * 8; r += blockDim.x)
    smem[L.adj_l + (r >> 3) * 4 * S + (r & 7)] = 0.f;
  for (int r = threadIdx.x; r < 2 * G * 2; r += blockDim.x)
    smem[L.adj_s + (r >> 1) * S + (r & 1)] = 0.f;

  const int64_t plane = (int64_t)H * W;
  const int64_t pix_row = (int64_t)h * W;
  const int64_t row = (int64_t)b * H + h;
  const int64_t rowbase = (int64_t)b * N * plane + pix_row;
  const int ngroups = (N + G - 1) / G;
  const CopyPlan cp(W, G * 2, vec);
  // this image's planes, addressed by 32-bit offsets (N H W < 2^31,
  // which the entry point checks); where a group's rows hold at most one
  // granule a thread, that granule's offset at group 0 and in a group's
  // slots, so that a group's copy is a multiply-add and one cp.async
  // (own_g >= N: none); otherwise issue_group, its plan made anew a group
  // rather than held in registers
  const int iplane = H * W, ipix = h * W;
  const float* logits_i = logits + (int64_t)b * N * plane;
  const float* sigma_i = sigma + (int64_t)b * N * plane;
  const bool own = cp.total <= (int)blockDim.x;
  int own_src = 0, own_dst = 0, own_g = N;
  bool own_sg = false;
  if (own && (int)threadIdx.x < cp.total) {
    const int g = cp.r0 >> 1, e = vec ? 4 * cp.q0 : cp.q0;
    own_sg = cp.r0 & 1;
    own_src = g * iplane + ipix + e;
    own_dst = g * L.slot + (own_sg ? S : 0) + e;
    own_g = g;
  }
  auto issue = [&](int j) {
    if (!own) {
      issue_group<S, G, P, true>(smem, L, CopyPlan(W, G * 2, vec), logits, sigma, rowbase,
                                 plane, j, N, vec);
      return;
    }
    if (j * G + own_g < N) {
      float* d = smem + L.ring + (j % P) * G * L.slot + own_dst;
      const float* a = (own_sg ? sigma_i : logits_i) + (j * G * iplane + own_src);
      if (vec)
        cp_async16(d, a);
      else
        cp_async4(d, a);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < P - 1; ++j) issue(j);

  const int nst = with_disp ? 7 : 4;
  // the plane table; the source pixels and the target pixels' (tgt,
  // -e_auto log2 e), (g_rgb, 0), one float4 a position; LEAN: the pixel's
  // (d_tgt, auto_sum) and head constants, (Ls, inv_u, dM, dU) and (Sg, L0,
  // gu0, disp0), read and written by the pixel's own thread only
  const float4* tab4 = reinterpret_cast<const float4*>(smem);
  const float4* src4 = reinterpret_cast<const float4*>(smem + L.src);
  float4* tgt4 = reinterpret_cast<float4*>(smem + L.pix);
  float4* grgb4 = tgt4 + S;
  float4* dtgt4 = grgb4 + S;
  float4* head4 = dtgt4 + S;

  // per-pixel globals from the forward statistics (pallas_sweep.py:663-681)
  float Ls[PX], inv_u[PX], dM[PX], dU[PX], Sg[PX], L0[PX], gu0[PX], disp0[PX];
  // d_src and d_tgt of this thread's pixels, and auto_sum = sum_n pi_n
  // r_n^2 exp(-e_auto r_n) = -2 dEa (pi and sigma constant); LEAN keeps the
  // last two in shared memory
  float dsr[PX][3], dtg[PX][3], auto_sum[PX];
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int xr = (int)(threadIdx.x + p * blockDim.x);
    const int x = min(xr, W - 1);
    const float* st = stats + (int64_t)b * nst * plane + pix_row + x;
    Ls[p] = st[0];
    const float U = st[plane], M = st[2 * plane];
    float gr = 0.f, tv[3], gv[3], ea = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t o = ((int64_t)b * 3 + c) * plane + pix_row + x;
      tv[c] = tgt[o];
      gv[c] = g_rgb[o];
      gr += gv[c] * rgb[o];
      ea += fabsf(src[o] - tv[c]);
      dsr[p][c] = dtg[p][c] = 0.f;
    }
    auto_sum[p] = 0.f;
    if (xr < W) {
      tgt4[x] = make_float4(tv[0], tv[1], tv[2], -(ea / 3.f) * kLog2e);
      grgb4[x] = make_float4(gv[0], gv[1], gv[2], 0.f);
      if (LEAN) dtgt4[x] = make_float4(0.f, 0.f, 0.f, 0.f);
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
    if (LEAN && xr < W) {
      head4[x] = make_float4(Ls[p], inv_u[p], dM[p], dU[p]);
      head4[S + x] = make_float4(Sg[p], L0[p], gu0[p], disp0[p]);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // the centre (unshifted) terms of d_logits / d_sigma at this thread's
  // pixels, from the group's compute to its gather
  float dl0[G][PX], ds0[G][PX];

  // group j's per-plane adjoints: (dl m, dc) and dsg m at sample position p
  // into entry p + 2 of buffer j % 2, the centre terms into dl0/ds0, the
  // warps' d_shift partials
  auto compute = [&](int j) {
    float4* adj_q = reinterpret_cast<float4*>(smem + L.adj_l) + (j & 1) * G * S + 2;
    float* adj_s = smem + L.adj_s + (j & 1) * G * S + 2;
    float* red = smem + L.red + (j & 1) * G * 32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = j * G + g;
      float dsh = 0.f;
#pragma unroll
      for (int p = 0; p < PX; ++p) dl0[g][p] = ds0[g][p] = 0.f;
      if (n < N) {
        const float4 a = tab4[2 * n];
        const int k = __float_as_int(a.x);
        const float f = a.y, w0 = a.z, m = a.w, s = tab4[2 * n + 1].x;
        const float* lr = smem + L.ring + ((j % P) * G + g) * L.slot;
#pragma unroll
        for (int p = 0; p < PX; ++p) {
          const int x = (int)(threadIdx.x + p * blockDim.x);
          if (x >= W) continue;
          const int i0 = min(x + k, W);     // entries W, W + 1 are 0
          const float* a = lr + i0;
          const float lt0 = a[0], lt1 = a[1];
          const float l = (w0 * lt0 + f * lt1) * m;
          const float ld = (lt1 - lt0) * m;
          const float st0 = a[S], st1 = a[S + 1];
          const float sg = clip_sigma((w0 * st0 + f * st1) * m);
          const float sd = (st1 - st0) * m;
          // the pixel's head constants
          HeadConsts h;
          if constexpr (LEAN) {
            const float4 u = head4[x], v = head4[S + x];
            h = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
          } else {
            h = {Ls[p], inv_u[p], dM[p], dU[p], Sg[p], L0[p], gu0[p], disp0[p]};
          }
          // the source taps, the target pixel and g_rgb, a float4 each
          const float4 u0 = src4[i0], u1 = src4[i0 + 1], tq = tgt4[x], gq = grgb4[x];
          const float i0v[3] = {u0.x, u0.y, u0.z}, i1v[3] = {u1.x, u1.y, u1.z};
          const float tp[3] = {tq.x, tq.y, tq.z}, gp[3] = {gq.x, gq.y, gq.z}, eal = tq.w;
          float c[3], cd[3], err = 0.f, dwgt = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float c0 = i0v[ch], c1 = i1v[ch];
            c[ch] = (w0 * c0 + f * c1) * m;
            cd[ch] = (c1 - c0) * m;
            err += fabsf(c[ch] - tp[ch]);
            dwgt += gp[ch] * c[ch];
          }
          err *= kThird;
          const PlaneGrads q = plane_grads<true>(l, sg, err, dwgt, h);
          float dc_cd = 0.f, dcs[3], dec[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float de_c = sgn_times(c[ch] - tp[ch], q.de * kThird);
            const float dc = gp[ch] * q.wgt + de_c;
            dc_cd += dc * cd[ch];
            dcs[ch] = dc;
            dec[ch] = de_c;
          }
          // d_tgt takes -de_c; the automask's Laplacian at this plane's
          // (constant) pi and sigma
          const float lapa = q.pi * q.r * (fexp2(eal * q.r) * q.r);
          if constexpr (LEAN) {
            float4 v = dtgt4[x];
            v.x -= dec[0];
            v.y -= dec[1];
            v.z -= dec[2];
            v.w += lapa;
            dtgt4[x] = v;
          } else {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) dtg[p][ch] -= dec[ch];
            auto_sum[p] += lapa;
          }
          dsh += q.dl * ld + q.dsg * sd + dc_cd;
          if (with_disp) dsh += centre_disp<true, S>(lr + x, m, s, h, dl0[g][p], ds0[g][p]);
          adj_q[g * S + x] = make_float4(q.dl * m, dcs[0], dcs[1], dcs[2]);
          adj_s[g * S + x] = q.dsg * m;
        }
      }
      warp_partial(dsh, red, g, lane, warp);
    }
  };

  // group j's outputs: each pixel's reverse window over the staged adjoint
  // rows plus its centre term; one warp a plane sums the d_shift partials
  auto gather = [&](int j) {
    const float4* adj_q = reinterpret_cast<const float4*>(smem + L.adj_l) + (j & 1) * G * S + 2;
    const float* adj_s = smem + L.adj_s + (j & 1) * G * S + 2;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int n = j * G + g;
      if (n >= N) break;
      const float4 a = tab4[2 * n], c = tab4[2 * n + 1];
      const int k = __float_as_int(a.x);
      const float f = a.y, w0 = a.z, wm = c.y, fm = c.z;
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int x = (int)(threadIdx.x + p * blockDim.x);
        if (x >= W) continue;
        // taps at x - k and x - k - 1; left of the row they read the zeros
        const int j0 = max(x - k, -1);
        const float4 q0 = adj_q[g * S + j0], q1 = adj_q[g * S + j0 - 1];
        const int o = n * iplane + ipix + x;
        (d_logits + (int64_t)b * N * plane)[o] = w0 * q0.x + f * q1.x + dl0[g][p];
        (d_sigma + (int64_t)b * N * plane)[o] =
            w0 * adj_s[g * S + j0] + f * adj_s[g * S + j0 - 1] + ds0[g][p];
        // dc carries no mask: the window's weights take it
        dsr[p][0] += wm * q0.y + fm * q1.y;
        dsr[p][1] += wm * q0.z + fm * q1.z;
        dsr[p][2] += wm * q0.w + fm * q1.w;
      }
    }
    sum_partials<G>(smem + L.red + (j & 1) * G * 32, d_shift, row, j, N, lane, warp, nwarps);
  };

  run_pipeline<P>(ngroups, issue, compute, gather);
  // the automask's identity-error adjoint lands on both images at x:
  // dEa = -auto_sum / 2, dMa = -g_nll_auto / (Ma + eps)
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int x = (int)(threadIdx.x + p * blockDim.x);
    if (x >= W) continue;
    const float Ma = stats[(int64_t)b * nst * plane + 3 * plane + pix_row + x];
    const float gA = g_nll_auto[(int64_t)b * plane + pix_row + x];
    const float dMa = Ma > 0.f ? -gA / (fmaxf(Ma, 0.f) + kEps) : 0.f;
    if (LEAN) {
      const float4 v = dtgt4[x];
      dtg[p][0] = v.x;
      dtg[p][1] = v.y;
      dtg[p][2] = v.z;
      auto_sum[p] = v.w;
    }
    const float ta = -0.5f * auto_sum[p] * dMa * kThird;
    const float4 sv = src4[x], tq = tgt4[x];
    const float sc[3] = {sv.x, sv.y, sv.z}, tc[3] = {tq.x, tq.y, tq.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t o = ((int64_t)b * 3 + c) * plane + pix_row + x;
      const float t_auto = sgn(sc[c] - tc[c]) * ta;
      d_src[o] = dsr[p][c] + t_auto;
      d_tgt[o] = dtg[p][c] - t_auto;
    }
  }
}

}  // namespace

namespace {

// elem: the operands' element size (4 float, 2 bf16: a bf16 ring); the
// image-gradient backward is float only.
size_t smem_bytes(int backward, int mix, int N, int W, int img = 0, int elem = 4) {
  const int S = row_stride(W), px = pixels_per_thread(W);
  if (!img) {
    const int slots = backward ? kBwdGroup * kBwdRingGroups : kFwdGroup * kFwdRingGroups;
    const int group = backward ? kBwdGroup : kFwdGroup;
    const Layout L = elem == 2
        ? Layout(N, S, mix, slots, group, backward, ring_floats_bf16(W))
        : Layout(N, S, mix, slots, group, backward);
    return L.bytes();
  }
#define PDT_IMG_LAYOUT(PX)                                                       \
  Layout(N, S, mix, ImgTile<PX>::group * kBwdRingGroups, ImgTile<PX>::group, true, \
         true, ImgTile<PX>::lean).bytes()
  return px == 1 ? PDT_IMG_LAYOUT(1) : px == 2 ? PDT_IMG_LAYOUT(2) : PDT_IMG_LAYOUT(4);
#undef PDT_IMG_LAYOUT
}

dim3 block_for(int W) {
  const int px = pixels_per_thread(W);
  const int threads = (W + px - 1) / px;
  return dim3(((threads + 31) / 32) * 32);
}

// Raises the kernel's dynamic shared-memory cap to `bytes` when it is above
// the default 48 KB (every launch: the cap is the function's, and
// pdt_plane_sweep_kernel_info sets it too); `most_smem` asks for the SM's
// largest shared-memory carveout (the image-gradient backward's two blocks
// at W <= 640 need 2 x 112 KB of it).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool most_smem = false) {
  if (most_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int PX, bool MIX, typename T>
int launch_fwd(const T* src, const T* tgt, const T* logits,
               const T* sigma, const float* shift, const float* mask,
               T* rgb, float* nll, float* nll_auto, float* disp,
               float* stats, int B, int N, int H, int W, float shift_max,
               int with_auto, int with_disp, int vec, cudaStream_t st) {
  const size_t smem = smem_bytes(0, MIX, N, W, 0, sizeof(T));
  const cudaError_t e = allow_smem(sweep_fwd_kernel<PX, MIX, T>, smem);
  if (e != cudaSuccess) return (int)e;
  sweep_fwd_kernel<PX, MIX, T><<<dim3(H, B), block_for(W), smem, st>>>(
      src, tgt, logits, sigma, shift, mask, rgb, nll, nll_auto, disp, stats,
      N, H, W, shift_max, with_auto, with_disp, vec);
  return (int)cudaGetLastError();
}

template <int PX, bool MIX, typename T>
int launch_bwd(const T* src, const T* tgt, const T* logits,
               const T* sigma, const float* shift, const float* mask,
               const float* stats, const T* rgb, const T* g_rgb,
               const float* g_nll, const float* g_disp, T* d_logits, T* d_sigma,
               float* d_shift, int B, int N, int H, int W, float shift_max,
               int with_disp, int vec, cudaStream_t st) {
  const size_t smem = smem_bytes(1, MIX, N, W, 0, sizeof(T));
  const cudaError_t e = allow_smem(sweep_bwd_kernel<PX, MIX, T>, smem);
  if (e != cudaSuccess) return (int)e;
  sweep_bwd_kernel<PX, MIX, T><<<dim3(H, B), block_for(W), smem, st>>>(
      src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll, g_disp, d_logits,
      d_sigma, d_shift, N, H, W, shift_max, with_disp, vec);
  return (int)cudaGetLastError();
}

template <int PX>
int launch_bwd_img(const float* src, const float* tgt, const float* logits,
                   const float* sigma, const float* shift, const float* mask,
                   const float* stats, const float* rgb, const float* g_rgb,
                   const float* g_nll, const float* g_nll_auto, const float* g_disp,
                   float* d_src, float* d_tgt, float* d_logits, float* d_sigma,
                   float* d_shift, int B, int N, int H, int W, float shift_max,
                   int with_disp, int vec, cudaStream_t st) {
  const size_t smem = smem_bytes(1, 1, N, W, 1);
  const cudaError_t e = allow_smem(sweep_bwd_img_kernel<PX>, smem, true);
  if (e != cudaSuccess) return (int)e;
  sweep_bwd_img_kernel<PX><<<dim3(H, B), block_for(W), smem, st>>>(
      src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll, g_nll_auto,
      g_disp, d_src, d_tgt, d_logits, d_sigma, d_shift, N, H, W, shift_max, with_disp,
      vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The forward at element type T, dispatched on the pixels a thread and the
// mode (pdt_plane_sweep_fwd and its bf16 twin).
template <typename T>
int sweep_fwd(const T* src, const T* tgt, const T* logits, const T* sigma,
              const float* shift, const float* mask, T* rgb, float* nll, float* nll_auto,
              float* disp, float* stats, int B, int N, int H, int W, float shift_max,
              int with_auto, int with_disp, int with_mixture, cudaStream_t st) {
  if ((!with_mixture && with_auto) || W < 1 || W > kMaxW || N < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte granules: 4 floats, or 8 bf16
  const int vec = W % (16 / (int)sizeof(T)) == 0 && aligned16(logits) &&
                  (!with_mixture || aligned16(sigma));
  const int px = pixels_per_thread(W);
#define PDT_FWD(P, MIX)                                                       \
  launch_fwd<P, MIX, T>(src, tgt, logits, sigma, shift, mask, rgb, nll, nll_auto, \
                        disp, stats, B, N, H, W, shift_max, with_auto, with_disp, \
                        vec, st)
  if (with_mixture)
    return px == 1 ? PDT_FWD(1, true) : px == 2 ? PDT_FWD(2, true) : PDT_FWD(4, true);
  return px == 1 ? PDT_FWD(1, false) : px == 2 ? PDT_FWD(2, false) : PDT_FWD(4, false);
#undef PDT_FWD
}

// The head-only backward at element type T (pdt_plane_sweep_bwd and its
// bf16 twin).
template <typename T>
int sweep_bwd(const T* src, const T* tgt, const T* logits, const T* sigma,
              const float* shift, const float* mask, const float* stats, const T* rgb,
              const T* g_rgb, const float* g_nll, const float* g_disp, T* d_logits,
              T* d_sigma, float* d_shift, int B, int N, int H, int W, float shift_max,
              int with_disp, int with_mixture, cudaStream_t st) {
  if (W < 1 || W > kMaxW || N < 1) return (int)cudaErrorInvalidValue;
  const int vec = W % (16 / (int)sizeof(T)) == 0 && aligned16(logits) &&
                  (!with_mixture || aligned16(sigma));
  const int px = pixels_per_thread(W);
#define PDT_BWD(P, MIX)                                                                   \
  launch_bwd<P, MIX, T>(src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll,   \
                        g_disp, d_logits, d_sigma, d_shift, B, N, H, W, shift_max,        \
                        with_disp, vec, st)
  if (with_mixture)
    return px == 1 ? PDT_BWD(1, true) : px == 2 ? PDT_BWD(2, true) : PDT_BWD(4, true);
  return px == 1 ? PDT_BWD(1, false) : px == 2 ? PDT_BWD(2, false) : PDT_BWD(4, false);
#undef PDT_BWD
}

}  // namespace

// Shapes (all f32, contiguous): src, tgt (B, 3, H, W); logits, sigma
// (B, N, H, W); shift, mask (B, H, N), shift UNclipped (clipped here to
// [0, shift_max]); outputs rgb (B, 3, H, W), nll, nll_auto, disp (B, H, W),
// stats (B, 7 or 4, H, W).  nll_auto/disp may be null when their flag is 0;
// with_mixture 0 is the no-mixture mode (sigma may be null, with_auto must
// be 0).  W <= 2048 (the wrapper runs wider rows in column segments) and
// pdt_plane_sweep_smem_bytes within the card's opt-in limit.  Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() of the launch.
extern "C" int pdt_plane_sweep_fwd(const float* src, const float* tgt,
                                   const float* logits, const float* sigma,
                                   const float* shift, const float* mask,
                                   float* rgb, float* nll, float* nll_auto,
                                   float* disp, float* stats, int B, int N,
                                   int H, int W, float shift_max, int with_auto,
                                   int with_disp, int with_mixture, void* stream) {
  return sweep_fwd<float>(src, tgt, logits, sigma, shift, mask, rgb, nll, nll_auto, disp,
                          stats, B, N, H, W, shift_max, with_auto, with_disp, with_mixture,
                          (cudaStream_t)stream);
}

// pdt_plane_sweep_fwd in bf16 (the JAX package's default): src, tgt,
// logits, sigma and rgb are bf16 (__nv_bfloat16), shift, mask and the other
// outputs float32; every sum is float32 and rgb is rounded to nearest even.
extern "C" int pdt_plane_sweep_fwd_bf16(const void* src, const void* tgt,
                                        const void* logits, const void* sigma,
                                        const float* shift, const float* mask, void* rgb,
                                        float* nll, float* nll_auto, float* disp,
                                        float* stats, int B, int N, int H, int W,
                                        float shift_max, int with_auto, int with_disp,
                                        int with_mixture, void* stream) {
  using bf = __nv_bfloat16;
  return sweep_fwd<bf>((const bf*)src, (const bf*)tgt, (const bf*)logits, (const bf*)sigma,
                       shift, mask, (bf*)rgb, nll, nll_auto, disp, stats, B, N, H, W,
                       shift_max, with_auto, with_disp, with_mixture, (cudaStream_t)stream);
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
  return sweep_bwd<float>(src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll,
                          g_disp, d_logits, d_sigma, d_shift, B, N, H, W, shift_max,
                          with_disp, with_mixture, (cudaStream_t)stream);
}

// pdt_plane_sweep_bwd in bf16: src, tgt, logits, sigma, rgb, g_rgb and the
// outputs d_logits, d_sigma are bf16; stats, g_nll, g_disp and d_shift
// float32.
extern "C" int pdt_plane_sweep_bwd_bf16(const void* src, const void* tgt,
                                        const void* logits, const void* sigma,
                                        const float* shift, const float* mask,
                                        const float* stats, const void* rgb,
                                        const void* g_rgb, const float* g_nll,
                                        const float* g_disp, void* d_logits, void* d_sigma,
                                        float* d_shift, int B, int N, int H, int W,
                                        float shift_max, int with_disp, int with_mixture,
                                        void* stream) {
  using bf = __nv_bfloat16;
  return sweep_bwd<bf>((const bf*)src, (const bf*)tgt, (const bf*)logits, (const bf*)sigma,
                       shift, mask, stats, (const bf*)rgb, (const bf*)g_rgb, g_nll, g_disp,
                       (bf*)d_logits, (bf*)d_sigma, d_shift, B, N, H, W, shift_max,
                       with_disp, with_mixture, (cudaStream_t)stream);
}

// pdt_plane_sweep_bwd's image-gradient mode (the mixture, with the
// forward's automask NLL): the same head gradients, and d_src, d_tgt
// (B, 3, H, W), each element written once, from the cotangents g_rgb,
// g_nll, g_nll_auto (B, H, W) and g_disp.  W <= 2048, as the forward.
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
  if (W < 1 || W > kMaxW || N < 1 || (long long)N * H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && aligned16(logits) && aligned16(sigma);
  const int px = pixels_per_thread(W);
  cudaStream_t st = (cudaStream_t)stream;
#define PDT_BWD_IMG(P)                                                              \
  launch_bwd_img<P>(src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb, g_nll,     \
                    g_nll_auto, g_disp, d_src, d_tgt, d_logits, d_sigma, d_shift, B, N, \
                    H, W, shift_max, with_disp, vec, st)
  return px == 1 ? PDT_BWD_IMG(1) : px == 2 ? PDT_BWD_IMG(2) : PDT_BWD_IMG(4);
#undef PDT_BWD_IMG
}

// Dynamic shared memory, in bytes, that one launch of the forward (backward
// 0) or backward (1) kernel needs at (N, W) with operands of elem_bytes (4:
// float, 2: bf16, whose ring holds raw bf16 rows), of the backward's
// image-gradient mode with image_grads 1 (float only); a row wider than
// kMaxW runs in segments of kMaxW columns, whose launches need the bytes at
// kMaxW.  -1 when W < 1, elem_bytes is neither or bf16 asks for the image
// gradients.
extern "C" long long pdt_plane_sweep_smem_bytes(int backward, int with_mixture,
                                                int image_grads, int elem_bytes, int N,
                                                int W) {
  const int img = backward && image_grads;
  if (W < 1 || (elem_bytes != 4 && elem_bytes != 2) || (img && elem_bytes != 4)) return -1;
  return (long long)smem_bytes(backward, with_mixture, N, W < kMaxW ? W : kMaxW, img,
                               elem_bytes);
}

namespace {

// kernel_info of the function fn, launched at (N, W) with smem bytes.
int kernel_info(const void* fn, size_t smem, bool most_smem, int W, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(fn, smem, most_smem);
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

// The forward (backward 0) or head-only backward instance at element type T
// that a launch at W takes.
template <typename T>
const void* sweep_instance(int backward, int with_mixture, int W) {
  const int px = pixels_per_thread(W);
#define PDT_PICK(P)                                                           \
  (backward ? (with_mixture ? (const void*)sweep_bwd_kernel<P, true, T>       \
                            : (const void*)sweep_bwd_kernel<P, false, T>)     \
            : (with_mixture ? (const void*)sweep_fwd_kernel<P, true, T>       \
                            : (const void*)sweep_fwd_kernel<P, false, T>))
  return px == 1 ? PDT_PICK(1) : px == 2 ? PDT_PICK(2) : PDT_PICK(4);
#undef PDT_PICK
}

}  // namespace

// What the compiler and the occupancy calculator say of the kernel instance
// a launch at (N, W) takes (image_grads 1: the backward's image-gradient
// instance, with the mixture): out[0] registers a thread, out[1]
// local (spill) bytes a thread, out[2] threads a block, out[3] resident
// blocks an SM, out[4] dynamic shared memory in bytes.  Returns a CUDA error
// code.
extern "C" int pdt_plane_sweep_kernel_info(int backward, int with_mixture,
                                           int image_grads, int N, int W, int* out) {
  const int img = backward && image_grads;
  if (W < 1 || W > kMaxW || (img && !with_mixture))
    return (int)cudaErrorInvalidValue;
  const int px = pixels_per_thread(W);
  const void* fn = !img ? sweep_instance<float>(backward, with_mixture, W)
                   : px == 1 ? (const void*)sweep_bwd_img_kernel<1>
                   : px == 2 ? (const void*)sweep_bwd_img_kernel<2>
                             : (const void*)sweep_bwd_img_kernel<4>;
  return kernel_info(fn, smem_bytes(backward, with_mixture, N, W, img), img, W, out);
}

// pdt_plane_sweep_kernel_info of the bf16 instances (forward, or the
// head-only backward).
extern "C" int pdt_plane_sweep_kernel_info_bf16(int backward, int with_mixture, int N, int W,
                                                int* out) {
  if (W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  return kernel_info(sweep_instance<__nv_bfloat16>(backward, with_mixture, W),
                     smem_bytes(backward, with_mixture, N, W, 0, 2), false, W, out);
}

// The current card's opt-in limit of dynamic shared memory a block, bytes.
// The widest row one launch takes; the wrapper runs wider rows in column
// segments.
extern "C" int pdt_plane_sweep_max_w() { return kMaxW; }

extern "C" int pdt_plane_sweep_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return bytes;
}
