// Fused softmax cross entropy for Hopper (sm_90a): the LM loss, its dh and
// its dW without the (N, V) logits, behind ops/fused_loss.py's autograd
// Function.
//
// Replaces the TPU kernels of pytorch_distributed_training_tutorials_tpu/
// ops/fused_loss.py:
//   forward <- _fwd_kernel (:89, pl.pallas_call at :255)
//   dh      <- _dh_kernel  (:159, pl.pallas_call at :289)
//   dW      <- _dw_kernel  (:190, pl.pallas_call at :311)
// They compute what those kernels compute, not block for block:
//
//   forward: s = h . W (f32 from operands in the input type), columns past V
//            masked to -inf; an online logsumexp over vocab tiles (running
//            max m, sum l, the -inf shift guarded) and the target logit
//            (the one column equal to y; a target out of [0, V) hits
//            nothing, so its loss is the lse). Emits lse and the target
//            logit per row, f32.
//   dS:      g * (exp(s - lse) - onehot(y)), recomputed from the saved lse.
//   dh:      sum over vocab of dS (rounded to W's type) . W^T, in h's type.
//   dW:      sum over rows of h^T . dS (rounded to h's type), in W's type.
//
// One template on the element type T: bf16 (the training path) multiplies
// on the tensor cores with mma.sync m16n8k16 and f32 accumulation; f32 runs
// the same tiles, loops and masks with the fragment product done on the
// CUDA cores (mma.cuh), so the tight f32 check exercises the bf16 path's
// code. No float atomics: every sum runs in a fixed order, results are the
// same from run to run.
//
// Layout, for D = 1536 (one 64-row block of h is 192 KB in bf16, and a
// 64 x 1536 f32 dh accumulator or a 1536 x 64 f32 dW one, 393 KB, fits
// neither the 227 KB of shared memory nor the registers of an SM):
// - Everything is built from one score tile: S = h[64 rows] . W[:, 128
//   columns], 8 warps of 32 x 32, the product looped over D in chunks of
//   64 staged through shared memory (h straight, W transposed, since
//   m16n8k16 wants both operands k-contiguous).
// - forward: a block owns 64 rows and a split of the vocab (so 4096 rows
//   still fill 132 SMs), keeps per-warp running (m, l, target) in
//   registers, combines its 4 column warps in shared memory and writes one
//   (lse, target) per row and split; the wrapper combines the splits
//   (a logsumexp over a handful of values per row).
// - dh: a block owns 64 rows and a vocab split. Per group of 4 score tiles
//   (512 vocab columns) it keeps dS (64 x 512, in W's type) in shared
//   memory, then adds dS . W[:, group]^T to an f32 accumulator in device
//   memory (its own rows and split, so no two blocks touch one element) in
//   128-column passes over D; the wrapper sums the splits' f32 partials
//   and casts to h's type.
// - dW: a block owns 128 vocab columns and all rows. Per group of 4 score
//   tiles (256 rows) it keeps dS^T (128 x 256) in shared memory, then adds
//   h[group]^T . dS to its f32 accumulator columns in 64-row passes over D;
//   the last group writes dW in W's type.
//
// Bytes moved at N 4096, D 1536, V 32768, bf16 (inputs read once: h 12.6
// MB, W 100.7 MB; outputs written once): the score tiles re-read W once
// per 64-row block (64 x 100.7 MB, mostly from L2: the blocks of one split
// stream the same columns together) and h once per 128-column tile (256 x
// 12.6 MB, L2-resident); dh adds one f32 read-modify-write of its 64 x
// 1536 accumulator per 512-column group (3.2 GB, L2 and HBM), dW one of its
// 1536 x 128 accumulator per 256-row group (3.2 GB). What bounds it on an
// H100: operations, 2 N D V = 412.3 GFLOP per score pass (0.417 ms at 989
// TFLOP/s); dh and dW each run a score pass and a gradient product (0.834
// ms). The kernels use mma.sync without TMA, wgmma or pipelined tile
// loads. The bf16 route on Hopper is fused_loss_sm90.cu (TMA, wgmma) for
// all three; these kernels keep f32, D or V not a multiple of 8 and
// misaligned operands (ops/fused_loss.py _sm90_route).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kWarps = 8;  // 2 (rows) x 4 (columns) of 32 x 32 warp tiles
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 64;              // rows of a score tile
constexpr int kBV = 128;             // vocab columns of a score tile
constexpr int kKC = 64;              // depth of a staged chunk
constexpr int kLd = kKC + 8;         // row of a staged chunk (padded: fragment loads spread over banks)
constexpr int kGroupV = 4;           // dh: score tiles whose dS stays in shared memory
constexpr int kGroupN = 4;           // dW: the same, along rows
constexpr int kLdDs = kGroupV * kBV + 8;   // a dS row (dh)
constexpr int kLdDst = kGroupN * kBM + 8;  // a dS^T row (dW)
constexpr int kDhCols = 128;         // dh columns per pass over a group
constexpr int kDwRows = 64;          // dW rows (hidden units) per pass over a group

struct Args {
  const void* h;        // (N, D) row-major, T
  const void* w;        // (D, V) row-major, T
  const long long* y;   // (N,) targets
  const float* lse;     // (N,) saved by the forward
  const float* g;       // (N,) the loss's cotangent
  float* part_lse;      // forward: (nsplit, N)
  float* part_tgt;      // forward: (nsplit, N)
  float* part;          // dh: (nsplit, N, D) f32; dW: (D, V) f32
  void* out;            // dW (D, V) in T, written by the last row group
  int N, D, V;
  int nsplit, tiles_per_split;
  int vec_h, vec_w;     // 16-byte loads allowed along h's rows, W's rows
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// rows [r0, r0 + rows) x columns [c0, c0 + cols) of a row-major matrix (row
// length ld_g) into shared memory, straight (dst[r * ld_s + c]) or
// transposed (dst[c * ld_s + r]); elements past row_lim or col_lim are
// zeros. Straight: consecutive threads take consecutive 16-byte pieces of a
// row. Transposed: consecutive threads take consecutive rows, so the
// scattered 2- or 4-byte stores of a warp land on distinct banks.
template <typename T, bool kTrans>
__device__ __forceinline__ void stage(T* dst, int ld_s, const T* src, long long ld_g, int r0,
                                      int c0, int rows, int cols, int row_lim, int col_lim,
                                      int vec) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  if (vec) {
    const int C = cols / E;
    for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
      const int r = kTrans ? idx % rows : idx / C;
      const int c = (kTrans ? idx / rows : idx % C) * E;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r0 + r < row_lim && c0 + c < col_lim)
        x = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld_g + c0 + c);
      if (kTrans) {
        const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int i = 0; i < E; ++i) dst[(c + i) * ld_s + r] = e[i];
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld_s + c) = x;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
      const int r = kTrans ? idx % rows : idx / cols;
      const int c = kTrans ? idx / rows : idx % cols;
      const T x = (r0 + r < row_lim && c0 + c < col_lim)
                      ? src[(long long)(r0 + r) * ld_g + c0 + c]
                      : Elem<T>::zero();
      if (kTrans)
        dst[c * ld_s + r] = x;
      else
        dst[r * ld_s + c] = x;
    }
  }
}

// acc[mt][nt] += A[16 mt + (0..16), k] . B[k, 8 nt + (0..8)] over k in
// [0, 16 KS): A row-major (k contiguous, row length lda), B stored by
// column (k contiguous, column length ldb); a warp's 32 x 32 tile
template <typename T, int KS>
__device__ __forceinline__ void warp_product(float (&acc)[2][4][4], const T* A, int lda,
                                             const T* B, int ldb, int g, int t) {
  using Pair = typename Elem<T>::Pair;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    Pair a0[4], a1[4];
    load_a<T>(a0, A, lda, 0, 16 * kk, g, t);
    load_a<T>(a1, A, lda, 16, 16 * kk, g, t);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const T* col = B + (8 * nt + g) * ldb + 16 * kk + 2 * t;
      const Pair b0 = Elem<T>::ld2(col), b1 = Elem<T>::ld2(col + 8);
      mma(acc[0][nt], a0, b0, b1);
      mma(acc[1][nt], a1, b0, b1);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
}

// S = h[r0 .. r0 + 64) . W[:, c0 .. c0 + 128), f32: this warp's 32 x 32 part
// (rows 32 wr + 16 mt + g (+ 8), columns 32 wc + 8 nt + 2t (+ 1))
template <typename T>
__device__ __forceinline__ void score_tile(float (&acc)[2][4][4], const Args& a, T* sA, T* sB,
                                           int r0, int c0, int wr, int wc, int g, int t) {
  const T* h = static_cast<const T*>(a.h);
  const T* w = static_cast<const T*>(a.w);
  zero(acc);
  for (int k0 = 0; k0 < a.D; k0 += kKC) {
    __syncthreads();
    stage<T, false>(sA, kLd, h, a.D, r0, k0, kBM, kKC, a.N, a.D, a.vec_h);
    stage<T, true>(sB, kLd, w, a.V, k0, c0, kKC, kBV, a.D, a.V, a.vec_w);
    __syncthreads();
    warp_product<T, kKC / 16>(acc, sA + wr * 32 * kLd, kLd, sB + wc * 32 * kLd, kLd, g, t);
  }
}

// what the backward needs of this thread's 4 rows (r0 + 32 wr + 16 mt + g +
// 8 half, i = 2 mt + half): the target, the guarded lse, the cotangent;
// rows past N get no target and a zero cotangent, so their dS is 0
struct Rows {
  long long y[4];
  float lse[4], g[4];
};

__device__ __forceinline__ Rows load_rows(const Args& a, int r0, int wr, int g) {
  Rows r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 32 * wr + 16 * (i >> 1) + g + 8 * (i & 1);
    const bool in = row < a.N;
    const float x = in ? a.lse[row] : 0.f;
    r.y[i] = in ? a.y[row] : -1;
    r.lse[i] = x == neg_inf() ? 0.f : x;  // the forward's -inf guard
    r.g[i] = in ? a.g[row] : 0.f;
  }
  return r;
}

__device__ __forceinline__ float dlogit(float s, int col, int i, const Rows& r, int V) {
  const float p = col < V ? expf(s - r.lse[i]) : 0.f;
  const float hit = (col < V && col == r.y[i]) ? 1.f : 0.f;
  return (p - hit) * r.g[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);  // [64][kLd]
  T* sB = sA + kBM * kLd;              // [128][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int r0 = blockIdx.x * kBM, split = blockIdx.y;
  const int n_vt = (a.V + kBV - 1) / kBV;
  const int vt0 = split * a.tiles_per_split, vt1 = min(n_vt, vt0 + a.tiles_per_split);
  long long y[4];
  float m[4], l[4], tg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 32 * wr + 16 * (i >> 1) + g + 8 * (i & 1);
    y[i] = row < a.N ? a.y[row] : -1;
    m[i] = neg_inf();
    l[i] = tg[i] = 0.f;
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int c0 = vt * kBV;
    float acc[2][4][4];
    score_tile<T>(acc, a, sA, sB, r0, c0, wr, wc, g, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mt = i >> 1, half = i & 1;
      float mx = neg_inf();
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + 32 * wc + 8 * nt + 2 * t + j;
          const float s = col < a.V ? acc[mt][nt][2 * half + j] : neg_inf();
          acc[mt][nt][2 * half + j] = s;
          mx = fmaxf(mx, s);
          if (col < a.V && col == y[i]) tg[i] += s;
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row that has seen only masked columns keeps m = -inf: shift by 0,
      // not by -inf (exp(-inf - -inf) would be NaN)
      const float shift = m_new == neg_inf() ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) rs += expf(acc[mt][nt][2 * half + j] - shift);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * expf(m[i] - shift) + rs;
      m[i] = m_new;
    }
  }
  // one lane of each row group holds the target logit (the others add 0)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tg[i] += __shfl_xor_sync(0xffffffffu, tg[i], 1);
    tg[i] += __shfl_xor_sync(0xffffffffu, tg[i], 2);
  }
  __syncthreads();  // the staging buffers become the column warps' exchange
  float* sM = reinterpret_cast<float*>(smem);  // [4][64] each
  float* sL = sM + 4 * kBM;
  float* sT = sL + 4 * kBM;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = 32 * wr + 16 * (i >> 1) + g + 8 * (i & 1);
      sM[wc * kBM + rl] = m[i];
      sL[wc * kBM + rl] = l[i];
      sT[wc * kBM + rl] = tg[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM) {
    const int rl = threadIdx.x, row = r0 + rl;
    float mm = neg_inf();
    for (int q = 0; q < 4; ++q) mm = fmaxf(mm, sM[q * kBM + rl]);
    const float shift = mm == neg_inf() ? 0.f : mm;
    float ll = 0.f, tt = 0.f;
    for (int q = 0; q < 4; ++q) {
      ll += sL[q * kBM + rl] * expf(sM[q * kBM + rl] - shift);
      tt += sT[q * kBM + rl];
    }
    if (row < a.N) {
      const float safe_l = ll == 0.f ? 1.f : ll;
      a.part_lse[(long long)split * a.N + row] = mm == neg_inf() ? neg_inf() : mm + logf(safe_l);
      a.part_tgt[(long long)split * a.N + row] = tt;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dh_kernel(const Args a) {
  using Pair = typename Elem<T>::Pair;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);  // [64][kLd]
  T* sB = sA + kBM * kLd;              // [128][kLd]
  T* sDs = sB + kBV * kLd;             // [64][kLdDs]: dS of a group, in W's type
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int r0 = blockIdx.x * kBM, split = blockIdx.y;
  const int n_vt = (a.V + kBV - 1) / kBV;
  const int vt0 = split * a.tiles_per_split, vt1 = min(n_vt, vt0 + a.tiles_per_split);
  const Rows rows = load_rows(a, r0, wr, g);
  const T* w = static_cast<const T*>(a.w);
  float* part = a.part + (long long)split * a.N * a.D;
  for (int vg = vt0; vg < vt1; vg += kGroupV) {
    const int ntile = min(kGroupV, vt1 - vg);
    const bool first = vg == vt0;
    for (int j = 0; j < ntile; ++j) {
      const int c0 = (vg + j) * kBV;
      float acc[2][4][4];
      score_tile<T>(acc, a, sA, sB, r0, c0, wr, wc, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = i >> 1, half = i & 1;
        const int rl = 32 * wr + 16 * mt + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int cl = 32 * wc + 8 * nt + 2 * t;
          const float d0 = dlogit(acc[mt][nt][2 * half], c0 + cl, i, rows, a.V);
          const float d1 = dlogit(acc[mt][nt][2 * half + 1], c0 + cl + 1, i, rows, a.V);
          // dS rounded to W's type before dS . W^T
          *reinterpret_cast<Pair*>(sDs + rl * kLdDs + j * kBV + cl) = Elem<T>::pair(d0, d1);
        }
      }
    }
    const int kv = ntile * kBV;
    for (int d0 = 0; d0 < a.D; d0 += kDhCols) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 32 * wr + 16 * mt + g + 8 * (e >> 1);
            const int col = d0 + 32 * wc + 8 * nt + 2 * t + (e & 1);
            acc[mt][nt][e] =
                (!first && row < a.N && col < a.D) ? part[(long long)row * a.D + col] : 0.f;
          }
      for (int k0 = 0; k0 < kv; k0 += kKC) {
        __syncthreads();  // also: the group's dS is complete before its first read
        stage<T, false>(sB, kLd, w, a.V, d0, vg * kBV + k0, kDhCols, kKC, a.D, a.V, a.vec_w);
        __syncthreads();
        warp_product<T, kKC / 16>(acc, sDs + 32 * wr * kLdDs + k0, kLdDs, sB + 32 * wc * kLd, kLd,
                                  g, t);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 32 * wr + 16 * mt + g + 8 * (e >> 1);
            const int col = d0 + 32 * wc + 8 * nt + 2 * t + (e & 1);
            if (row < a.N && col < a.D) part[(long long)row * a.D + col] = acc[mt][nt][e];
          }
    }
    __syncthreads();  // every warp is done reading this group's dS
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dw_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);  // [64][kLd]
  T* sB = sA + kBM * kLd;              // [128][kLd]
  T* sDst = sB + kBV * kLd;            // [128][kLdDst]: dS^T of a group, in h's type
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;
  const int c0 = blockIdx.x * kBV;
  const T* h = static_cast<const T*>(a.h);
  T* out = static_cast<T*>(a.out);
  for (int rg = 0; rg < a.N; rg += kGroupN * kBM) {
    const int ntile = min(kGroupN, (a.N - rg + kBM - 1) / kBM);
    const bool first = rg == 0, last = rg + kGroupN * kBM >= a.N;
    for (int j = 0; j < ntile; ++j) {
      const int r0 = rg + j * kBM;
      const Rows rows = load_rows(a, r0, wr, g);
      float acc[2][4][4];
      score_tile<T>(acc, a, sA, sB, r0, c0, wr, wc, g, t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1, i = 2 * mt + half;
            const int rl = j * kBM + 32 * wr + 16 * mt + g + 8 * half;
            const int cl = 32 * wc + 8 * nt + 2 * t + (e & 1);
            // dS rounded to h's type before h^T . dS, stored transposed
            sDst[cl * kLdDst + rl] = Elem<T>::cvt(dlogit(acc[mt][nt][e], c0 + cl, i, rows, a.V));
          }
    }
    const int kr = ntile * kBM;
    for (int d0 = 0; d0 < a.D; d0 += kDwRows) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + 32 * wr + 16 * mt + g + 8 * (e >> 1);
            const int v = c0 + 32 * wc + 8 * nt + 2 * t + (e & 1);
            acc[mt][nt][e] = (!first && d < a.D && v < a.V) ? a.part[(long long)d * a.V + v] : 0.f;
          }
      for (int k0 = 0; k0 < kr; k0 += kKC) {
        __syncthreads();  // also: the group's dS^T is complete before its first read
        // h[rows, d0 .. d0 + 64) transposed: the A operand h^T, k = rows
        stage<T, true>(sA, kLd, h, a.D, rg + k0, d0, kKC, kDwRows, a.N, a.D, a.vec_h);
        __syncthreads();
        warp_product<T, kKC / 16>(acc, sA + 32 * wr * kLd, kLd, sDst + 32 * wc * kLdDst + k0,
                                  kLdDst, g, t);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + 32 * wr + 16 * mt + g + 8 * (e >> 1);
            const int v = c0 + 32 * wc + 8 * nt + 2 * t + (e & 1);
            if (d >= a.D || v >= a.V) continue;
            const long long at = (long long)d * a.V + v;
            if (last)
              out[at] = Elem<T>::cvt(acc[mt][nt][e]);
            else
              a.part[at] = acc[mt][nt][e];
          }
    }
    __syncthreads();  // every warp is done reading this group's dS^T
  }
}

// ---------------------------------------------------------------------------
// launch

enum Which { kFwd, kDh, kDw };

template <typename T>
int launch_type(Which which, const Args& a, cudaStream_t s) {
  const size_t staging = (size_t)(kBM + kBV) * kLd * sizeof(T);
  void (*fn)(const Args);
  size_t smem;
  dim3 grid;
  switch (which) {
    case kFwd:
      fn = fwd_kernel<T>;
      smem = staging;
      grid = dim3((a.N + kBM - 1) / kBM, a.nsplit);
      break;
    case kDh:
      fn = dh_kernel<T>;
      smem = staging + (size_t)kBM * kLdDs * sizeof(T);
      grid = dim3((a.N + kBM - 1) / kBM, a.nsplit);
      break;
    default:
      fn = dw_kernel<T>;
      smem = staging + (size_t)kBV * kLdDst * sizeof(T);
      grid = dim3((a.V + kBV - 1) / kBV, 1);
      break;
  }
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16
int launch(Which which, Args& a, int dtype, void* stream) {
  if (a.N <= 0 || a.D <= 0 || a.V <= 0 || a.nsplit <= 0 || a.tiles_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.nsplit > 65535 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const int e = dtype == 0 ? 4 : 8;  // elements per 16-byte load
  a.vec_h = reinterpret_cast<uintptr_t>(a.h) % 16 == 0 && a.D % e == 0;
  a.vec_w = reinterpret_cast<uintptr_t>(a.w) % 16 == 0 && a.V % e == 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_type<float>(which, a, s) : launch_type<bf16>(which, a, s);
}

Args make_args(const void* h, const void* w, const void* y, int N, int D, int V, int nsplit,
               int tiles_per_split) {
  Args a{};
  a.h = h;
  a.w = w;
  a.y = static_cast<const long long*>(y);
  a.N = N;
  a.D = D;
  a.V = V;
  a.nsplit = nsplit;
  a.tiles_per_split = tiles_per_split;
  return a;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take). h is (N, D) and w (D, V), both contiguous in the input type; y is
// (N,) int64; lse, g, part_lse, part_tgt and part are f32 contiguous. The
// vocab is cut into nsplit splits of tiles_per_split 128-column tiles.

extern "C" int fused_ce_fwd_launch(const void* h, const void* w, const void* y, void* part_lse,
                                   void* part_tgt, int N, int D, int V, int nsplit,
                                   int tiles_per_split, int dtype, void* stream) {
  Args a = make_args(h, w, y, N, D, V, nsplit, tiles_per_split);
  a.part_lse = static_cast<float*>(part_lse);
  a.part_tgt = static_cast<float*>(part_tgt);
  return launch(kFwd, a, dtype, stream);
}

extern "C" int fused_ce_dh_launch(const void* h, const void* w, const void* y, const void* lse,
                                  const void* g, void* part, int N, int D, int V, int nsplit,
                                  int tiles_per_split, int dtype, void* stream) {
  Args a = make_args(h, w, y, N, D, V, nsplit, tiles_per_split);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  return launch(kDh, a, dtype, stream);
}

extern "C" int fused_ce_dw_launch(const void* h, const void* w, const void* y, const void* lse,
                                  const void* g, void* part, void* out, int N, int D, int V,
                                  int dtype, void* stream) {
  Args a = make_args(h, w, y, N, D, V, 1, (V + kBV - 1) / kBV);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  a.out = out;
  return launch(kDw, a, dtype, stream);
}
