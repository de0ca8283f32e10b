// Causal flash attention for Hopper (sm_90a): the forward, the dq and the
// dk/dv kernels behind ops/flash_attention.py's autograd Function.
//
// Replaces the TPU kernels of pytorch_distributed_training_tutorials_tpu/
// ops/flash_attention.py:
//   forward  <- _fwd_kernel (:50, pl.pallas_call at :265)
//   dq       <- _dq_kernel  (:113, pl.pallas_call at :367)
//   dk, dv   <- _dkv_kernel (:157, pl.pallas_call at :394)
// They compute what those kernels compute, not block for block:
//
//   forward: s = (q . k) * scale, masked causally; online softmax over key
//            blocks (running max m, sum l, f32 accumulator acc), the -inf
//            shift guarded; p is rounded to v's type before p . v;
//            O = acc / l in the input type, lse = m + log(l) in f32.
//   dq:      p = exp(s - lse), dp = dO . v, ds = p * (dp - delta);
//            dq = sum over key blocks of ds (rounded to k's type) . k,
//            times scale.
//   dk, dv:  the same tiles transposed (rows keys, columns queries):
//            dv = sum over query blocks of p (rounded to dO's type) . dO,
//            dk = sum of ds (rounded to q's type) . q, times scale.
//
// Scores, softmax and every accumulator are f32. delta = rowsum(dO * O) is
// computed outside, as in the JAX package.
//
// One implementation, FlashAttention-2 style, templated on the element type
// T (bf16, the training path, or f32) and the padded head dim DP. A block of
// 4 warps owns 64 query rows (forward, dq) or 64 keys (dk/dv), 16 per warp,
// and multiplies 16 x 8 x 16 tiles held in mma.sync m16n8k16 fragments.
// Tiles sit in shared memory in T (rows padded by 8 elements, so a warp's
// fragment loads spread over the banks); the K/V or Q/dO tiles a product
// reads as its B operand along the sequence are stored transposed, and a
// score fragment becomes the A operand of the next product in registers
// (where the p and ds roundings to bf16 happen). The fragment helpers live
// in mma.cuh, shared with fused_loss.cu. The product itself:
// - bf16: the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32;
// - f32: the same fragment product on the CUDA cores, each lane gathering
//   its rows of A and columns of B from its warp by shuffles (mma_f32), so
//   the f32 instance runs the tiles, loops, masks and softmax of the bf16
//   path exactly, in f32 throughout, and can be held tightly against the
//   plain version.
//
// Design for a card whose blocks run in parallel and in no order:
// - No sequential grid and no carry between blocks. A forward or dq block
//   loops over the key blocks itself, up to the diagonal only; a dk/dv
//   block loops over the query tiles from the diagonal on. dq and dk/dv
//   are separate kernels, so nothing is reduced across blocks: no atomics,
//   results are the same from run to run.
// - The work per block is unbalanced (a query block near the end of the
//   sequence sees every key block). The grid is (B*H, blocks) and the block
//   scheduler walks blockIdx.x fastest, so the heaviest blocks of every
//   head are handed out first: the forward and dq take query block
//   n_q - 1 - blockIdx.y, dk/dv take key block blockIdx.y.
// - Ragged S: tiles past S load as zeros, keys past S and queries past S
//   are masked, rows past S are not stored. No padding copies.
// - Layout: (B, S, H, D) with any strides on B, S and H (D contiguous),
//   passed per tensor; nothing is transposed to (B*H, S, D) in memory.
//   Tiles load 16 bytes at a time where every stride and pointer allows.
// - D: any multiple of 8 up to 128, padded to DP, a multiple of 16, with
//   zeros in shared memory.
//
// What bounds it on an H100: the causal products are 2-4 matmuls of
// B*H*S*S/2*D multiply-adds each, so at the 760m shape (B 2, S 2048, H 16,
// D 96) the work is operations-bound against the bf16 tensor cores (0.026
// ms of tensor-core time against 0.008 ms of bytes for the forward). The
// kernels use mma.sync without TMA, wgmma or pipelining of the tile loads.
// The bf16 route of all three on Hopper is flash_attention_sm90.cu (TMA,
// wgmma); the kernels here keep f32 and the views a TMA map cannot take
// (ops/flash_attention.py _sm90_route).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

struct Layout {  // element strides of the B, S, H axes
  long long sb, ss, sh;
};

namespace {

constexpr int kBlock = 64;  // query rows and keys per block tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPadT = kBlock + 8;  // row of a transposed 64-wide tile
constexpr int kQt = 32;            // query columns per dk/dv step
constexpr int kPadQt = kQt + 8;    // row of a transposed 32-wide tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;
  void* dq;
  void* dk;
  void* dv;
  float* lse;           // (B, H, S) f32: written by the forward
  const float* lse_in;  // read by the backward
  const float* delta;   // (B, H, S) f32
  Layout lq, lk, lv, ldo, lo, ldq, ldk, ldv;
  int B, S, H, D;
  int vec;  // every tensor's strides and pointer allow 16-byte loads
  float scale;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const Layout& l, int b, int h) {
  return static_cast<const T*>(base) + b * l.sb + h * l.sh;
}

template <typename T>
__device__ __forceinline__ T* head_ptr_mut(void* base, const Layout& l, int b, int h) {
  return static_cast<T*>(base) + b * l.sb + h * l.sh;
}

// rows [r0, r0 + rows) of one head of a (B, S, H, D) tensor into a shared
// tile, row-major (row length DP + 8) and/or transposed (row length ld_t,
// one row per head-dim column); rows past S and columns past D are zeros
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* row_tile, T* t_tile, int ld_t, const T* head,
                                          long long ss, int r0, int rows, int S, int D, int vec) {
  constexpr int ld = DP + 8;
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  if (vec) {
    constexpr int C = DP / E;
    for (int idx = threadIdx.x; idx < rows * C; idx += kThreads) {
      const int r = idx / C, d0 = (idx - r * C) * E;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r0 + r < S && d0 < D)
        x = *reinterpret_cast<const uint4*>(head + (long long)(r0 + r) * ss + d0);
      if (row_tile) *reinterpret_cast<uint4*>(row_tile + r * ld + d0) = x;
      if (t_tile) {
        const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int i = 0; i < E; ++i) t_tile[(d0 + i) * ld_t + r] = e[i];
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
      const int r = idx / DP, d = idx - r * DP;
      const T x = (r0 + r < S && d < D) ? head[(long long)(r0 + r) * ss + d] : Elem<T>::zero();
      if (row_tile) row_tile[r * ld + d] = x;
      if (t_tile) t_tile[d * ld_t + r] = x;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Args a) {
  using Pair = typename Elem<T>::Pair;
  constexpr int ld = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [64][ld]
  T* sK = sQ + kBlock * ld;                // [64][ld]
  T* sVt = sK + kBlock * ld;               // [DP][kPadT]
  const int S = a.S, D = a.D;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const T* kh = head_ptr<T>(a.k, a.lk, b, h);
  const T* vh = head_ptr<T>(a.v, a.lv, b, h);

  load_tile<T, DP>(sQ, nullptr, 0, head_ptr<T>(a.q, a.lq, b, h), a.lq.ss, q0, kBlock, S, D, a.vec);
  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const int qrow = q0 + 16 * w + g;  // this thread's rows: qrow, qrow + 8
  const int kend = min(S, q0 + kBlock);
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    __syncthreads();
    load_tile<T, DP>(sK, nullptr, 0, kh, a.lk.ss, k0, kBlock, S, D, a.vec);
    load_tile<T, DP>(nullptr, sVt, kPadT, vh, a.lv.ss, k0, kBlock, S, D, a.vec);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      Pair af[4];
      load_a<T>(af, sQ, ld, 16 * w, 16 * kc, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_b<T>(s[j], af, sK + (8 * j + g) * ld + 16 * kc + 2 * t);
    }
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qrow + (e >> 1) * 8, kpos = k0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = (kpos <= qpos && kpos < S) ? s[j][e] * a.scale : neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float shift[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row that has seen only masked keys keeps m = -inf: shift by 0,
      // not by -inf (exp(-inf - -inf) would be NaN)
      shift[r] = m_new == neg_inf() ? 0.f : m_new;
      corr[r] = expf(m[r] - shift[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - shift[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      Pair pf[4];
      frag_to_a<T>(pf, s[2 * kc], s[2 * kc + 1]);  // p rounded to v's type
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) mma_b<T>(o[n], pf, sVt + (8 * n + g) * kPadT + 16 * kc + 2 * t);
    }
  }
  T* oh = head_ptr_mut<T>(a.o, a.lo, b, h);
  float* lse = a.lse + ((long long)b * a.H + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qrow + 8 * r;
    if (qpos >= S) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        Elem<T>::store2(oh + (long long)qpos * a.lo.ss + d, o[n][2 * r] / safe_l,
                        o[n][2 * r + 1] / safe_l);
    }
    if (t == 0) lse[qpos] = m[r] == neg_inf() ? neg_inf() : m[r] + logf(safe_l);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  using Pair = typename Elem<T>::Pair;
  constexpr int ld = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [64][ld]
  T* sDO = sQ + kBlock * ld;               // [64][ld]
  T* sK = sDO + kBlock * ld;               // [64][ld]
  T* sV = sK + kBlock * ld;                // [64][ld]
  T* sKt = sV + kBlock * ld;               // [DP][kPadT]
  const int S = a.S, D = a.D;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const T* kh = head_ptr<T>(a.k, a.lk, b, h);
  const T* vh = head_ptr<T>(a.v, a.lv, b, h);
  const long long row0 = ((long long)b * a.H + h) * S;

  load_tile<T, DP>(sQ, nullptr, 0, head_ptr<T>(a.q, a.lq, b, h), a.lq.ss, q0, kBlock, S, D, a.vec);
  load_tile<T, DP>(sDO, nullptr, 0, head_ptr<T>(a.dout, a.ldo, b, h), a.ldo.ss, q0, kBlock, S, D,
                   a.vec);
  const int qrow = q0 + 16 * w + g;
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qrow + 8 * r;
    const float x = qpos < S ? a.lse_in[row0 + qpos] : 0.f;
    lse[r] = x == neg_inf() ? 0.f : x;  // the forward's guard
    delta[r] = qpos < S ? a.delta[row0 + qpos] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int kend = min(S, q0 + kBlock);
  for (int k0 = 0; k0 < kend; k0 += kBlock) {
    __syncthreads();
    load_tile<T, DP>(sK, sKt, kPadT, kh, a.lk.ss, k0, kBlock, S, D, a.vec);
    load_tile<T, DP>(sV, nullptr, 0, vh, a.lv.ss, k0, kBlock, S, D, a.vec);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      Pair qf[4], of[4];
      load_a<T>(qf, sQ, ld, 16 * w, 16 * kc, g, t);
      load_a<T>(of, sDO, ld, 16 * w, 16 * kc, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mma_b<T>(s[j], qf, sK + (8 * j + g) * ld + 16 * kc + 2 * t);
        mma_b<T>(dp[j], of, sV + (8 * j + g) * ld + 16 * kc + 2 * t);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qpos = qrow + 8 * r, kpos = k0 + 8 * j + 2 * t + (e & 1);
        const float p = (kpos <= qpos && kpos < S) ? expf(s[j][e] * a.scale - lse[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - delta[r]);  // ds
      }
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      Pair df[4];
      frag_to_a<T>(df, s[2 * kc], s[2 * kc + 1]);  // ds rounded to k's type
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        mma_b<T>(acc[n], df, sKt + (8 * n + g) * kPadT + 16 * kc + 2 * t);
    }
  }
  T* dqh = head_ptr_mut<T>(a.dq, a.ldq, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qrow + 8 * r;
    if (qpos >= S) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D)
        Elem<T>::store2(dqh + (long long)qpos * a.ldq.ss + d, acc[n][2 * r] * a.scale,
                        acc[n][2 * r + 1] * a.scale);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Args a) {
  using Pair = typename Elem<T>::Pair;
  constexpr int ld = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);                    // [64][ld]
  T* sV = sK + kBlock * ld;                                  // [64][ld]
  T* sQ = sV + kBlock * ld;                                  // [32][ld]
  T* sDO = sQ + kQt * ld;                                    // [32][ld]
  T* sQt = sDO + kQt * ld;                                   // [DP][kPadQt]
  T* sDOt = sQt + DP * kPadQt;                               // [DP][kPadQt]
  float* sLse = reinterpret_cast<float*>(sDOt + DP * kPadQt);  // [32]
  float* sDelta = sLse + kQt;                                  // [32]
  const int S = a.S, D = a.D;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int k0 = blockIdx.y * kBlock;
  const T* qh = head_ptr<T>(a.q, a.lq, b, h);
  const T* doh = head_ptr<T>(a.dout, a.ldo, b, h);
  const long long row0 = ((long long)b * a.H + h) * S;

  load_tile<T, DP>(sK, nullptr, 0, head_ptr<T>(a.k, a.lk, b, h), a.lk.ss, k0, kBlock, S, D, a.vec);
  load_tile<T, DP>(sV, nullptr, 0, head_ptr<T>(a.v, a.lv, b, h), a.lv.ss, k0, kBlock, S, D, a.vec);
  const int krow = k0 + 16 * w + g;  // this thread's keys: krow, krow + 8
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // query tiles at or below the diagonal: the first is the one holding k0
  for (int q0 = k0; q0 < S; q0 += kQt) {
    __syncthreads();
    load_tile<T, DP>(sQ, sQt, kPadQt, qh, a.lq.ss, q0, kQt, S, D, a.vec);
    load_tile<T, DP>(sDO, sDOt, kPadQt, doh, a.ldo.ss, q0, kQt, S, D, a.vec);
    if (threadIdx.x < kQt) {
      const int qpos = q0 + threadIdx.x;
      const float x = qpos < S ? a.lse_in[row0 + qpos] : 0.f;
      sLse[threadIdx.x] = x == neg_inf() ? 0.f : x;
      sDelta[threadIdx.x] = qpos < S ? a.delta[row0 + qpos] : 0.f;
    }
    __syncthreads();
    float st[kQt / 8][4], dpt[kQt / 8][4];
#pragma unroll
    for (int j = 0; j < kQt / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      Pair kf[4], vf[4];
      load_a<T>(kf, sK, ld, 16 * w, 16 * kc, g, t);
      load_a<T>(vf, sV, ld, 16 * w, 16 * kc, g, t);
#pragma unroll
      for (int j = 0; j < kQt / 8; ++j) {
        mma_b<T>(st[j], kf, sQ + (8 * j + g) * ld + 16 * kc + 2 * t);
        mma_b<T>(dpt[j], vf, sDO + (8 * j + g) * ld + 16 * kc + 2 * t);
      }
    }
#pragma unroll
    for (int j = 0; j < kQt / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int kpos = krow + 8 * (e >> 1), qpos = q0 + c;
        const float pt =
            (kpos <= qpos && qpos < S) ? expf(st[j][e] * a.scale - sLse[c]) : 0.f;
        st[j][e] = pt;
        dpt[j][e] = pt * (dpt[j][e] - sDelta[c]);  // ds^T
      }
#pragma unroll
    for (int kc = 0; kc < kQt / 16; ++kc) {
      Pair pf[4], df[4];
      frag_to_a<T>(pf, st[2 * kc], st[2 * kc + 1]);    // p rounded to dO's type
      frag_to_a<T>(df, dpt[2 * kc], dpt[2 * kc + 1]);  // ds rounded to q's type
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        mma_b<T>(dv[n], pf, sDOt + (8 * n + g) * kPadQt + 16 * kc + 2 * t);
        mma_b<T>(dk[n], df, sQt + (8 * n + g) * kPadQt + 16 * kc + 2 * t);
      }
    }
  }
  T* dkh = head_ptr_mut<T>(a.dk, a.ldk, b, h);
  T* dvh = head_ptr_mut<T>(a.dv, a.ldv, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = krow + 8 * r;
    if (kpos >= S) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D) {
        Elem<T>::store2(dkh + (long long)kpos * a.ldk.ss + d, dk[n][2 * r] * a.scale,
                        dk[n][2 * r + 1] * a.scale);
        Elem<T>::store2(dvh + (long long)kpos * a.ldv.ss + d, dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch

enum Which { kFwd, kDq, kDkv };

using Kernel = void (*)(const Args);

int run(Kernel fn, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.B * a.H, (a.S + kBlock - 1) / kBlock);
  fn<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dp(Which w, const Args& a, cudaStream_t s) {
  const size_t row = (size_t)(DP + 8) * sizeof(T);
  const size_t t64 = (size_t)DP * kPadT * sizeof(T);
  switch (w) {
    case kFwd: return run(fwd_kernel<T, DP>, 2 * kBlock * row + t64, a, s);
    case kDq: return run(dq_kernel<T, DP>, 4 * kBlock * row + t64, a, s);
    default:
      return run(dkv_kernel<T, DP>,
                 2 * kBlock * row + 2 * kQt * row + 2 * (size_t)DP * kPadQt * sizeof(T) +
                     2 * kQt * sizeof(float),
                 a, s);
  }
}

// ceil(D / 16) selects the padded head dim DP = 16 x it
template <typename T>
int launch_type(Which w, const Args& a, cudaStream_t s) {
  switch ((a.D + 15) / 16) {
    case 1: return launch_dp<T, 16>(w, a, s);
    case 2: return launch_dp<T, 32>(w, a, s);
    case 3: return launch_dp<T, 48>(w, a, s);
    case 4: return launch_dp<T, 64>(w, a, s);
    case 5: return launch_dp<T, 80>(w, a, s);
    case 6: return launch_dp<T, 96>(w, a, s);
    case 7: return launch_dp<T, 112>(w, a, s);
    default: return launch_dp<T, 128>(w, a, s);
  }
}

bool vec_ok(const void* p, const Layout& l, int elem) {
  const int e = 16 / elem;  // elements per 16-byte load
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && l.sb % e == 0 && l.ss % e == 0 &&
         l.sh % e == 0;
}

// dtype: 0 = float32, 1 = bfloat16
int launch(Which w, Args& a, int dtype, void* stream) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  if (a.D < 8 || a.D > 128 || a.D % 8) return (int)cudaErrorInvalidValue;
  if ((long long)a.B * a.H >= (1LL << 31) || (a.S + kBlock - 1) / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.o, a.dq, a.dk, a.dv};
  const Layout* lays[] = {&a.lq, &a.lk, &a.lv, &a.ldo, &a.lo, &a.ldq, &a.ldk, &a.ldv};
  a.vec = 1;
  for (int i = 0; i < 8; ++i)
    if (ptrs[i] != nullptr && !vec_ok(ptrs[i], *lays[i], elem)) a.vec = 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_type<float>(w, a, s) : launch_type<bf16>(w, a, s);
}

Args make_args(int B, int S, int H, int D, float scale) {
  Args a{};
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  return a;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or type it does
// not take). q, k, v, dout, o, dq, dk, dv are (B, S, H, D) in the input
// type with the given strides; lse and delta are (B, H, S) f32 contiguous.

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                Layout lq, Layout lk, Layout lv, Layout lo, int B, int S, int H,
                                int D, int dtype, float scale, void* stream) {
  Args a = make_args(B, S, H, D, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.lq = lq;
  a.lk = lk;
  a.lv = lv;
  a.lo = lo;
  return launch(kFwd, a, dtype, stream);
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, Layout lq, Layout lk,
                               Layout lv, Layout ldo, Layout ldq, int B, int S, int H, int D,
                               int dtype, float scale, void* stream) {
  Args a = make_args(B, S, H, D, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.lq = lq;
  a.lk = lk;
  a.lv = lv;
  a.ldo = ldo;
  a.ldq = ldq;
  return launch(kDq, a, dtype, stream);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, Layout lq,
                                Layout lk, Layout lv, Layout ldo, Layout ldk, Layout ldv, int B,
                                int S, int H, int D, int dtype, float scale, void* stream) {
  Args a = make_args(B, S, H, D, scale);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.lq = lq;
  a.lk = lk;
  a.lv = lv;
  a.ldo = ldo;
  a.ldk = ldk;
  a.ldv = ldv;
  return launch(kDkv, a, dtype, stream);
}
