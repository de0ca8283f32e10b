// Paged decode attention for Hopper (sm_90a): the pages split across
// blocks (flash-decoding), each (page, kv head) tile loaded by TMA into a
// ring of shared-memory stages. ops/paged_attention.py routes a CUDA call
// here when every stored K/V row is a whole number of 16-byte pieces and
// the pools are 16-byte aligned (what TMA takes); every other call runs
// paged_attention.cu's kernel.
//
// Replaces, as paged_attention.cu does, the TPU kernel
// pytorch_distributed_training_tutorials_tpu/ops/paged_attention.py:kernel
// (:123, pl.pallas_call at :234), and computes what it computes:
//
//   out[b, s, h] = sum_t softmax_t(q[b, s, h] . k[t] / sqrt(D)) v[t]
//
// over the positions t <= pos[b] + s of row b, position t at offset
// t % page_size of pool page table[b, t / page_size]; page ids at or past
// n_pages (the sentinel) are skipped, so a parked row writes exact zeros.
// A position past pos[b] + S - 1 contributes nothing, not even 0 * v: a
// recycled page's tail may hold a previous tenant's NaN.
// Quantized pools dequantize per element as the v1 kernel does: int8 codes
// times f32 scales, int4 half-split nibbles times bf16 scales, each product
// rounded to bf16 when q is bf16; p rounds to the V tile's type before the
// PV product; the shift guard; out = acc / (l == 0 ? 1 : l). f32 pools are
// computed in f32 on the CUDA cores (no TF32).
//
// What bounds it on an H100: bytes. One call at the paged stream's depths
// reads 8.5 MB of f32 K/V (2.56 us at 3.35 TB/s) and does about 2 flops a
// byte, far below the ridge, so the work is keeping bytes in flight on
// every SM. The design:
//
// - Grid (B, KV, splits), splits slowest so that the blocks of the early
//   splits, where every row has pages, are scheduled first and the many
//   blocks past a row's last page last: split j of row b takes its logical
//   pages [j pps, (j + 1) pps). pps comes from the table's width alone
//   (ops/paged_attention.py _sm90_plan), never from pos, so the grid is
//   fixed for a given table (no host sync; a graph can capture it). At the
//   stream shape pps is 1: 34 live pages x 4 kv heads = 136 working blocks
//   on 132 SMs. A block reads pos[b] on the card and exits when its split
//   lies past the row's last live page.
// - One producer warp reads each page id from the table on the card and
//   loads the page's K and V tiles of head c by TMA (a rank-3 map of the
//   pool as (N * page_size, KV, D_store), box {D_store, 1, page_size}) into
//   a ring of min(2, pps) stages, K and V on their own full barriers, so V
//   lands while the scores are computed and page p + 1 while page p is; the
//   split's first page is read beside pos and its copy started before pos
//   arrives, as the block's chain of dependent loads is what sets its
//   time; the producer's lanes load the quantized pools' scales (strided
//   by KV) with plain loads and publish them on the same barriers.
// - Scores: a lane per position, a warp per 32 positions (and, on a page
//   of fewer than 128, per share of the query rows): the lane walks its K
//   row in 16-byte pieces (4 f32, 8 bf16, 16 int8 codes or 32 int4
//   nibbles), each dequantized in registers once and dotted with up to 8
//   query rows (q in shared memory, 16-byte reads), the pieces in an order
//   rotated by lane so that a shared-memory phase touches every bank group;
//   no shuffles, and the rows' dots are independent chains. (A first
//   version spread each K row across the lanes and met in 5 dependent
//   shuffles per row and position: latency-bound.)
//   Softmax: a warp per query row. PV: each warp takes a quarter of the
//   page's positions and every other query row, each lane 4 of D, and keeps
//   its quarter's (row, D) partial in shared memory, rescaled by the row's
//   correction per page; the four partials are summed, in order, once per
//   block. Eight consumer warps: one block's work is short dependent chains
//   (shared-memory loads feeding FMAs), so the warps are what hides them.
// - Combine: each working block writes its (m, l, acc) record; the last of
//   a (b, c) pair to arrive (an atomic ticket it resets to 0 for the next
//   call) merges the records in split order: M = max m_j, w_j = exp(m_j -
//   M) (the shift guarded), L = sum l_j w_j, A = sum acc_j w_j, out = A /
//   (L == 0 ? 1 : L), with (m, l) read in one 8-byte load a split and the
//   acc records 32 loads a thread at a time. Fixed orders everywhere: two
//   calls are bitwise equal.
//   ops/paged_attention.py paged_attention_plain(pages_per_split=) states
//   the same split and merge.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kConsumers = 256;  // 8 consumer warps: the work is latency-bound
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxShared = 232448;

enum Store { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

struct Args {
  const void* q;
  const void* k_scale;
  const void* v_scale;
  const int* table;
  const void* pos;
  void* out;
  float* rec_ml;   // (B, KV, splits, sg, 2): m, l
  float* rec_acc;  // (B, KV, splits, sg, D)
  int* tickets;    // (B * KV), 0 between calls
  int pos64, B, S, H, KV, D, ps, P, n_pages, pps, splits, stages, row_bytes;
  float sm_scale;
};

// the kernel's shared memory; ops/paged_attention.py _sm90_shared_bytes
// states the same sum
struct Layout {
  int tile, stage, bars, floats, total;
  __host__ __device__ Layout(int stages, int ps, int row_bytes, int sg, int d, int splits) {
    tile = (ps * row_bytes + 127) / 128 * 128;  // a K or V tile, 128-byte aligned for TMA
    stage = (2 * tile + 8 * ps + 127) / 128 * 128;  // K, V, then their f32 scales
    bars = stages * stage;                  // 3 * stages (<= 6) mbarriers, then the flag
    floats = bars + 64;                     // 16-byte aligned: q is read in 16-byte pieces
    total = 128 + floats + 4 * sg * (5 * d + ps + 4 + 2 * splits);
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float nibble(uint32_t byte, int hi) {
  const int n = hi ? (int)(byte >> 4) & 0xF : (int)byte & 0xF;
  return (float)(n >= 8 ? n - 16 : n);
}

// elements a lane dequantizes from one 16-byte piece of a stored row
template <int STORE>
struct Piece {
  static constexpr int E = STORE == kF32 ? 4 : STORE == kBF16 ? 8 : STORE == kInt8 ? 16 : 32;
};

// The 16-byte piece `seg` of a stored K row as f32 values; e < 16 at d =
// 16 seg + e for int8, and for int4 e < 16 at d = 16 seg + e (low
// nibbles) and e >= 16 at d = D / 2 + 16 seg + e - 16 (high nibbles)
template <int STORE, bool kRound>
__device__ __forceinline__ void dequant_piece(uint4 w, float s, float (&v)[Piece<STORE>::E]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (STORE == kF32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(u[i]);
  } else if constexpr (STORE == kBF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_lo(u[i]);
      v[2 * i + 1] = bf16_hi(u[i]);
    }
  } else if constexpr (STORE == kInt8) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float x = __fmul_rn((float)(int8_t)(u[i / 4] >> (8 * (i % 4))), s);
      v[i] = kRound ? round_bf16(x) : x;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (u[i / 4] >> (8 * (i % 4))) & 0xFFu;
      const float lo = __fmul_rn(nibble(byte, 0), s), hi = __fmul_rn(nibble(byte, 1), s);
      v[i] = kRound ? round_bf16(lo) : lo;
      v[16 + i] = kRound ? round_bf16(hi) : hi;
    }
  }
}

// q row qr (f32, in shared memory) dotted with the values of piece j
// (dequant_piece's order), 16-byte reads of q
template <int STORE>
__device__ __forceinline__ float qdot(const float* qr, int j, int d,
                                      const float (&kv)[Piece<STORE>::E]) {
  constexpr int E = Piece<STORE>::E;
  float s = 0.f;
  if constexpr (STORE == kInt4) {
    const float4* lo = reinterpret_cast<const float4*>(qr + 16 * j);
    const float4* hi = reinterpret_cast<const float4*>(qr + d / 2 + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = lo[i], b = hi[i];
      s = fmaf(a.x, kv[4 * i], s);
      s = fmaf(a.y, kv[4 * i + 1], s);
      s = fmaf(a.z, kv[4 * i + 2], s);
      s = fmaf(a.w, kv[4 * i + 3], s);
      s = fmaf(b.x, kv[16 + 4 * i], s);
      s = fmaf(b.y, kv[16 + 4 * i + 1], s);
      s = fmaf(b.z, kv[16 + 4 * i + 2], s);
      s = fmaf(b.w, kv[16 + 4 * i + 3], s);
    }
  } else {
    const float4* q4 = reinterpret_cast<const float4*>(qr + E * j);
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 a = q4[i];
      s = fmaf(a.x, kv[4 * i], s);
      s = fmaf(a.y, kv[4 * i + 1], s);
      s = fmaf(a.z, kv[4 * i + 2], s);
      s = fmaf(a.w, kv[4 * i + 3], s);
    }
  }
  return s;
}

// the 4 values of a stored V row at d = 4 lane .. 4 lane + 3
template <int STORE, bool kRound>
__device__ __forceinline__ void dequant4(const uint8_t* row, int lane, int d, float s,
                                         float (&v)[4]) {
  if constexpr (STORE == kF32) {
    const float4 f = *reinterpret_cast<const float4*>(row + 16 * lane);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else if constexpr (STORE == kBF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * lane);
    v[0] = bf16_lo(w.x);
    v[1] = bf16_hi(w.x);
    v[2] = bf16_lo(w.y);
    v[3] = bf16_hi(w.y);
  } else if constexpr (STORE == kInt8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __fmul_rn((float)(int8_t)(w >> (8 * i)), s);
      v[i] = kRound ? round_bf16(x) : x;
    }
  } else {
    const int hi = 4 * lane >= d / 2;  // high nibbles hold d / 2 .. d - 1
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * lane - (hi ? d / 2 : 0));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = __fmul_rn(nibble((w >> (8 * i)) & 0xFFu, hi), s);
      v[i] = kRound ? round_bf16(x) : x;
    }
  }
}

template <typename TQ, int STORE>
__global__ void __launch_bounds__(kThreads)
    paged_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const Args a) {
  constexpr bool kQuant = STORE == kInt8 || STORE == kInt4;
  constexpr bool kBf16Q = sizeof(TQ) == 2;
  constexpr bool kRoundKV = kQuant && kBf16Q;  // dequantized values take q's type
  constexpr bool kRoundP = kQuant ? kBf16Q : STORE == kBF16;  // p takes the V tile's
  constexpr int E = Piece<STORE>::E;

  const int b = blockIdx.x, c = blockIdx.y, split = blockIdx.z;
  const int grp = a.H / a.KV, sg = a.S * grp, D = a.D, ps = a.ps;
  // the split's first page id and pos, read together: the first page's
  // copy starts as soon as its id lands, before pos says whether the
  // split holds a live position (a block past the row's last page waits
  // for that copy before it exits; only pages allocated ahead of pos are
  // copied for nothing)
  const int* trow = a.table + (long long)b * a.P;
  const int p0 = split * a.pps;
  const int pid0 = p0 < a.P ? trow[p0] : -1;
  const bool early = pid0 >= 0 && pid0 < a.n_pages;
  const long long depth = a.pos64 ? static_cast<const long long*>(a.pos)[b]
                                  : static_cast<const int*>(a.pos)[b];

  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const Layout L(a.stages, ps, a.row_bytes, sg, D, a.splits);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* vfull = kfull + a.stages;
  uint64_t* empty = vfull + a.stages;
  int* last_flag = reinterpret_cast<int*>(empty + a.stages);
  float* qs = reinterpret_cast<float*>(smem + L.floats);  // sg x D
  float* sc = qs + sg * D;                                // sg x ps
  float* accw = sc + sg * ps;                             // 4 x sg x D
  float* m = accw + 4 * sg * D;                           // sg
  float* l = m + sg;                                      // sg
  float* corr = l + sg;                                   // sg
  float* lsum = corr + sg;                                // sg
  float* wts = lsum + sg;                                 // sg x splits
  float* lw = wts + sg * a.splits;                        // sg x splits
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&kfull[s], 32);
      mbar_init(&vfull[s], 32);
      mbar_init(&empty[s], kWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  auto next = [&]() {
    if (++stage == a.stages) {
      stage = 0;
      phase ^= 1;
    }
  };
  const uint32_t tile = (uint32_t)(ps * a.row_bytes);
  // the producer warp: a page's K and V tiles of head c (and their
  // scales) into the current stage; lane 0's expect-tx arrival and 31
  // plain ones complete each full barrier once the bytes land
  auto load_page = [&](int pid) {
    uint8_t* st = smem + stage * L.stage;
    float* kss = reinterpret_cast<float*>(st + 2 * L.tile);
    float* vss = kss + ps;
    mbar_wait(&empty[stage], phase ^ 1);
    if (kQuant) {
      for (int t = lane; t < ps; t += 32) {
        const long long tok = ((long long)pid * ps + t) * a.KV + c;
        if (STORE == kInt8) {
          kss[t] = static_cast<const float*>(a.k_scale)[tok];
          vss[t] = static_cast<const float*>(a.v_scale)[tok];
        } else {
          kss[t] = to_f32(static_cast<const __nv_bfloat16*>(a.k_scale)[tok]);
          vss[t] = to_f32(static_cast<const __nv_bfloat16*>(a.v_scale)[tok]);
        }
      }
    }
    if (lane == 0) {
      mbar_expect_tx(&kfull[stage], tile);
      tma_load3(st, &kmap, &kfull[stage], 0, c, pid * ps);
      mbar_expect_tx(&vfull[stage], tile);
      tma_load3(st + L.tile, &vmap, &vfull[stage], 0, c, pid * ps);
    } else {
      mbar_arrive(&kfull[stage]);
      mbar_arrive(&vfull[stage]);
    }
    next();
  };
  if (warp == kWarps && early) load_page(pid0);

  // pages past the deepest query position hold no valid position
  const long long last = (depth + a.S + ps - 1) / ps;
  const int n_live = (int)(last < a.P ? last : a.P);
  const int live_splits = max(1, (n_live + a.pps - 1) / a.pps);
  if (split >= live_splits) {
    if (warp == kWarps && early) {  // the early copy lands before the block's memory is freed
      mbar_wait(&kfull[0], 0);
      mbar_wait(&vfull[0], 0);
    }
    return;
  }
  const int p1 = min(p0 + a.pps, n_live);
  if (warp == kWarps) {
    for (int p = p0 + 1; p < p1; ++p) {
      const int pid = trow[p];
      if (pid >= 0 && pid < a.n_pages) load_page(pid);  // sentinels are skipped
    }
    return;
  }

  // the consumers: row r of the block is query r / grp of head c grp + r % grp
  for (int i = tid; i < sg * D; i += kConsumers) {
    const int r = i / D, j = i % D;
    const int s = r / grp, h = c * grp + r % grp;
    qs[i] = to_f32(static_cast<const TQ*>(a.q)[(((long long)b * a.S + s) * a.H + h) * D + j]);
  }
  for (int i = tid; i < 4 * sg * D; i += kConsumers) accw[i] = 0.f;
  for (int r = tid; r < sg; r += kConsumers) {
    m[r] = neg_inf();
    l[r] = 0.f;
  }
  named_sync(1, kConsumers);

  // scores: a lane per position; the warps split the page's 32-position
  // blocks and, where there are fewer than 8, the query rows
  const int segs = a.row_bytes / 16;
  const int pblocks = (ps + 31) / 32;
  const int rsplit = max(1, kWarps / pblocks);
  const int rows_per = (sg + rsplit - 1) / rsplit;
  for (int p = p0; p < p1; ++p) {
    const int pid = p == p0 ? pid0 : trow[p];
    if (pid < 0 || pid >= a.n_pages) continue;
    const uint8_t* kt = smem + stage * L.stage;
    const uint8_t* vt = kt + L.tile;
    const float* kss = reinterpret_cast<const float*>(kt + 2 * L.tile);
    const float* vss = kss + ps;
    const long long base = (long long)p * ps;
    mbar_wait(&kfull[stage], phase);
    for (int u = warp; u < pblocks * rsplit; u += kWarps) {
      const int t = (u % pblocks) * 32 + lane;
      const int r_lo = (u / pblocks) * rows_per, r_hi = min(sg, r_lo + rows_per);
      for (int r0 = r_lo; r0 < r_hi; r0 += 8) {
        // 8 query rows' dots over the row's 16-byte pieces, the pieces
        // taken in an order rotated by lane: the 8 lanes of a shared-memory
        // phase read 8 different 16-byte bank groups
        float dot[8];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) dot[rr] = 0.f;
        if (t < ps) {
          const uint8_t* krow = kt + t * a.row_bytes;
          const float ks = kQuant ? kss[t] : 1.f;
          int j = lane % segs;
#pragma unroll 4
          for (int c0 = 0; c0 < segs; ++c0, j = j + 1 == segs ? 0 : j + 1) {
            float kv[E];
            dequant_piece<STORE, kRoundKV>(*reinterpret_cast<const uint4*>(krow + 16 * j), ks,
                                           kv);
#pragma unroll
            for (int rr = 0; rr < 8; ++rr)
              if (r0 + rr < r_hi) dot[rr] += qdot<STORE>(qs + (r0 + rr) * D, j, D, kv);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const int r = r0 + rr;
          if (r < r_hi && t < ps)
            sc[r * ps + t] = base + t <= depth + r / grp ? dot[rr] * a.sm_scale : neg_inf();
        }
      }
    }
    named_sync(1, kConsumers);
    // the online softmax, a warp per query row
    for (int r = warp; r < sg; r += kWarps) {
      float* row = sc + r * ps;
      float mx = neg_inf();
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float shift = m_new == neg_inf() ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float e = expf(row[t] - shift);
        sum += e;
        row[t] = kRoundP ? round_bf16(e) : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float cr = expf(m_prev - shift);
        corr[r] = cr;
        l[r] = l[r] * cr + sum;
        m[r] = m_new;
      }
    }
    named_sync(1, kConsumers);
    // PV: warp w takes positions t = w % 4, w % 4 + 4, ... and every other
    // query row from w / 4, this lane 4 of D; its partial is (w % 4)'s.
    // Positions past depth + S - 1, which no query row of the call reads,
    // are left out of the loop: their p is 0, but their V may be a
    // recycled page's stale values, and 0 * NaN is NaN
    mbar_wait(&vfull[stage], phase);
    const long long live = depth + a.S - base;
    const int t_end = live < ps ? (int)live : ps;
    if (4 * lane < D) {
      const int pg = warp & 3;
      for (int r0 = warp >> 2; r0 < sg; r0 += 16) {  // rows r0, r0 + 2, ..., r0 + 14
        float acc[8][4];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rr][e] = 0.f;
#pragma unroll 2
        for (int t = pg; t < t_end; t += 4) {
          float v[4];
          dequant4<STORE, kRoundKV>(vt + t * a.row_bytes, lane, D, kQuant ? vss[t] : 1.f, v);
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) {
            if (r0 + 2 * rr < sg) {
              const float pr = sc[(r0 + 2 * rr) * ps + t];
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[rr][e] = fmaf(pr, v[e], acc[rr][e]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const int r = r0 + 2 * rr;
          if (r < sg) {
            float* dst = accw + (pg * sg + r) * D + 4 * lane;
            const float cr = corr[r];
#pragma unroll
            for (int e = 0; e < 4; ++e) dst[e] = dst[e] * cr + acc[rr][e];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    named_sync(1, kConsumers);  // sc and corr are rewritten by the next page
    next();
  }

  // this split's record: the four position groups' partials summed in order
  const long long rec = ((long long)(b * a.KV + c) * a.splits + split) * sg;
  for (int i = tid; i < sg * D; i += kConsumers) {
    const int r = i / D, j = i % D;
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += accw[(w * sg + r) * D + j];
    a.rec_acc[(rec + r) * D + j] = s;
  }
  for (int r = tid; r < sg; r += kConsumers) {
    a.rec_ml[(rec + r) * 2] = m[r];
    a.rec_ml[(rec + r) * 2 + 1] = l[r];
  }
  __threadfence();
  named_sync(1, kConsumers);
  if (tid == 0) {
    int* ticket = a.tickets + b * a.KV + c;
    const int prev = atomicAdd(ticket, 1);
    const int is_last = prev == live_splits - 1;
    if (is_last) *ticket = 0;
    *last_flag = is_last;
  }
  named_sync(1, kConsumers);
  if (!*last_flag) return;
  __threadfence();

  // the merge, in split order: M = max m_j, w_j = exp(m_j - M) (shift 0
  // where M is -inf), L = sum l_j w_j, A = sum acc_j w_j
  const long long rec0 = (long long)(b * a.KV + c) * a.splits * sg;
  for (int r = warp; r < sg; r += kWarps) {
    // each split's (m, l) in one 8-byte load, parked in wts / lw
    float mx = neg_inf();
    for (int j = lane; j < live_splits; j += 32) {
      const float2 ml =
          __ldcg(reinterpret_cast<const float2*>(a.rec_ml) + rec0 + (long long)j * sg + r);
      wts[r * a.splits + j] = ml.x;
      lw[r * a.splits + j] = ml.y;
      mx = fmaxf(mx, ml.x);
    }
    mx = warp_max(mx);
    const float shift = mx == neg_inf() ? 0.f : mx;
    for (int j = lane; j < live_splits; j += 32) {
      const float mj = wts[r * a.splits + j];
      const float w = mj == neg_inf() ? 0.f : expf(mj - shift);
      wts[r * a.splits + j] = w;
      lw[r * a.splits + j] = __fmul_rn(lw[r * a.splits + j], w);
    }
    __syncwarp();
    if (lane == 0) {
      float s = 0.f;
      for (int j = 0; j < live_splits; ++j) s = __fadd_rn(s, lw[r * a.splits + j]);
      lsum[r] = s;
    }
  }
  named_sync(1, kConsumers);
  // each thread takes 2 elements and 16 splits at a time: 32 independent
  // loads in flight (indices clamped, never skipped) before the ordered
  // sums; an empty record's weight is 0 and its acc 0, so it adds 0, as in
  // the plain version
  const int n_el = sg * D;
  for (int i0 = tid; i0 < n_el; i0 += 2 * kConsumers) {
    int row[2], off[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      off[e] = min(i0 + e * kConsumers, n_el - 1);  // (row, d) within a split's record
      row[e] = off[e] / D;
    }
    float acc[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < live_splits; j0 += 16) {
      float v[16][2];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const float* rj = a.rec_acc + (rec0 + (long long)min(j0 + u, live_splits - 1) * sg) * D;
#pragma unroll
        for (int e = 0; e < 2; ++e) v[u][e] = __ldcg(rj + off[e]);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (j0 + u < live_splits) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(v[u][e], wts[row[e] * a.splits + j0 + u]));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + e * kConsumers;
      if (i >= n_el) break;
      const int r = row[e], jd = i - r * D;
      const float lv = lsum[r];
      const int s = r / grp, h = c * grp + r % grp;
      store(static_cast<TQ*>(a.out) + (((long long)b * a.S + s) * a.H + h) * D + jd,
            acc[e] / (lv == 0.f ? 1.f : lv));
    }
  }
}

struct MapKey {
  const void* base;
  uint64_t dims[3], strides[2];
  uint32_t box2, type;
};

MapCache<MapKey>& map_cache() {
  static MapCache<MapKey> cache;
  return cache;
}

template <typename TQ, int STORE>
int launch(const void* k_pool, const void* v_pool, const Args& a, cudaStream_t stream) {
  const CUtensorMapDataType type = STORE == kF32    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : STORE == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int elem = STORE == kF32 ? 4 : STORE == kBF16 ? 2 : 1;
  const uint64_t d_store = a.row_bytes / elem;
  const uint64_t dims[3] = {d_store, (uint64_t)a.KV, (uint64_t)a.n_pages * a.ps};
  const uint64_t strides[2] = {(uint64_t)a.row_bytes, (uint64_t)a.row_bytes * a.KV};
  CUtensorMap maps[2];
  const void* pools[2] = {k_pool, v_pool};
  for (int i = 0; i < 2; ++i) {
    MapKey key{};
    key.base = pools[i];
    for (int j = 0; j < 3; ++j) key.dims[j] = dims[j];
    key.strides[0] = strides[0];
    key.strides[1] = strides[1];
    key.box2 = (uint32_t)a.ps;
    key.type = (uint32_t)type;
    const int e = map_cache().get(key, &maps[i], [&](CUtensorMap* mp) {
      return map3(mp, type, pools[i], dims, strides, (uint32_t)a.ps);
    });
    if (e != 0) return e;
  }
  const Layout L(a.stages, a.ps, a.row_bytes, a.S * (a.H / a.KV), a.D, a.splits);
  if (L.total > kMaxShared) return (int)cudaErrorInvalidValue;
  auto kernel = paged_sm90_kernel<TQ, STORE>;
  static bool sized = false;  // once per instance, to the card's limit: on every decode step
  if (!sized) {
    cudaError_t r =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    // ask for the whole carveout as shared memory, whatever kernel ran last
    if (r == cudaSuccess)
      r = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (r != cudaSuccess) return (int)r;
    sized = true;
  }
  kernel<<<dim3(a.B, a.KV, a.splits), kThreads, L.total, stream>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

template <typename TQ>
int dispatch_store(int store, const void* k_pool, const void* v_pool, const Args& a,
                   cudaStream_t stream) {
  switch (store) {
    case kF32: return launch<TQ, kF32>(k_pool, v_pool, a, stream);
    case kBF16: return launch<TQ, kBF16>(k_pool, v_pool, a, stream);
    case kInt8: return launch<TQ, kInt8>(k_pool, v_pool, a, stream);
    case kInt4: return launch<TQ, kInt4>(k_pool, v_pool, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// As paged_attention_launch (paged_attention.cu) for the pools, q, table,
// pos and out, plus: rec_ml (B, KV, splits, S * H / KV, 2) and rec_acc (B,
// KV, splits, S * H / KV, D) f32 scratch; tickets (B * KV) int32, all 0
// (each call leaves them 0); the logical pages cut into `splits` runs of
// pages_per_split; `stages` ring stages (1 or 2). Every stored row (D
// values, D / 2 bytes for int4) must be a multiple of 16 bytes and both
// pools 16-byte aligned. Returns the CUDA error of the launch (0 on
// success), or cudaErrorInvalidValue for operands it does not take.
extern "C" int paged_attention_sm90_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* pos, void* out, void* rec_ml,
    void* rec_acc, void* tickets, int B, int S, int H, int KV, int D, int page_size, int P,
    int n_pages, int q_code, int store, int pos64, float sm_scale, int pages_per_split,
    int splits, int stages, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV || D <= 0 || D > 128 || D % 4 || page_size <= 0 ||
      page_size > 256 || P < 0 || n_pages <= 0 || pages_per_split <= 0 || splits <= 0 ||
      (long long)splits * pages_per_split < P || stages < 1 || stages > 2)
    return (int)cudaErrorInvalidValue;
  const int elem = store == kF32 ? 4 : store == kBF16 ? 2 : 1;
  const int row_bytes = store == kInt4 ? D / 2 : D * elem;
  if (row_bytes % 16 || reinterpret_cast<uintptr_t>(k_pool) % 16 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.table = static_cast<const int*>(table);
  a.pos = pos;
  a.out = out;
  a.rec_ml = static_cast<float*>(rec_ml);
  a.rec_acc = static_cast<float*>(rec_acc);
  a.tickets = static_cast<int*>(tickets);
  a.pos64 = pos64;
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.ps = page_size;
  a.P = P;
  a.n_pages = n_pages;
  a.pps = pages_per_split;
  a.splits = splits;
  a.stages = stages;
  a.row_bytes = row_bytes;
  a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_code == 0) return dispatch_store<float>(store, k_pool, v_pool, a, st);
  if (q_code == 1) return dispatch_store<__nv_bfloat16>(store, k_pool, v_pool, a, st);
  return (int)cudaErrorInvalidValue;
}
