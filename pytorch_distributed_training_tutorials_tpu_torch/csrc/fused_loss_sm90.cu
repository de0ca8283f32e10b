// The fused cross entropy for Hopper (sm_90a) in bf16, its forward and its
// backward (dh and dW): TMA loads in a ring of shared-memory stages, one
// producer warp, wgmma on the consumer warpgroups. ops/fused_loss.py routes
// a bf16 call here when both operands are 16-byte aligned and D and V are
// multiples of 8 (what TMA needs); every other call runs fused_loss.cu's
// kernels.
//
// Replaces, as fused_loss.cu's fwd_kernel, dh_kernel and dw_kernel do, the
// TPU kernels of pytorch_distributed_training_tutorials_tpu/ops/fused_loss.py:
//   forward <- _fwd_kernel (:89, pl.pallas_call at :255)
//   dh      <- _dh_kernel  (:159, pl.pallas_call at :289)
//   dW      <- _dw_kernel  (:190, pl.pallas_call at :311)
// and computes what they compute:
//   s  = h . W in f32 from bf16 operands;
//   forward: columns at or past V score -inf; per row an online max and
//        sum (the -inf shift guarded) and the target logit, picked where
//        col == y and col < V (a target out of [0, V) hits nothing); one
//        (lse, target) f32 pair per row and vocab split, combined by the
//        wrapper;
//   dS = g * (exp(s - lse) - onehot(y)), lse the forward's (-inf guarded),
//        columns at or past V contribute nothing, a target out of [0, V)
//        hits nothing;
//   dh = sum over vocab of dS (rounded to bf16) . W^T, written in bf16;
//   dW = sum over rows of h^T . dS (rounded to bf16), written in bf16.
// Every sum is f32 and runs in a fixed order (no float atomics): two calls
// give bitwise the same result.
//
// What bounds it on an H100: operations, one pass of 2 N D V (forward) or
// two (dh, dW: the score product and the gradient product): 0.417 and 0.834
// ms per kernel at N 4096, D 1536, V 32768 at 989 TFLOP/s. So the design
// keeps the tensor cores fed:
//
// - wgmma m64n128k16 (bf16 in, f32 out) from shared memory, 64 rows per
//   consumer warpgroup; operands are read as they lie in device memory
//   (wgmma takes 16-bit operands K-major or MN-major), so nothing is staged
//   transposed: h is K-major for the score product and MN-major for dW's
//   h^T; W is MN-major for the score product and K-major for dh's W^T.
// - One producer thread issues TMA loads of 64 x 64 boxes (128-byte
//   swizzle, zeros past N, D and V) into a ring of stages with full and
//   empty mbarriers, so the next chunks are in flight while the tensor
//   cores work; a consumer issues a chunk's wgmmas, awaits them and
//   releases the stage (see consume() for why it does not leave them in
//   flight).
// - dS never leaves the chip: the consumers compute it from the score
//   accumulator in registers and write it in bf16 into a swizzled tile of
//   shared memory that the gradient wgmma reads. TMA fills W columns past
//   V with zeros, which score 0, not -inf: the col < V mask zeroes their
//   dS; rows past N carry g = 0.
// - forward: a block (two consumer warpgroups of 64 rows and the producer
//   warp, 288 threads) owns 128 rows and a vocab split, and walks the
//   split's 128-column score tiles. With no f32 partials to round-trip,
//   128 rows a block halve the L2 re-reads of W against dh's 64: each 128
//   x 128 score tile reads (128 + 128) x D x 2 bytes for 2 x 128 x 128 x D
//   FLOPs, 64 FLOP per byte (43 at 64 rows). Each thread keeps its own
//   running max, sum and target over its 32 columns of each of its two
//   rows in registers (no shuffles per tile); the four lanes of a row meet
//   once, at the end. The splits fill the card at one block per SM (six
//   32 KB stages): splits = SMs / row tiles, rounded down, so 4096 rows
//   give 32 x 4 = 128 blocks on 132 SMs, one wave (ops/fused_loss.py
//   _fwd_plan).
// - dh: a block (one consumer warpgroup and the producer warp, 160
//   threads, 255 registers each) owns 64 rows and a vocab split. Per group
//   of 8 score tiles (1024 vocab columns) it keeps dS (64 x 1024 bf16, 128
//   KB) and then adds dS . W[d, group]^T to its f32 partial in device
//   memory in 128-column passes over D (a fresh accumulator for the first
//   group; each pass loads the next pass's partial while its wgmmas run).
//   The splits fill the card at one block per SM (224 KB of shared memory
//   each): splits = SMs / row tiles, rounded down, so 4096 rows give 64 x
//   2 = 128 blocks on 132 SMs, one wave; the wrapper sums the splits' f32
//   partials (2 x 25.2 MB at the main shape, against 5 x 25.2 MB for
//   fused_loss.cu). Tried and slower on the H100: two consumer
//   warpgroups over 128 rows with 512-column groups (39% fewer bytes from
//   L2, twice the f32 partial traffic).
// - dW: a block (two consumer warpgroups and a producer warpgroup, 384
//   threads; setmaxnreg gives the consumers 232 registers, the producer
//   40, where ptxas would otherwise size all three for 168 and spill) owns
//   128 vocab columns and all rows. Per group of 4 score tiles of 128 rows
//   (512 rows) it keeps dS (512 x 128 bf16, 128 KB) and then adds
//   h[group]^T . dS to its f32 partial columns in passes of 128 hidden
//   units (64 per warpgroup); the last group writes dW in bf16. V / 128 =
//   256 blocks at the main shape: two waves on 132 SMs, the second 124
//   blocks full (97% of two full waves; a persistent grid over equal tiles
//   could not do better).
//
// Bytes at the main shape, beyond reading h (12.6 MB) and W (100.7 MB) once
// and writing the output once: dh's f32 partials move one read and one
// write of 64 x 1536 x 4 B per block and 1024-column group, 32 groups per
// row tile: 805 MB each way (fused_loss.cu's 512-column groups at 5 splits
// moved twice that); dW's one read and one write of its 1536 x 128 x 4 B
// columns per 512-row group after the first: 7 x 201 MB = 1.41 GB each
// way. From L2, the score tiles re-read W once per 64-row block and h once
// per 128-column tile (dh: 9.4 GB, its gradient product another 6.3 GB;
// dW: 6.4 GB and 3.2 GB).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTile = 64 * 64 * 2;  // one 64 x 64 bf16 box, 8 KB
constexpr int kBV = 128;            // vocab columns of a score tile
constexpr int kKC = 64;             // depth of a loaded chunk

// forward
constexpr int kFwdStages = 6;
constexpr int kFwdStage = 4 * kTile;        // two h boxes (one per warpgroup) + two W boxes
constexpr int kFwdThreads = 288;            // two consumer warpgroups + the producer warp
// dh
constexpr int kDhGroup = 8;                 // score tiles whose dS stays on chip (1024 columns)
constexpr int kDhStages = 4;
constexpr int kDhStage = 3 * kTile;         // h box + two W boxes (score); two W boxes (gradient)
constexpr int kDhDs = 2 * kDhGroup * kTile; // 64 x 1024 bf16
constexpr int kDhThreads = 160;             // one consumer warpgroup + the producer warp
// dW
constexpr int kDwGroup = 4;                 // score tiles of 128 rows (512 rows)
constexpr int kDwStages = 3;
constexpr int kDwStage = 4 * kTile;         // two h boxes + two W boxes (score); two h boxes
constexpr int kDwHalf = kDwGroup * 128 * 128;  // one 64-column half of dS: 512 rows x 128 B
constexpr int kDwDs = 2 * kDwHalf;
constexpr int kDwThreads = 384;             // two consumer warpgroups + the producer's

// registers a thread: 2 x 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

template <int kStages, int kStage, int kDs>
constexpr int smem_bytes() {
  return 1024 + kStages * kStage + kDs + 2 * kStages * 8;
}

struct Args {
  const long long* y;  // (N,) targets
  const float* lse;    // (N,) saved by the forward
  const float* g;      // (N,) the loss's cotangent
  float* part;         // forward: (splits, N) lse; dh: (splits, N, D) f32; dW: (D, V)
                       // f32 between row groups
  float* tgt;          // forward: (splits, N) target logits
  bf16* out;           // dW (D, V), written by the last row group
  int N, D, V;
  int groups_per_split;  // forward: 128-column tiles, dh: 1024-column groups per split
};

// what dS needs of one of this thread's two rows (16 (warp % 4) + lane / 4
// + 8 h of its warpgroup's 64): rows past N get no target and g = 0
struct Row {
  long long y;
  float lse, g;
};

__device__ __forceinline__ Row load_row(const Args& a, int row) {
  Row r{-1, 0.f, 0.f};
  if (row < a.N) {
    const float x = a.lse[row];
    r.y = a.y[row];
    r.lse = x == neg_inf() ? 0.f : x;  // the forward's -inf guard
    r.g = a.g[row];
  }
  return r;
}

__device__ __forceinline__ float dlogit(float s, int col, const Row& r, int V) {
  const float p = col < V ? expf(s - r.lse) : 0.f;
  const float hit = (col < V && col == r.y) ? 1.f : 0.f;
  return (p - hit) * r.g;
}

// this thread's part of a 64 x 128 f32 tile (the accumulator layout of
// wgmma128) of a row-major matrix with rows of ld: rows r0 + 16 wq + g +
// 8 h, columns c0 + 8 jj + 2 q (+ 1), zeros at rows >= nr or columns >= nc
__device__ __forceinline__ void load_tile(float (&x)[64], const float* p, long long ld, int r0,
                                          int c0, int nr, int nc, int wq, int g, int q) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * wq + g + 8 * h, c = c0 + 8 * jj + 2 * q;
      float2 v = make_float2(0.f, 0.f);
      if (r < nr && c < nc) v = *reinterpret_cast<const float2*>(p + r * ld + c);
      x[4 * jj + 2 * h] = v.x;
      x[4 * jj + 2 * h + 1] = v.y;
    }
}

// a consumer's pass over `chunks` stages of the ring: per stage, the
// wgmmas of chunk c issued (issue(acc, stage address, c, keep): keep 0 for
// the first wgmma of a fresh accumulator, which then ignores what acc
// holds, so no instruction but a wgmma writes it), awaited, and the stage
// released (one arrival per consumer warp). Leaving one chunk's wgmmas in
// flight across the loop instead makes ptxas serialize them (C7515) and
// ran slower on the H100; so did awaiting two or three chunks at a time.
template <int kStages, int kStageBytes, typename Issue>
__device__ __forceinline__ void consume(float (&acc)[64], Ring& ring, uint64_t* full,
                                        uint64_t* empty, uint32_t stages, int chunks,
                                        int lane, bool fresh, Issue issue) {
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(&full[ring.stage], ring.phase);
    wgmma_fence();
    fence_operand(acc);
    issue(acc, stages + ring.stage * kStageBytes, c, fresh && c == 0 ? 0u : 1u);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[ring.stage]);
    ring.next<kStages>();
  }
}

// ---------------------------------------------------------------------------
// forward

__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kFwdStages * kFwdStage);
  uint64_t* empty = full + kFwdStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * 128, split = blockIdx.y;
  const int n_vt = (a.V + kBV - 1) / kBV;
  const int vt0 = split * a.groups_per_split, vt1 = min(n_vt, vt0 + a.groups_per_split);
  const int chunks = (a.D + kKC - 1) / kKC;
  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  Ring ring;
  if (warp == 8) {
    // the producer: per score tile and 64-deep chunk, both warpgroups' h
    // boxes and the tile's two W boxes
    if (lane != 0) return;
    for (int vt = vt0; vt < vt1; ++vt) {
      const int c0 = vt * kBV;
      for (int k0 = 0; k0 < a.D; k0 += kKC) {
        uint8_t* st = smem + ring.stage * kFwdStage;
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);
        mbar_expect_tx(&full[ring.stage], 4 * kTile);
        tma_load(st, &hmap, &full[ring.stage], k0, r0);
        tma_load(st + kTile, &hmap, &full[ring.stage], k0, r0 + 64);
        tma_load(st + 2 * kTile, &wmap, &full[ring.stage], c0, k0);
        tma_load(st + 3 * kTile, &wmap, &full[ring.stage], c0 + 64, k0);
        ring.next<kFwdStages>();
      }
    }
    return;
  }
  // two consumer warpgroups: wg takes rows 64 wg .. 64 wg + 63 of the block;
  // this thread's rows r0 + 64 wg + 16 wq + g + 8 hh, its columns of a tile
  // c0 + 8 jj + 2 q + e
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const uint32_t stages = smem_addr(smem);
  int y[2];
  float m[2], l[2], tg[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 64 * wg + 16 * wq + g + 8 * hh;
    const long long t = row < a.N ? a.y[row] : -1;
    y[hh] = (t >= 0 && t < a.V) ? (int)t : -1;  // out of [0, V): hits nothing
    m[hh] = neg_inf();
    l[hh] = tg[hh] = 0.f;
  }
  float acc[64];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int c0 = vt * kBV;
    // s = h[64 rows, :] . W[:, c0 .. c0 + 128): A K-major, B MN-major
    consume<kFwdStages, kFwdStage>(acc, ring, full, empty, stages, chunks, lane, true,
                                   [wg](float(&d)[64], uint32_t st, int, uint32_t keep) {
#pragma unroll
                                     for (int kk = 0; kk < 4; ++kk)
                                       wgmma128<0, 1>(d, desc(st + wg * kTile + 32 * kk, 16, 1024),
                                                      desc(st + 2 * kTile + 2048 * kk, kTile, 1024),
                                                      kk == 0 ? keep : 1u);
                                   });
    // TMA's zero columns past V score 0: mask them to -inf
    const bool tail = c0 + kBV > a.V;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * hh + e, col = c0 + 8 * jj + 2 * q + e;
          if (tail && col >= a.V) acc[i] = neg_inf();
          if (col == y[hh]) tg[hh] += acc[i];
          mx = fmaxf(mx, acc[i]);
        }
      // a row that has seen only masked columns keeps m = -inf: shift by 0
      const float shift = mx == neg_inf() ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += expf(acc[4 * jj + 2 * hh + e] - shift);
      l[hh] = l[hh] * expf(m[hh] - shift) + sum;
      m[hh] = mx;
    }
  }
  // the four lanes of each row meet: max, rescaled sums, the one target
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mm = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, 2));
    const float shift = mm == neg_inf() ? 0.f : mm;
    float ll = l[hh] * expf(m[hh] - shift);
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    float tt = tg[hh] + __shfl_xor_sync(0xffffffffu, tg[hh], 1);
    tt += __shfl_xor_sync(0xffffffffu, tt, 2);
    const int row = r0 + 64 * wg + 16 * wq + g + 8 * hh;
    if (q == 0 && row < a.N) {
      const float safe_l = ll == 0.f ? 1.f : ll;
      a.part[(long long)split * a.N + row] =
          mm == neg_inf() ? mm : mm + logf(safe_l);
      a.tgt[(long long)split * a.N + row] = tt;
    }
  }
}

// ---------------------------------------------------------------------------
// dh

__global__ void __launch_bounds__(kDhThreads, 1)
    dh_sm90_kernel(const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* ds = smem + kDhStages * kDhStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(ds + kDhDs);
  uint64_t* empty = full + kDhStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * 64, split = blockIdx.y;
  const int n_vt = (a.V + kBV - 1) / kBV, n_groups = (n_vt + kDhGroup - 1) / kDhGroup;
  const int gr0 = split * a.groups_per_split;
  const int gr1 = min(n_groups, gr0 + a.groups_per_split);
  if (tid == 0) {
    for (int s = 0; s < kDhStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  Ring ring;
  if (warp == 4) {
    // the producer: the consumer's order of chunks, exactly
    if (lane != 0) return;
    for (int gr = gr0; gr < gr1; ++gr) {
      const int vt0 = gr * kDhGroup, nt = min(kDhGroup, n_vt - vt0);
      for (int j = 0; j < nt; ++j) {
        const int c0 = (vt0 + j) * kBV;
        for (int k0 = 0; k0 < a.D; k0 += kKC) {
          uint8_t* st = smem + ring.stage * kDhStage;
          mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&full[ring.stage], 3 * kTile);
          tma_load(st, &hmap, &full[ring.stage], k0, r0);
          tma_load(st + kTile, &wmap, &full[ring.stage], c0, k0);
          tma_load(st + 2 * kTile, &wmap, &full[ring.stage], c0 + 64, k0);
          ring.next<kDhStages>();
        }
      }
      for (int d0 = 0; d0 < a.D; d0 += 128) {
        for (int v = vt0 * kBV; v < (vt0 + nt) * kBV; v += kKC) {
          uint8_t* st = smem + ring.stage * kDhStage;
          mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&full[ring.stage], 2 * kTile);
          tma_load(st, &wmap, &full[ring.stage], v, d0);
          tma_load(st + kTile, &wmap, &full[ring.stage], v, d0 + 64);
          ring.next<kDhStages>();
        }
      }
    }
    return;
  }
  // the consumer warpgroup: 64 rows
  const int g = lane >> 2, q = lane & 3;
  Row rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rows[h] = load_row(a, r0 + 16 * warp + g + 8 * h);
  const uint32_t stages = smem_addr(smem), ds_addr = smem_addr(ds);
  float* part = a.part + (long long)split * a.N * a.D;
  float acc[64], next[64];
  for (int gr = gr0; gr < gr1; ++gr) {
    const int vt0 = gr * kDhGroup, nt = min(kDhGroup, n_vt - vt0);
    named_sync(1, 128);  // the last group's gradient wgmmas are done reading dS
    for (int j = 0; j < nt; ++j) {
      const int c0 = (vt0 + j) * kBV;
      // s = h[64 rows, :] . W[:, c0 .. c0 + 128): A K-major, B MN-major
      consume<kDhStages, kDhStage>(acc, ring, full, empty, stages, (a.D + kKC - 1) / kKC, lane,
                         true, [](float(&d)[64], uint32_t st, int, uint32_t keep) {
#pragma unroll
                           for (int kk = 0; kk < 4; ++kk)
                             wgmma128<0, 1>(d, desc(st + 32 * kk, 16, 1024),
                                            desc(st + kTile + 2048 * kk, kTile, 1024),
                                            kk == 0 ? keep : 1u);
                         });
      // dS, rounded to bf16, into the group's tile (64 rows x 1024 columns)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = 16 * warp + g + 8 * h, cl = 8 * jj + 2 * q;
          const float d0 = dlogit(acc[4 * jj + 2 * h], c0 + cl, rows[h], a.V);
          const float d1 = dlogit(acc[4 * jj + 2 * h + 1], c0 + cl + 1, rows[h], a.V);
          *reinterpret_cast<uint32_t*>(ds + (2 * j + (jj >> 3)) * kTile +
                                       swz128(rl, cl & 63)) = bf16x2(d0, d1);
        }
    }
    fence_async_smem();
    named_sync(1, 128);
    // dh[64 rows, d0 .. d0 + 128) += dS . W[d0 .. d0 + 128, group]^T: A and
    // B K-major (W's vocab runs along its rows). The next pass's partial
    // loads while this pass's wgmmas run; the first group starts fresh.
    const bool first = gr == gr0;
    if (!first) load_tile(next, part, a.D, r0, 0, a.N, a.D, warp, g, q);
    for (int d0 = 0; d0 < a.D; d0 += 128) {
      if (!first) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = next[i];
        if (d0 + 128 < a.D) load_tile(next, part, a.D, r0, d0 + 128, a.N, a.D, warp, g, q);
      }
      consume<kDhStages, kDhStage>(acc, ring, full, empty, stages, 2 * nt, lane, first,
                         [ds_addr](float(&d)[64], uint32_t st, int c, uint32_t keep) {
#pragma unroll
                           for (int kk = 0; kk < 4; ++kk)
                             wgmma128<0, 0>(d, desc(ds_addr + c * kTile + 32 * kk, 16, 1024),
                                            desc(st + 32 * kk, 16, 1024), kk == 0 ? keep : 1u);
                         });
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 16 * warp + g + 8 * h, col = d0 + 8 * jj + 2 * q;
          if (row < a.N && col < a.D)
            *reinterpret_cast<float2*>(part + (long long)row * a.D + col) =
                make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// dW

__global__ void __launch_bounds__(kDwThreads, 1)
    dw_sm90_kernel(const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* ds = smem + kDwStages * kDwStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(ds + kDwDs);
  uint64_t* empty = full + kDwStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * kBV;
  constexpr int kRowsPerGroup = kDwGroup * 128;
  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  Ring ring;
  if (warp >= 8) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    for (int rg = 0; rg < a.N; rg += kRowsPerGroup) {
      const int nt = min(kDwGroup, (a.N - rg + 127) / 128);
      for (int j = 0; j < nt; ++j) {
        const int r0 = rg + 128 * j;
        for (int k0 = 0; k0 < a.D; k0 += kKC) {
          uint8_t* st = smem + ring.stage * kDwStage;
          mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&full[ring.stage], 4 * kTile);
          tma_load(st, &hmap, &full[ring.stage], k0, r0);
          tma_load(st + kTile, &hmap, &full[ring.stage], k0, r0 + 64);
          tma_load(st + 2 * kTile, &wmap, &full[ring.stage], c0, k0);
          tma_load(st + 3 * kTile, &wmap, &full[ring.stage], c0 + 64, k0);
          ring.next<kDwStages>();
        }
      }
      for (int d0 = 0; d0 < a.D; d0 += 128) {
        for (int r = rg; r < rg + 128 * nt; r += kKC) {
          uint8_t* st = smem + ring.stage * kDwStage;
          mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          mbar_expect_tx(&full[ring.stage], 2 * kTile);
          tma_load(st, &hmap, &full[ring.stage], d0, r);
          tma_load(st + kTile, &hmap, &full[ring.stage], d0 + 64, r);
          ring.next<kDwStages>();
        }
      }
    }
    return;
  }
  // two consumer warpgroups: wg takes rows 64 wg .. of each 128-row score
  // tile and hidden units 64 wg .. of each 128-unit gradient pass
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const uint32_t stages = smem_addr(smem), ds_addr = smem_addr(ds);
  float acc[64], next[64];
  for (int rg = 0; rg < a.N; rg += kRowsPerGroup) {
    const int nt = min(kDwGroup, (a.N - rg + 127) / 128);
    const bool first = rg == 0, last = rg + kRowsPerGroup >= a.N;
    named_sync(1, 256);  // both warpgroups are done reading the last group's dS
    for (int j = 0; j < nt; ++j) {
      const int r0 = rg + 128 * j;
      Row rows[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rows[h] = load_row(a, r0 + 64 * wg + 16 * wq + g + 8 * h);
      // s = h[64 rows, :] . W[:, c0 .. c0 + 128): A K-major, B MN-major
      consume<kDwStages, kDwStage>(acc, ring, full, empty, stages, (a.D + kKC - 1) / kKC, lane,
                         true, [wg](float(&d)[64], uint32_t st, int, uint32_t keep) {
#pragma unroll
                           for (int kk = 0; kk < 4; ++kk)
                             wgmma128<0, 1>(d, desc(st + wg * kTile + 32 * kk, 16, 1024),
                                            desc(st + 2 * kTile + 2048 * kk, kTile, 1024),
                                            kk == 0 ? keep : 1u);
                         });
      // dS, rounded to bf16, into the group's tile: rows along the 128-byte
      // rows' stride, the 128 columns as two 64-column halves
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = 128 * j + 64 * wg + 16 * wq + g + 8 * h, cl = 8 * jj + 2 * q;
          const float d0 = dlogit(acc[4 * jj + 2 * h], c0 + cl, rows[h], a.V);
          const float d1 = dlogit(acc[4 * jj + 2 * h + 1], c0 + cl + 1, rows[h], a.V);
          *reinterpret_cast<uint32_t*>(ds + (jj >> 3) * kDwHalf + swz128(rl, cl & 63)) =
              bf16x2(d0, d1);
        }
    }
    fence_async_smem();
    named_sync(1, 256);
    // dW[d0 + 64 wg .. + 64, c0 .. c0 + 128) += h[group, those units]^T .
    // dS: A and B MN-major (both run along the group's rows)
    // the next pass's partial loads while this pass's wgmmas run; the first
    // group starts fresh
    if (!first) load_tile(next, a.part, a.V, 64 * wg, c0, a.D, a.V, wq, g, q);
    for (int d0 = 0; d0 < a.D; d0 += 128) {
      const int dm = d0 + 64 * wg;
      if (!first) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = next[i];
        if (d0 + 128 < a.D) load_tile(next, a.part, a.V, dm + 128, c0, a.D, a.V, wq, g, q);
      }
      consume<kDwStages, kDwStage>(acc, ring, full, empty, stages, 2 * nt, lane, first,
                         [wg, ds_addr](float(&d)[64], uint32_t st, int c, uint32_t keep) {
#pragma unroll
                           for (int kk = 0; kk < 4; ++kk)
                             wgmma128<1, 1>(
                                 d, desc(st + wg * kTile + 2048 * kk, kTile, 1024),
                                 desc(ds_addr + (64 * c + 16 * kk) * 128, kDwHalf, 1024),
                                 kk == 0 ? keep : 1u);
                         });
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = dm + 16 * wq + g + 8 * h, v = c0 + 8 * jj + 2 * q;
          if (d >= a.D || v >= a.V) continue;
          const long long at = (long long)d * a.V + v;
          if (last)
            *reinterpret_cast<uint32_t*>(a.out + at) =
                bf16x2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
          else
            *reinterpret_cast<float2*>(a.part + at) =
                make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// launch

int check(const void* h, const void* w, int N, int D, int V) {
  if (N <= 0 || D <= 0 || V <= 0 || D % 8 != 0 || V % 8 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(h) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem, const void* h, const void* w,
           const Args& a, void* stream) {
  CUtensorMap hmap, wmap;
  int e = bf16_map(&hmap, h, a.N, a.D, 64);
  if (e == 0) e = bf16_map(&wmap, w, a.D, a.V, 64);
  if (e != 0) return e;
  cudaError_t r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (r != cudaSuccess) return (int)r;
  kernel<<<grid, threads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(hmap, wmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for operands it does not
// take). h is (N, D) and w (D, V), both contiguous bf16 with 16-byte
// aligned bases and D, V multiples of 8; y is (N,) int64; lse and g are
// (N,) f32. Forward: part_lse and part_tgt are (nsplit, N) f32, the vocab
// cut into nsplit splits of tiles_per_split 128-column tiles
// (ops/fused_loss.py _fwd_plan). dh: part is (nsplit, N, D) f32, the vocab
// cut into nsplit splits of groups_per_split 1024-column groups (_dh_plan).
// dW: part is (D, V) f32 (unused when N <= 512), out (D, V) bf16.

extern "C" int fused_ce_fwd_sm90_launch(const void* h, const void* w, const void* y,
                                        void* part_lse, void* part_tgt, int N, int D, int V,
                                        int nsplit, int tiles_per_split, void* stream) {
  const int e = check(h, w, N, D, V);
  if (e != 0) return e;
  if (nsplit <= 0 || nsplit > 65535 || tiles_per_split <= 0 ||
      (long long)nsplit * tiles_per_split < (V + kBV - 1) / kBV)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.y = static_cast<const long long*>(y);
  a.part = static_cast<float*>(part_lse);
  a.tgt = static_cast<float*>(part_tgt);
  a.N = N;
  a.D = D;
  a.V = V;
  a.groups_per_split = tiles_per_split;
  return launch(fwd_sm90_kernel, dim3((N + 127) / 128, nsplit), kFwdThreads,
                smem_bytes<kFwdStages, kFwdStage, 0>(), h, w, a, stream);
}

extern "C" int fused_ce_dh_sm90_launch(const void* h, const void* w, const void* y,
                                       const void* lse, const void* g, void* part, int N, int D,
                                       int V, int nsplit, int groups_per_split, void* stream) {
  const int e = check(h, w, N, D, V);
  if (e != 0) return e;
  const int n_groups = ((V + kBV - 1) / kBV + kDhGroup - 1) / kDhGroup;
  if (nsplit <= 0 || nsplit > 65535 || groups_per_split <= 0 ||
      (long long)nsplit * groups_per_split < n_groups)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.y = static_cast<const long long*>(y);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  a.N = N;
  a.D = D;
  a.V = V;
  a.groups_per_split = groups_per_split;
  return launch(dh_sm90_kernel, dim3((N + 63) / 64, nsplit), kDhThreads,
                smem_bytes<kDhStages, kDhStage, kDhDs>(), h, w, a, stream);
}

extern "C" int fused_ce_dw_sm90_launch(const void* h, const void* w, const void* y,
                                       const void* lse, const void* g, void* part, void* out,
                                       int N, int D, int V, void* stream) {
  const int e = check(h, w, N, D, V);
  if (e != 0) return e;
  Args a{};
  a.y = static_cast<const long long*>(y);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.part = static_cast<float*>(part);
  a.out = static_cast<bf16*>(out);
  a.N = N;
  a.D = D;
  a.V = V;
  return launch(dw_sm90_kernel, dim3((V + kBV - 1) / kBV), kDwThreads,
                smem_bytes<kDwStages, kDwStage, kDwDs>(), h, w, a, stream);
}
