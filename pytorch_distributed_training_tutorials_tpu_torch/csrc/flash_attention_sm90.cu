// Causal flash attention for Hopper (sm_90a) in bf16: the forward, the dq
// and the dk/dv kernels. TMA loads of tiles into a ring of shared-memory
// stages, one producer thread, wgmma on two consumer warpgroups.
// ops/flash_attention.py routes a bf16 call here when every operand's base
// is 16-byte aligned and every B, S, H stride is a positive multiple of 16
// bytes (what a TMA map takes); every other call runs flash_attention.cu's
// mma.sync kernels (fwd_kernel, dq_kernel, dkv_kernel).
//
// Replaces, as flash_attention.cu's kernels do, the TPU kernels of
// pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py, and
// computes what they compute:
//   forward (fwd_sm90_kernel) <- _fwd_kernel (:50, pl.pallas_call at :265):
//   s   = (q . k^T) * scale in f32, masked causally, keys past S masked;
//   an online softmax over key tiles (running max m, sum l, f32
//   accumulator), the -inf shift guarded (a row that has seen only masked
//   keys shifts by 0);
//   p rounded to v's type (bf16) before p . v; l sums p unrounded;
//   O = acc / l in bf16 (l == 0 -> 1); lse = m + log(l) in f32, -inf for an
//   empty row, (B, H, S) contiguous: the backward kernels read it.
//   dq (dq_sm90_kernel) <- _dq_kernel (:113, pl.pallas_call at :367):
//   p = exp(s - lse) (lse -inf read as 0), dp = dO . v^T, ds = p (dp -
//   delta), all f32; dq = sum over key tiles of ds (rounded to bf16) . k,
//   times scale, in bf16.
//   dk, dv (dkv_sm90_kernel) <- _dkv_kernel (:157, pl.pallas_call at :394):
//   the same tiles transposed (rows keys, columns queries): dv = sum over
//   query tiles of p^T (rounded to bf16) . dO, dk = sum of ds^T (rounded to
//   bf16) . q, times scale, in bf16.
// No atomics and no carry between blocks: two calls are bitwise equal.
// delta = rowsum(dO * O) is computed outside, as in the JAX package.
//
// What bounds them on an H100: operations. At the 760m shape (B 2, S 2048,
// H 16, D 96) the forward's two causal products are 25.8 GFLOP, 0.026 ms at
// 989 TFLOP/s, against 0.008 ms of bytes; dq runs three (s, dp, ds . k) and
// dk/dv four (s^T, dp^T, p^T . dO, ds^T . q), 0.039 and 0.052 ms. So the
// design keeps the tensor cores fed and the operands off the registers
// until wgmma reads them:
//
// - A block owns 128 positions of one (batch, head): two consumer
//   warpgroups of 64 each, and a producer warpgroup of which one thread
//   issues every TMA load (setmaxnreg gives the consumers 232 registers,
//   the producer 40; ptxas would otherwise size all three warpgroups for
//   168). The forward and dq own 128 query rows and walk key tiles; dk/dv
//   owns 128 keys and walks query tiles. What the block owns (q; q and dO;
//   k and v) is loaded once; the tiles it walks go through a ring of two
//   stages with full and empty mbarriers.
// - Every product reads its operands as they lie in device memory
//   (positions x D, D contiguous), nothing staged transposed: a score
//   product (q . k^T, dO . v^T, k . q^T, v . dO^T) is wgmma with both
//   operands in shared memory, K-major, DP / 16 steps deep (6 at D 96); a
//   product along the sequence (p . v, ds . k, p^T . dO, ds^T . q) is wgmma
//   m64nDPk16 with A in registers, the score accumulator packed into bf16 A
//   fragments (that packing is p's or ds's rounding to bf16), and B read
//   from the same shared tile MN-major (the D columns along its 128-byte
//   rows).
// - Causal work: a forward or dq warpgroup walks key tiles up to its last
//   row only, a dk/dv warpgroup query tiles from its first key on (a tile
//   wholly on the far side of the diagonal is waited for and released
//   unread); only the tile that crosses the diagonal, or S, is masked. The
//   grid hands out the heaviest tiles first (the forward and dq query tile
//   gridDim.y - 1 - blockIdx.y, dk/dv key tile blockIdx.y; blockIdx.x the
//   (batch, head) and fastest).
// - The operands are (B, S, H, D) with any strides on B, S and H: each is
//   read through a rank-4 TMA map with dims (D, S, H, B) and the tensor's
//   own byte strides, in boxes of 64 head-dim columns x 64 (q, dO and the
//   backward's k and v) or 128 (the forward's k, v) positions, 128-byte
//   swizzle. TMA fills a box past S, and past D (at D 96 the second
//   64-column box is half outside), with zeros: they score 0, not -inf, so
//   the position < S and causal masks stay; the zero D columns add nothing
//   to a score and are never stored.
// - lse and delta (f32, (B, H, S)): dq reads its rows' once into
//   registers; dk/dv needs the 64 of every query tile it walks, which the
//   producer's warp loads into the ring stage beside the tile (lse already
//   guarded and in log2 units) and publishes on the tile's full barrier
//   (32 arrivals, one of them carrying the TMA bytes), so any S is taken.
// - DP, the padded head dim, is 64, 96 or 128 (one instance each): D any
//   multiple of 8 up to 128.
// - Forward: the row sums l stay per thread (each lane's share of its
//   row's 32 columns, all scaled by the same corrections) and meet across
//   the four lanes of a row once, at the end; the row max meets every tile,
//   since the shift must be the row's. exp is exp2 of the score in log2
//   units (one FFMA and one MUFU.EX2 per score), in the backward too.
// - One group of products in flight per warpgroup, then a wait: the other
//   warpgroup's products fill the tensor cores meanwhile. Tried on the H100
//   and not kept (forward): a third K/V stage (no gain); issuing the next
//   tile's q . k^T before this tile's p . v, to hide the softmax behind the
//   tensor cores (ptxas serialized the wgmmas, C7514, and it ran slower).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

struct Layout {  // element strides of the B, S, H axes
  long long sb, ss, sh;
};

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kRows = 128;             // positions a block owns: query rows (dk/dv: keys)
constexpr int kKeys = 128;             // keys of a K or V tile
constexpr int kThreads = 384;          // two consumer warpgroups + the producer's
constexpr int kBox = 64 * 128;         // 64 positions x 64 bf16 columns: 8 KB
constexpr int kKvBox = kKeys * 128;    // 128 keys x 64 bf16 columns: 16 KB
constexpr int kStages = 2;
constexpr int kConsumerRegs = 232;     // 2 x 128 x 232 + 128 x 40 = 64,512 registers
constexpr int kProducerRegs = 40;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Cfg {
  static constexpr int kBoxes = (DP + 63) / 64;  // 64-column boxes across the head dim
  static constexpr int kQ = 2 * kBoxes * kBox;  // both warpgroups' q
  static constexpr int kKv = kBoxes * kKvBox;    // one tile's k (or v)
  static constexpr int kStage = 2 * kKv;
  static constexpr int kSmem = 1024 + kQ + kStages * kStage + (1 + 3 * kStages) * 8;
};

struct Args {
  bf16* o;     // (B, S, H, D) with layout lo
  float* lse;  // (B, H, S) contiguous
  Layout lo;
  int B, S, H, D;
  float scale;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const Args a) {
  using C = Cfg<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* sq = smem;
  uint8_t* stages = smem + C::kQ;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(stages + kStages * C::kStage);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int n_tiles = (min(a.S, q0 + kRows) + kKeys - 1) / kKeys;
  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= 8) {
    // the producer: q once, then k and v tile by tile in the consumers' order
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    mbar_expect_tx(qfull, C::kQ);
    for (int w = 0; w < 2; ++w)
      for (int j = 0; j < C::kBoxes; ++j)
        tma_load4(sq + (w * C::kBoxes + j) * kBox, &qmap, qfull, 64 * j, q0 + 64 * w, h, b);
    Ring ring;
    for (int t = 0; t < n_tiles; ++t) {
      uint8_t* st = stages + ring.stage * C::kStage;
      mbar_wait(&empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&kfull[ring.stage], C::kKv);
      for (int j = 0; j < C::kBoxes; ++j)
        tma_load4(st + j * kKvBox, &kmap, &kfull[ring.stage], 64 * j, t * kKeys, h, b);
      mbar_expect_tx(&vfull[ring.stage], C::kKv);
      for (int j = 0; j < C::kBoxes; ++j)
        tma_load4(st + C::kKv + j * kKvBox, &vmap, &vfull[ring.stage], 64 * j, t * kKeys, h, b);
      ring.next<kStages>();
    }
    return;
  }
  // a consumer warpgroup: 64 query rows; this thread's rows r_lo, r_lo + 8
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const int row0 = q0 + 64 * wg;
  const int r_lo = row0 + 16 * wq + g;
  const float c = a.scale * kLog2e;  // scores to log2 units
  const uint32_t q_addr = smem_addr(sq) + wg * C::kBoxes * kBox;
  const uint32_t st_addr = smem_addr(stages);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  mbar_wait(qfull, 0);
  Ring ring;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    const uint32_t st = st_addr + ring.stage * C::kStage;
    // s = q . k^T: A (q) and B (k) K-major, DP / 16 steps
    float s[64];
    mbar_wait(&kfull[ring.stage], ring.phase);
    wgmma_fence();
    fence_operand(s);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma128<0, 0>(s, desc(q_addr + (kk >> 2) * kBox + 32 * (kk & 3), 16, 1024),
                     desc(st + (kk >> 2) * kKvBox + 32 * (kk & 3), 16, 1024), kk == 0 ? 0u : 1u);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);
    // s[4 j + e] is (row r_lo + 8 (e >> 1), key k0 + 8 j + 2 q + (e & 1));
    // only the tile that crosses this warpgroup's diagonal, or S, is masked
    if (k0 + kKeys > row0 + 1 || k0 + kKeys > a.S) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * q + (i & 1), qpos = r_lo + 8 * ((i >> 1) & 1);
        if (kpos > qpos || kpos >= a.S) s[i] = neg_inf();
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float shift[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row that has seen only masked keys keeps m = -inf: shift by 0,
      // not by -inf (exp(-inf - -inf) would be NaN)
      shift[r] = mx[r] == neg_inf() ? 0.f : mx[r] * c;
      corr[r] = exp2f(fmaf(m[r], c, -shift[r]));
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = exp2f(fmaf(s[i], c, -shift[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
    // p, rounded to bf16, as the A fragments of 16 keys each
    uint32_t p[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[kk][r] = bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    // o += p . v: A from registers, B (v) MN-major, 8 steps of 16 keys
    mbar_wait(&vfull[ring.stage], ring.phase);
    wgmma_fence();
    fence_operand(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) fence_operand(p[kk]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<DP>(o, p[kk], desc(st + C::kKv + 2048 * kk, kKvBox, 1024), 1u);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(o);
    if (lane == 0) mbar_arrive(&empty[ring.stage]);
    ring.next<kStages>();
  }
  bf16* oh = a.o + b * a.lo.sb + h * a.lo.sh;
  float* lse = a.lse + ((long long)b * a.H + h) * a.S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = r_lo + 8 * r;
    if (qpos >= a.S) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * q;
      if (d < a.D)
        *reinterpret_cast<uint32_t*>(oh + (long long)qpos * a.lo.ss + d) =
            bf16x2(o[4 * j + 2 * r] / safe_l, o[4 * j + 2 * r + 1] / safe_l);
    }
    if (q == 0) lse[qpos] = m[r] == neg_inf() ? neg_inf() : m[r] * a.scale + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// the backward: the block owns two operands of 128 positions (dq: q and dO;
// dk/dv: k and v) and walks 64-position tiles of the other two (dq: k and
// v; dk/dv: q and dO) through the ring

constexpr int kTile = 64;         // positions of a ring tile
constexpr int kBwdStages = 2;

template <int DP>
struct BwdCfg {
  static constexpr int kBoxes = (DP + 63) / 64;
  static constexpr int kTileBytes = kBoxes * kBox;  // 64 positions of one operand
  static constexpr int kOwn = 2 * kTileBytes;       // 128 positions of one operand
  static constexpr int kStage = 2 * kTileBytes;     // a ring tile of both walked operands
  // (dk/dv) each stage's lse and delta: 2 x 64 f32
  static constexpr int kRowBytes = kBwdStages * 2 * kTile * 4;
  static constexpr int kSmem =
      1024 + 2 * kOwn + kBwdStages * kStage + kRowBytes + (1 + 2 * kBwdStages) * 8;
};

struct BwdArgs {
  bf16* out0;          // dq, or dk
  bf16* out1;          // dv (dk/dv only)
  const float* lse;    // (B, H, S) contiguous
  const float* delta;  // (B, H, S) contiguous
  Layout l0, l1;       // of out0, out1
  int B, S, H, D;
  float scale;
};

// the shared-memory plan of both backward kernels
template <int DP>
struct BwdSmem {
  uint8_t* own0;   // q (dq) or k (dk/dv): [warpgroup][box] of 64 x 64
  uint8_t* own1;   // dO (dq) or v (dk/dv)
  uint8_t* ring;   // [stage]: k, v (dq) or q, dO (dk/dv) tiles, [box] of 64 x 64 each
  float* rows;     // [stage][lse | delta][64] (dk/dv)
  uint64_t* own;   // both own operands landed
  uint64_t* full;  // [stage]
  uint64_t* empty; // [stage]
  __device__ __forceinline__ explicit BwdSmem(uint8_t* smem) {
    using C = BwdCfg<DP>;
    own0 = smem;
    own1 = own0 + C::kOwn;
    ring = own1 + C::kOwn;
    rows = reinterpret_cast<float*>(ring + kBwdStages * C::kStage);
    own = reinterpret_cast<uint64_t*>(ring + kBwdStages * C::kStage + C::kRowBytes);
    full = own + 1;
    empty = full + kBwdStages;
  }
};

// d[64 x 64] = A . B^T over DP: A the warpgroup's 64 rows of an own
// operand (at shared address a), B a 64-position tile (at b), both K-major
// in 64-column boxes of kBox bytes
template <int DP>
__device__ __forceinline__ void score64(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma64<0, 0>(d, desc(a + (kk >> 2) * kBox + 32 * (kk & 3), 16, 1024),
                  desc(b + (kk >> 2) * kBox + 32 * (kk & 3), 16, 1024), kk == 0 ? 0u : 1u);
}

// acc[64 x DP] += A[64 x 64] . B[64 x DP]: A this thread's bf16 fragments
// of a score tile (16 positions each), B a 64-position tile read MN-major
template <int DP>
__device__ __forceinline__ void along64(float (&acc)[DP / 2], const uint32_t (&f)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(acc, f[kk], desc(b + 2048 * kk, kBox, 1024), 1u);
}

// a score tile (laid out as wgmma64's) rounded to bf16, as the A fragments
// of 16 positions each
__device__ __forceinline__ void pack64(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// this thread's rows r_lo and r_lo + 8 of one head of a (B, S, H, D)
// output, in bf16, from an f32 accumulator laid out as wgmma_rs<DP>'s,
// times mul; rows past S and columns past D are not stored
template <int DP>
__device__ __forceinline__ void store_rows(bf16* head, long long ss, const float (&acc)[DP / 2],
                                           int r_lo, int q, int S, int D, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = r_lo + 8 * r;
    if (pos >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * q;
      if (d < D)
        *reinterpret_cast<uint32_t*>(head + (long long)pos * ss + d) =
            bf16x2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// the producer's own-operand loads: 128 positions from p0 of two maps
template <int DP>
__device__ __forceinline__ void load_own(const BwdSmem<DP>& sm, const CUtensorMap* m0,
                                         const CUtensorMap* m1, int p0, int h, int b) {
  using C = BwdCfg<DP>;
  mbar_expect_tx(sm.own, 2 * C::kOwn);
  for (int w = 0; w < 2; ++w)
    for (int j = 0; j < C::kBoxes; ++j) {
      tma_load4(sm.own0 + (w * C::kBoxes + j) * kBox, m0, sm.own, 64 * j, p0 + 64 * w, h, b);
      tma_load4(sm.own1 + (w * C::kBoxes + j) * kBox, m1, sm.own, 64 * j, p0 + 64 * w, h, b);
    }
}

// the producer's ring tile: 64 positions from p0 of two maps into stage st
template <int DP>
__device__ __forceinline__ void load_tile(uint8_t* st, uint64_t* full, const CUtensorMap* m0,
                                          const CUtensorMap* m1, int p0, int h, int b) {
  using C = BwdCfg<DP>;
  for (int j = 0; j < C::kBoxes; ++j) {
    tma_load4(st + j * kBox, m0, full, 64 * j, p0, h, b);
    tma_load4(st + C::kTileBytes + j * kBox, m1, full, 64 * j, p0, h, b);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, const BwdArgs a) {
  using C = BwdCfg<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const BwdSmem<DP> sm(aligned_smem(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int n_tiles = (min(a.S, q0 + kRows) + kTile - 1) / kTile;
  if (tid == 0) {
    mbar_init(sm.own, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= 8) {
    // the producer: q and dO once, then k and v tile by tile
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    load_own<DP>(sm, &qmap, &domap, q0, h, b);
    Ring ring;
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&sm.full[ring.stage], C::kStage);
      load_tile<DP>(sm.ring + ring.stage * C::kStage, &sm.full[ring.stage], &kmap, &vmap,
                    t * kTile, h, b);
      ring.next<kBwdStages>();
    }
    return;
  }
  // a consumer warpgroup: 64 query rows; this thread's rows r_lo, r_lo + 8
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const int row0 = q0 + 64 * wg;
  const int r_lo = row0 + 16 * wq + g;
  // key tiles this warpgroup reads: up to its last row (none past S)
  const int n_mine = row0 >= a.S ? 0 : (min(a.S, row0 + 64) + kTile - 1) / kTile;
  const float c = a.scale * kLog2e;  // scores to log2 units
  const long long head = ((long long)b * a.H + h) * a.S;
  float lse2[2], dlt[2];  // lse in log2 units, guarded; delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r_lo + 8 * r;
    const float x = qpos < a.S ? a.lse[head + qpos] : 0.f;
    lse2[r] = x == neg_inf() ? 0.f : x * kLog2e;
    dlt[r] = qpos < a.S ? a.delta[head + qpos] : 0.f;
  }
  const uint32_t q_addr = smem_addr(sm.own0) + wg * C::kTileBytes;
  const uint32_t do_addr = smem_addr(sm.own1) + wg * C::kTileBytes;
  const uint32_t ring_addr = smem_addr(sm.ring);
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(sm.own, 0);
  Ring ring;
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(&sm.full[ring.stage], ring.phase);
    if (t < n_mine) {
      const int k0 = t * kTile;
      const uint32_t sk = ring_addr + ring.stage * C::kStage, sv = sk + C::kTileBytes;
      // s = q . k^T and dp = dO . v^T, one group
      float s[32], dp[32];
      wgmma_fence();
      fence_operand(s);
      fence_operand(dp);
      score64<DP>(s, q_addr, sk);
      score64<DP>(dp, do_addr, sv);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
      // s[i] is (row r_lo + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + 2 q + (i & 1));
      // only the tile that crosses this warpgroup's diagonal, or S, is masked
      const bool edge = k0 + kTile > row0 + 1 || k0 + kTile > a.S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int kpos = k0 + 8 * (i >> 2) + 2 * q + (i & 1), qpos = r_lo + 8 * r;
        float p = exp2f(fmaf(s[i], c, -lse2[r]));
        if (edge && (kpos > qpos || kpos >= a.S)) p = 0.f;
        s[i] = p * (dp[i] - dlt[r]);  // ds
      }
      uint32_t ds[4][4];
      pack64(ds, s);  // ds rounded to bf16
      // dq += ds . k, k read MN-major from the same tile
      wgmma_fence();
      fence_operand(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_operand(ds[kk]);
      along64<DP>(acc, ds, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
    }
    if (lane == 0) mbar_arrive(&sm.empty[ring.stage]);
    ring.next<kBwdStages>();
  }
  store_rows<DP>(a.out0 + b * a.l0.sb + h * a.l0.sh, a.l0.ss, acc, r_lo, q, a.S, a.D, a.scale);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, const BwdArgs a) {
  using C = BwdCfg<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const BwdSmem<DP> sm(aligned_smem(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int k0 = blockIdx.y * kRows;
  // query tiles from the block's first key to S
  const int n_tiles = (a.S - k0 + kTile - 1) / kTile;
  const long long head = ((long long)b * a.H + h) * a.S;
  if (tid == 0) {
    mbar_init(sm.own, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes, one carrying the TMA bytes
      mbar_init(&sm.empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= 8) {
    // the producer warp: k and v once, then tile by tile q, dO (one
    // thread's TMA) and their lse and delta (every lane's loads)
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 8) return;
    if (lane == 0) load_own<DP>(sm, &kmap, &vmap, k0, h, b);
    Ring ring;
    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = k0 + t * kTile;
      mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      float* rows = sm.rows + ring.stage * 2 * kTile;
      for (int j = lane; j < kTile; j += 32) {
        const int qpos = q0 + j;
        const float x = qpos < a.S ? a.lse[head + qpos] : 0.f;
        rows[j] = x == neg_inf() ? 0.f : x * kLog2e;
        rows[kTile + j] = qpos < a.S ? a.delta[head + qpos] : 0.f;
      }
      // the arrivals release the stores above to the consumers' wait
      if (lane == 0) {
        mbar_expect_tx(&sm.full[ring.stage], C::kStage);
        load_tile<DP>(sm.ring + ring.stage * C::kStage, &sm.full[ring.stage], &qmap, &domap,
                      q0, h, b);
      } else {
        mbar_arrive(&sm.full[ring.stage]);
      }
      ring.next<kBwdStages>();
    }
    return;
  }
  // a consumer warpgroup: 64 keys; this thread's keys kr_lo, kr_lo + 8
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  const int kr0 = k0 + 64 * wg;
  const int kr_lo = kr0 + 16 * wq + g;
  const float c = a.scale * kLog2e;
  const uint32_t k_addr = smem_addr(sm.own0) + wg * C::kTileBytes;
  const uint32_t v_addr = smem_addr(sm.own1) + wg * C::kTileBytes;
  const uint32_t ring_addr = smem_addr(sm.ring);
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(sm.own, 0);
  Ring ring;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = k0 + t * kTile;
    mbar_wait(&sm.full[ring.stage], ring.phase);
    // a tile wholly before this warpgroup's first key (or keys all past S)
    // adds nothing
    if (q0 + kTile > kr0 && kr0 < a.S) {
      const uint32_t sq = ring_addr + ring.stage * C::kStage, sdo = sq + C::kTileBytes;
      const float* lse2 = sm.rows + ring.stage * 2 * kTile;
      const float* dlt = lse2 + kTile;
      // s^T = k . q^T and dp^T = v . dO^T, one group
      float st[32], dpt[32];
      wgmma_fence();
      fence_operand(st);
      fence_operand(dpt);
      score64<DP>(st, k_addr, sq);
      score64<DP>(dpt, v_addr, sdo);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(st);
      fence_operand(dpt);
      // st[i] is (key kr_lo + 8 ((i >> 1) & 1), query q0 + col); only the
      // tile that crosses this warpgroup's diagonal, or S, is masked
      const bool edge = q0 < kr0 + 63 || q0 + kTile > a.S;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * q + (i & 1);
        const int kpos = kr_lo + 8 * ((i >> 1) & 1), qpos = q0 + col;
        float p = exp2f(fmaf(st[i], c, -lse2[col]));
        if (edge && (kpos > qpos || qpos >= a.S)) p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - dlt[col]);  // ds^T
      }
      uint32_t pf[4][4], df[4][4];
      pack64(pf, st);   // p^T rounded to bf16
      pack64(df, dpt);  // ds^T rounded to bf16
      // dv += p^T . dO and dk += ds^T . q, dO and q read MN-major
      wgmma_fence();
      fence_operand(dv);
      fence_operand(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_operand(pf[kk]);
        fence_operand(df[kk]);
      }
      along64<DP>(dv, pf, sdo);
      along64<DP>(dk, df, sq);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dv);
      fence_operand(dk);
    }
    if (lane == 0) mbar_arrive(&sm.empty[ring.stage]);
    ring.next<kBwdStages>();
  }
  store_rows<DP>(a.out0 + b * a.l0.sb + h * a.l0.sh, a.l0.ss, dk, kr_lo, q, a.S, a.D, a.scale);
  store_rows<DP>(a.out1 + b * a.l1.sb + h * a.l1.sh, a.l1.ss, dv, kr_lo, q, a.S, a.D, 1.f);
}

// the rank-4 map of one (B, S, H, D) operand, boxes of `rows` positions
int map_of(CUtensorMap* map, const void* p, const Layout& l, int B, int S, int H, int D,
           uint32_t rows) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long strides_el[3] = {l.sb, l.ss, l.sh};
  for (long long s : strides_el)
    if (s <= 0 || (2 * s) % 16 != 0) return (int)cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)S, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {2 * (uint64_t)l.ss, 2 * (uint64_t)l.sh, 2 * (uint64_t)l.sb};
  return bf16_map4(map, p, dims, strides, rows);
}

// 0 when the kernels take the type and shape
int check_shape(int B, int S, int H, int D, int dtype) {
  if (dtype != 1 || B <= 0 || S <= 0 || H <= 0 || D < 8 || D > 128 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H >= (1LL << 31) || (S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// one kernel on a (B * H, S / 128) grid of 384-thread blocks
template <typename Kernel, typename... Params>
int run(Kernel* fn, int smem, int B, int S, int H, cudaStream_t stream, const Params&... p) {
  const cudaError_t r = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (r != cudaSuccess) return (int)r;
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  fn<<<grid, kThreads, smem, stream>>>(p...);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_fwd(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const Args& a,
               cudaStream_t s) {
  return run(fwd_sm90_kernel<DP>, Cfg<DP>::kSmem, a.B, a.S, a.H, s, qm, km, vm, a);
}

template <int DP>
int launch_bwd(bool dkv, const CUtensorMap (&m)[4], const BwdArgs& a, cudaStream_t s) {
  return run(dkv ? dkv_sm90_kernel<DP> : dq_sm90_kernel<DP>, BwdCfg<DP>::kSmem, a.B, a.S, a.H,
             s, m[0], m[1], m[2], m[3], a);
}

// the maps of q, k, v and dO (boxes of 64 positions) and the launch of dq
// or dk/dv at the padded head dim
int backward(bool dkv, const void* const (&ptrs)[4], const Layout (&lays)[4], BwdArgs& a,
             void* stream) {
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i) {
    const int e = map_of(&m[i], ptrs[i], lays[i], a.B, a.S, a.H, a.D, kTile);
    if (e != 0) return e;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a.D <= 64) return launch_bwd<64>(dkv, m, a, s);
  if (a.D <= 96) return launch_bwd<96>(dkv, m, a, s);
  return launch_bwd<128>(dkv, m, a, s);
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a type, shape, pointer
// or stride it does not take), with the arguments of flash_attention.cu's
// entry point of the same name without _sm90. q, k, v, dout, o, dq, dk
// and dv are bf16 (dtype 1, flash_attention.cu's code) (B, S, H, D) with
// the given element strides (D contiguous), lse and delta (B, H, S) f32
// contiguous; D a multiple of 8 up to 128.

extern "C" int flash_fwd_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                     void* lse, Layout lq, Layout lk, Layout lv, Layout lo,
                                     int B, int S, int H, int D, int dtype, float scale,
                                     void* stream) {
  int e = check_shape(B, S, H, D, dtype);
  if (e != 0) return e;
  Args a{};
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.lo = lo;
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  CUtensorMap qm, km, vm;
  e = map_of(&qm, q, lq, B, S, H, D, 64);
  if (e == 0) e = map_of(&km, k, lk, B, S, H, D, kKeys);
  if (e == 0) e = map_of(&vm, v, lv, B, S, H, D, kKeys);
  if (e != 0) return e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_fwd<64>(qm, km, vm, a, s);
  if (D <= 96) return launch_fwd<96>(qm, km, vm, a, s);
  return launch_fwd<128>(qm, km, vm, a, s);
}

extern "C" int flash_dq_sm90_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dq, Layout lq,
                                    Layout lk, Layout lv, Layout ldo, Layout ldq, int B, int S,
                                    int H, int D, int dtype, float scale, void* stream) {
  const int e = check_shape(B, S, H, D, dtype);
  if (e != 0) return e;
  BwdArgs a{};
  a.out0 = static_cast<bf16*>(dq);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.l0 = ldq;
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  return backward(false, {q, k, v, dout}, {lq, lk, lv, ldo}, a, stream);
}

extern "C" int flash_dkv_sm90_launch(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, Layout lq, Layout lk, Layout lv,
                                     Layout ldo, Layout ldk, Layout ldv, int B, int S, int H,
                                     int D, int dtype, float scale, void* stream) {
  const int e = check_shape(B, S, H, D, dtype);
  if (e != 0) return e;
  BwdArgs a{};
  a.out0 = static_cast<bf16*>(dk);
  a.out1 = static_cast<bf16*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.l0 = ldk;
  a.l1 = ldv;
  a.B = B;
  a.S = S;
  a.H = H;
  a.D = D;
  a.scale = scale;
  return backward(true, {q, k, v, dout}, {lq, lk, lv, ldo}, a, stream);
}
