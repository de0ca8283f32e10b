// The causal flash-attention forward for Hopper (sm_90a) in bf16: TMA loads
// of K and V tiles in a ring of shared-memory stages, one producer thread,
// wgmma on two consumer warpgroups. ops/flash_attention.py routes a bf16
// call here when every operand's base is 16-byte aligned and every B, S, H
// stride is a positive multiple of 16 bytes (what a TMA map takes); every
// other call runs flash_attention.cu's fwd_kernel.
//
// Replaces, as flash_attention.cu's fwd_kernel does, the TPU kernel
// pytorch_distributed_training_tutorials_tpu/ops/flash_attention.py
// _fwd_kernel (:50, pl.pallas_call at :265), and computes what it computes:
//   s   = (q . k^T) * scale in f32, masked causally, keys past S masked;
//   an online softmax over key tiles (running max m, sum l, f32
//   accumulator), the -inf shift guarded (a row that has seen only masked
//   keys shifts by 0);
//   p rounded to v's type (bf16) before p . v; l sums p unrounded;
//   O = acc / l in bf16 (l == 0 -> 1); lse = m + log(l) in f32, -inf for an
//   empty row, (B, H, S) contiguous: the backward kernels read it.
// No atomics and no carry between blocks: two calls are bitwise equal.
//
// What bounds it on an H100: operations. At the 760m shape (B 2, S 2048, H
// 16, D 96) the two causal products are 25.8 GFLOP, 0.026 ms at 989
// TFLOP/s, against 0.008 ms of bytes. So the design keeps the tensor cores
// fed and the operands off the registers until wgmma reads them:
//
// - A block owns 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each, and a producer warpgroup of which one
//   thread issues every TMA load (setmaxnreg gives the consumers 232
//   registers, the producer 40; ptxas would otherwise size all three
//   warpgroups for 168). Q is loaded once per block; K and V tiles of 128
//   keys go through a ring of two stages with full and empty mbarriers, K
//   and V on barriers of their own so that q . k^T starts while V lands.
// - s = q . k^T is wgmma m64n128k16 with both operands in shared memory,
//   K-major as they lie in device memory (q rows x D, k keys x D, D
//   contiguous), DP / 16 steps deep: 6 at D 96.
// - acc += p . v is wgmma m64nDPk16 with A in registers: the s accumulator,
//   exponentiated in place, is packed into bf16 A fragments (that packing
//   is p's rounding to bf16) and v is read from shared memory MN-major, as
//   it lies (keys x D, D contiguous): nothing is staged transposed.
// - Causal work: a block walks its key tiles up to its last row only
//   (the diagonal tile, and keys past S, are the only ones masked); the
//   grid hands out the heaviest query tiles first (query tile gridDim.y -
//   1 - blockIdx.y, blockIdx.x the (batch, head) and fastest).
// - The operands are (B, S, H, D) with any strides on B, S and H: each is
//   read through a rank-4 TMA map with dims (D, S, H, B) and the tensor's
//   own byte strides, in boxes of 64 head-dim columns x 64 (Q) or 128 (K,
//   V) positions, 128-byte swizzle. TMA fills a box past S, and past D
//   (at D 96 the second 64-column box is half outside), with zeros: they
//   score 0, not -inf, so the kpos < S and causal masks stay; the zero D
//   columns add nothing to q . k^T and are never stored.
// - DP, the padded head dim, is 64, 96 or 128 (one instance each): D any
//   multiple of 8 up to 128.
// - The row sums l stay per thread (each lane's share of its row's 32
//   columns, all scaled by the same corrections) and meet across the four
//   lanes of a row once, at the end; the row max meets every tile, since
//   the shift must be the row's. exp is exp2 of the score in log2 units
//   (one FFMA and one MUFU.EX2 per score).
// - Tried on the H100 and not kept: a third K/V stage (no gain); issuing
//   the next tile's q . k^T before this tile's p . v, to hide the softmax
//   behind the tensor cores (ptxas serialized the wgmmas, C7514, and it
//   ran slower).

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

constexpr int kRows = 128;             // query rows of a block
constexpr int kKeys = 128;             // keys of a K or V tile
constexpr int kThreads = 384;          // two consumer warpgroups + the producer's
constexpr int kQBox = 64 * 128;        // 64 rows x 64 bf16 columns: 8 KB
constexpr int kKvBox = kKeys * 128;    // 128 keys x 64 bf16 columns: 16 KB
constexpr int kStages = 2;
constexpr int kConsumerRegs = 232;     // 2 x 128 x 232 + 128 x 40 = 64,512 registers
constexpr int kProducerRegs = 40;

template <int DP>
struct Cfg {
  static constexpr int kBoxes = (DP + 63) / 64;  // 64-column boxes across the head dim
  static constexpr int kQ = 2 * kBoxes * kQBox;  // both warpgroups' q
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
        tma_load4(sq + (w * C::kBoxes + j) * kQBox, &qmap, qfull, 64 * j, q0 + 64 * w, h, b);
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
  const float c = a.scale * 1.4426950408889634f;  // scores to log2 units
  const uint32_t q_addr = smem_addr(sq) + wg * C::kBoxes * kQBox;
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
      wgmma128<0, 0>(s, desc(q_addr + (kk >> 2) * kQBox + 32 * (kk & 3), 16, 1024),
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

// the rank-4 map of one (B, S, H, D) operand, boxes of `rows` positions
int map_of(CUtensorMap* map, const void* p, const Layout& l, const Args& a, uint32_t rows) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long strides_el[3] = {l.sb, l.ss, l.sh};
  for (long long s : strides_el)
    if (s <= 0 || (2 * s) % 16 != 0) return (int)cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)a.D, (uint64_t)a.S, (uint64_t)a.H, (uint64_t)a.B};
  const uint64_t strides[3] = {2 * (uint64_t)l.ss, 2 * (uint64_t)l.sh, 2 * (uint64_t)l.sb};
  return bf16_map4(map, p, dims, strides, rows);
}

template <int DP>
int launch_dp(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, const Args& a,
              cudaStream_t stream) {
  const cudaError_t r = cudaFuncSetAttribute(
      fwd_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DP>::kSmem);
  if (r != cudaSuccess) return (int)r;
  const dim3 grid(a.B * a.H, (a.S + kRows - 1) / kRows);
  fwd_sm90_kernel<DP><<<grid, kThreads, Cfg<DP>::kSmem, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a type, shape, pointer or stride it does not
// take). q, k, v and o are bf16 (dtype 1, flash_attention.cu's code) (B,
// S, H, D) with the given element strides (D contiguous), lse (B, H, S)
// f32 contiguous; D a multiple of 8 up to 128.

extern "C" int flash_fwd_sm90_launch(const void* q, const void* k, const void* v, void* o,
                                     void* lse, Layout lq, Layout lk, Layout lv, Layout lo,
                                     int B, int S, int H, int D, int dtype, float scale,
                                     void* stream) {
  if (dtype != 1 || B <= 0 || S <= 0 || H <= 0 || D < 8 || D > 128 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H >= (1LL << 31) || (S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
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
  int e = map_of(&qm, q, lq, a, 64);
  if (e == 0) e = map_of(&km, k, lk, a, kKeys);
  if (e == 0) e = map_of(&vm, v, lv, a, kKeys);
  if (e != 0) return e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_dp<64>(qm, km, vm, a, s);
  if (D <= 96) return launch_dp<96>(qm, km, vm, a, s);
  return launch_dp<128>(qm, km, vm, a, s);
}
