// int8 matmul with dynamic per-(row, K-tile) activation quantization, for
// Hopper (sm_90a) on the s8 tensor cores. ops/quant.py routes a CUDA call
// here when K is a multiple of 16 and x and qt have 16-byte aligned bases
// (what TMA takes); every other call runs int8_matmul.cu's kernels.
//
// Replaces, as int8_matmul.cu does, the TPU kernel
// pytorch_distributed_training_tutorials_tpu/ops/quant.py:_int8_matmul_kernel
// (:141, pl.pallas_call at :234), and computes what it computes, bit for
// bit:
//
//   out = (sum over K tiles t, in order, of  part_t * sx_t)  *  scale
//   part_t = xq_t . q_t           exact int32 (int8 x int8 products)
//   xq_t   = clamp(rint(x_t / sx_t), -127, 127),
//   sx_t   = max(absmax(x_t), 1e-8) * float32(1/127)   per (row, tile)
//
// over tiles of block_k columns (ops/quant.py block_k_for), as
// sx = __fmul_rn(max(amax, 1e-8), f32(1/127)), an IEEE division, rintf,
// one acc = __fmaf_rn(float(part), sx, acc) per tile in tile order and
// out = __fmul_rn(acc, scale), under -fmad=false.
//
// What bounds it on an H100: at decode (M = the slot count, 4) the bytes
// of the int8 weight, each read once: 1.14 GB per 1b decode forward, 0.344
// ms at 3.35 TB/s; 1.27 us for a (2048, 2048) projection. The design:
//
// - Swap-AB on the s8 tensor cores: out^T = qt . xq^T with
//   wgmma m64nBNk32.s32.s8.s8. A is a 64-row slab of qt (N, K) — 64
//   output columns — K-major as it lies in memory; B is BN rows of xq,
//   K-major too (8-bit wgmma takes no other layout). A 512-wide K tile is
//   16 k32 steps into an int32 accumulator that starts fresh (scale-d 0),
//   exact (a tile sum is below 2^24); the f32 fold follows per tile.
// - Weights streamed: one producer thread keeps a ring of 32 KB TMA stages
//   (one K tile of the slab: four 64 x 128-byte boxes, 128-byte swizzle,
//   zeros past N and K) in flight, 2 stages deep at M <= 64 (two blocks
//   an SM at BN 8) and 3 above, while the consumer warpgroup quantizes,
//   multiplies and folds.
// - One launch per call at decode sizes: at M <= 64 (kFusedMaxM) the
//   consumer warpgroup quantizes the x tiles its own K range needs straight
//   from x (in L2) into swizzled shared tiles, one warp per (tile, row),
//   one 16-value chunk a lane, up to 4 tiles at once at BN 8 (every 1b
//   shape's whole K range; two at BN 64) so that one x latency overlaps the
//   weights' TMA; every block runs the same arithmetic on the same x, so
//   every block gets the same bits. BN is 8 at M <= 8, else 64. At M > 64 a
//   pre-pass (quantize_tiles, the same per-lane arithmetic) writes xq and
//   sx once, and the GEMM loads xq tiles of 64 rows by TMA beside the
//   weight boxes (3 stages of 64 KB).
// - The card filled while the tile order is kept: a (2048, 2048) call has
//   only 32 slabs, so the K tiles are split across blocks (ops/quant.py
//   _sm90_plan: splits = SMs / (slabs x row tiles), one block per SM).
//   Each block writes its exact tile sums (as f32: below 2^24, exact) and,
//   fused, its tiles' sx to scratch; the last block of a slab, found by an
//   atomic ticket that it resets to 0 for the next call, folds every tile
//   in order and applies the column scale. Integer sums and a fixed fold
//   order: the result is bitwise the plain version's, and two calls are
//   bitwise equal.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kSlab = 64;           // weight rows (output columns) per block
constexpr int kMaxBlockK = 512;     // the widest K tile
constexpr int kBoxK = 128;          // K bytes per TMA box (one swizzled row)
constexpr int kWBox = kSlab * kBoxK;            // 8 KB
constexpr int kWStage = kSlab * kMaxBlockK;     // 32 KB: one K tile of the slab
constexpr int kFusedMaxM = 64;      // at or below: quantize inside the GEMM
constexpr int kConsumers = 128;     // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr float kRcp127 = 0x1.020408p-7f;  // float32(1 / 127)

struct Args {
  const float* x;        // (M, K) f32 (fused)
  const float* sx_in;    // (n_k, M) f32 from the pre-pass (not fused)
  const float* scale;    // (N,) f32
  float* out;            // (M, N) f32
  float* part;           // (slabs, n_k, M, 64) exact tile sums as f32 (splits > 1)
  float* sx_part;        // (slabs, n_k, M) f32 tile scales (fused, splits > 1)
  int* tickets;          // (slabs * row tiles) int32, 0 between calls
  int M, N, K, block_k, n_k, tiles_per_split, splits;
};

template <int BN, bool kFused>
struct Cfg {
  // fused: 2 stages (the block's x tiles are quantized at once, so its
  // next tiles' weights are what the ring holds; at 82 KB two BN 8 blocks
  // share an SM, which the 500 blocks of the lm_head use)
  static constexpr int kStages = kFused ? 2 : 3;
  static constexpr int kXStage = kFused ? 0 : BN * kMaxBlockK;  // TMA-loaded xq
  static constexpr int kStage = kWStage + kXStage;
  // fused: the x tiles quantized at once (all of a block's at every 1b
  // shape at BN 8), and their bytes in shared memory
  static constexpr int kXTiles = kFused ? (BN == 8 ? 4 : 2) : 0;
  static constexpr int kXs = kXTiles * BN * kMaxBlockK;
  static constexpr int kSmem =
      1024 + kStages * kStage + kXs + kXTiles * BN * 4 + 2 * kStages * 8 + 16;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A lane's 16 values of x row xr at [k, k + 16): zeros at or past K, or
// for an idle lane. K is a multiple of 16, so a chunk lies wholly inside or
// wholly past K.
__device__ __forceinline__ void load16(const float* __restrict__ xr, int k, int K, bool active,
                                       float (&v)[16]) {
  if (active && k < K) {
    const float4* p = reinterpret_cast<const float4*>(xr + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = __ldg(p + j);
      v[4 * j] = f.x;
      v[4 * j + 1] = f.y;
      v[4 * j + 2] = f.z;
      v[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = 0.f;
  }
}

// One warp quantizes one (row, K tile) from the lanes' loaded values:
// returns the tile's sx and the lane's 16 codes packed in order. All 32
// lanes must call it.
//
// The code is rint(RN(x / sx)) (an IEEE division, as the plain version's).
// 16 IEEE divisions a lane are a latency chain (each a reciprocal,
// refinements and a branch to a slow path, which the compiler does not
// interleave), so the quotients are taken as q = RN(x * RN(1 / sx)),
// branch-free, and the warp divides only when some q lies within 2^-14 of
// a half-integer: q is within 2 ulps (< 1.6e-5 at |q| < 128) of x / sx,
// so farther from a rounding boundary rint(q) equals rint(RN(x / sx)), bit
// for bit.
__device__ __forceinline__ float quantize16(const float (&v)[16], uint4& codes) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) amax = fmaxf(amax, fabsf(v[j]));
  const float s = __fmul_rn(fmaxf(warp_max(amax), 1e-8f), kRcp127);
  const float inv = __frcp_rn(s);
  float q[16];
  bool near = false;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    q[j] = __fmul_rn(v[j], inv);
    near |= fabsf(__fsub_rn(q[j], __fadd_rn(floorf(q[j]), 0.5f))) <= 0x1p-14f;
  }
  if (__any_sync(0xffffffffu, near)) {  // rare, and warp-uniform
#pragma unroll
    for (int j = 0; j < 16; ++j) q[j] = __fdiv_rn(v[j], s);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float r = fminf(fmaxf(rintf(q[j]), -127.f), 127.f);
    w[j / 4] |= (uint32_t)(uint8_t)(int8_t)r << (8 * (j % 4));
  }
  codes = make_uint4(w[0], w[1], w[2], w[3]);
  return s;
}

// The pre-pass at M > kFusedMaxM: one warp per (row, K tile) writes xq
// (M, Kp) int8, zero past K, and sx (n_k, M) f32.
__global__ void __launch_bounds__(128)
    quantize_tiles(const float* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                   int M, int K, int Kp, int block_k) {
  const int m = blockIdx.y * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int t = blockIdx.x, k = t * block_k + 16 * lane;
  if (m >= M) return;
  float v[16];
  load16(x + (size_t)m * K, k, K, 16 * lane < block_k, v);
  uint4 codes;
  const float s = quantize16(v, codes);
  if (16 * lane < block_k) *reinterpret_cast<uint4*>(xq + (size_t)m * Kp + k) = codes;
  if (lane == 0) sx[(size_t)t * M + m] = s;
}

// One warp's (tile, row) unit of the fused path's quantization: x row m0 +
// m of tile t + ti into its slot of xs (swizzled) and ss.
template <int BN>
__device__ __forceinline__ void store_unit(const Args& a, uint8_t* xs, float* ss, int slab,
                                           int m0, int t, int ti, int m, int lane,
                                           const uint4& codes, float sx) {
  const int live = min(a.block_k, a.K - (t + ti) * a.block_k);
  if (16 * lane < ((live + 31) / 32) * 32) {
    const int box = lane >> 3, piece = lane & 7;
    *reinterpret_cast<uint4*>(xs + ti * BN * kMaxBlockK + box * BN * kBoxK + m * kBoxK +
                              ((piece ^ (m & 7)) << 4)) = codes;
  }
  if (lane == 0) {
    ss[ti * BN + m] = sx;
    if (a.splits > 1) a.sx_part[((size_t)slab * a.n_k + t + ti) * a.M + m0 + m] = sx;
  }
}

__device__ __forceinline__ void load_unit(const Args& a, int m0, int rows, int t, int u,
                                          int lane, float (&v)[16]) {
  const int ti = u / rows, m = u - ti * rows;
  const int kt = (t + ti) * a.block_k;
  const int live = min(a.block_k, a.K - kt);
  load16(a.x + (size_t)(m0 + m) * a.K, kt + 16 * lane, a.K,
         16 * lane < ((live + 31) / 32) * 32, v);
}

// The fused path's quantization of tiles [t, t + nt) of rows m0 .. m0 +
// rows - 1 into xs (one BN x block_k tile a slot) and ss: a warp per
// (tile, row) unit, 4 units at a time while 4 remain — all loaded before
// any is quantized, and quantized without branches between them, so that
// their latencies overlap — then one at a time.
template <int BN>
__device__ __forceinline__ void quantize_chunk(const Args& a, uint8_t* xs, float* ss, int slab,
                                               int m0, int rows, int t, int nt, int warp,
                                               int lane) {
  const int units = nt * rows;
  int u0 = warp;
  for (; u0 + 12 < units; u0 += 16) {
    float v[4][16];
    uint4 codes[4];
    float sx[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) load_unit(a, m0, rows, t, u0 + 4 * q, lane, v[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) sx[q] = quantize16(v[q], codes[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = u0 + 4 * q, ti = u / rows;
      store_unit<BN>(a, xs, ss, slab, m0, t, ti, u - ti * rows, lane, codes[q], sx[q]);
    }
  }
  for (; u0 < units; u0 += 4) {
    float v[16];
    uint4 codes;
    load_unit(a, m0, rows, t, u0, lane, v);
    const float sx = quantize16(v, codes);
    const int ti = u0 / rows;
    store_unit<BN>(a, xs, ss, slab, m0, t, ti, u0 - ti * rows, lane, codes, sx);
  }
}

template <int BN, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap xmap, const Args a) {
  using C = Cfg<BN, kFused>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* xs = smem + C::kStages * C::kStage;          // fused: quantized x tiles
  float* ss = reinterpret_cast<float*>(xs + C::kXs);    // fused: their sx per row
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + C::kXTiles * BN);
  uint64_t* empty = full + C::kStages;
  int* last_flag = reinterpret_cast<int*>(empty + C::kStages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, slab = blockIdx.y, mt = blockIdx.z;
  const int n0 = slab * kSlab, m0 = mt * BN;
  const int t0 = split * a.tiles_per_split;
  const int t1 = min(a.n_k, t0 + a.tiles_per_split);
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  Ring ring;
  if (warp == 4) {
    // the producer: per K tile, the slab's weight boxes (and xq's)
    if (lane != 0) return;
    for (int t = t0; t < t1; ++t) {
      const int k0 = t * a.block_k;
      const int steps = (min(a.block_k, a.K - k0) + 31) / 32;
      const int boxes = (steps * 32 + kBoxK - 1) / kBoxK;
      uint8_t* st = smem + ring.stage * C::kStage;
      mbar_wait(&empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&full[ring.stage], boxes * (kWBox + (kFused ? 0 : BN * kBoxK)));
      for (int j = 0; j < boxes; ++j) {
        tma_load(st + j * kWBox, &wmap, &full[ring.stage], k0 + j * kBoxK, n0);
        if (!kFused)
          tma_load(st + kWStage + j * BN * kBoxK, &xmap, &full[ring.stage], k0 + j * kBoxK, m0);
      }
      ring.next<C::kStages>();
    }
    return;
  }
  // the consumer warpgroup: this thread holds d[i] at slab row (output
  // column) n0 + 16 warp + lane / 4 + 8 ((i / 2) % 2) and x row m0 + 8 (i /
  // 4) + 2 (lane % 4) + i % 2
  const int rows = min(BN, a.M - m0);
  const uint32_t stages = smem_addr(smem), xs_addr = smem_addr(xs);
  float acc[BN / 2];
  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // fused: the tiles in chunks of kXTiles, each chunk's x quantized at
  // once before its products (one chunk at BN 8 for every 1b shape)
  const int chunk = kFused ? C::kXTiles : t1 - t0;
  for (int tc = t0; tc < t1; tc += chunk) {
    if (kFused) {
      if (tc > t0) named_sync(1, kConsumers);  // the last chunk's products have read xs
      quantize_chunk<BN>(a, xs, ss, slab, m0, rows, tc, min(chunk, t1 - tc), warp, lane);
      fence_async_smem();
      named_sync(1, kConsumers);
    }
    for (int t = tc; t < min(t1, tc + chunk); ++t) {
      const int k0 = t * a.block_k;
      const int steps = (min(a.block_k, a.K - k0) + 31) / 32;
      const int xt = t - tc;  // fused: this tile's slot in xs
      mbar_wait(&full[ring.stage], ring.phase);
      const uint32_t wst = stages + ring.stage * C::kStage;
      const uint32_t xst = kFused ? xs_addr + xt * BN * kMaxBlockK : wst + kWStage;
      wgmma_fence();
      fence_operand(d);
      for (int kk = 0; kk < steps; ++kk) {
        const uint32_t off = 32 * (kk & 3);  // the k32 step's bytes within its 128-byte box
        wgmma_s8<BN>(d, desc(wst + (kk >> 2) * kWBox + off, 16, 1024),
                     desc(xst + (kk >> 2) * BN * kBoxK + off, 16, 1024), kk == 0 ? 0u : 1u);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(d);
      if (lane == 0) mbar_arrive(&empty[ring.stage]);
      ring.next<C::kStages>();
      // the exact tile sums as floats (below 2^24), taken from the
      // accumulator for every i before any lane-dependent branch: a branch
      // that reads the accumulator makes the compiler serialize the wgmmas
      float pf[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pf[i] = __int2float_rn(d[i]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int r = 16 * warp + (lane >> 2) + 8 * ((i / 2) & 1);
        if (c >= rows) continue;
        if (a.splits == 1) {
          const float s = kFused ? ss[xt * BN + c] : __ldg(a.sx_in + (size_t)t * a.M + m0 + c);
          acc[i] = __fmaf_rn(pf[i], s, acc[i]);
        } else {
          a.part[(((size_t)slab * a.n_k + t) * a.M + m0 + c) * kSlab + r] = pf[i];
        }
      }
    }
  }
  if (a.splits == 1) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
      const int n = n0 + 16 * warp + (lane >> 2) + 8 * ((i / 2) & 1);
      if (c < rows && n < a.N)
        a.out[(size_t)(m0 + c) * a.N + n] = __fmul_rn(acc[i], __ldg(a.scale + n));
    }
    return;
  }
  // split K: the last block of this (slab, row tile) to arrive folds every
  // tile's sums in tile order, then resets the ticket for the next call
  __threadfence();
  named_sync(1, kConsumers);
  if (tid == 0) {
    int* ticket = a.tickets + slab * gridDim.z + mt;
    const int prev = atomicAdd(ticket, 1);
    const int last = prev == a.splits - 1;
    if (last) *ticket = 0;
    *last_flag = last;
  }
  named_sync(1, kConsumers);
  if (!*last_flag) return;
  __threadfence();
  for (int e = tid; e < rows * kSlab; e += kConsumers) {
    const int c = e / kSlab, r = e % kSlab, n = n0 + r;
    if (n >= a.N) continue;
    float f = 0.f;
    for (int t0 = 0; t0 < a.n_k; t0 += 8) {  // 8 tiles' loads in flight, then the ordered fold
      float p[8], s[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = min(t0 + u, a.n_k - 1);
        p[u] = __ldcg(a.part + (((size_t)slab * a.n_k + t) * a.M + m0 + c) * kSlab + r);
        s[u] = kFused ? __ldcg(a.sx_part + ((size_t)slab * a.n_k + t) * a.M + m0 + c)
                      : __ldg(a.sx_in + (size_t)t * a.M + m0 + c);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (t0 + u < a.n_k) f = __fmaf_rn(p[u], s[u], f);
    }
    a.out[(size_t)(m0 + c) * a.N + n] = __fmul_rn(f, __ldg(a.scale + n));
  }
}

struct MapKey {
  const void* base;
  uint64_t rows, cols;
  uint32_t box_rows, pad;
};

MapCache<MapKey>& map_cache() {
  static MapCache<MapKey> cache;
  return cache;
}

int cached_s8_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                  uint32_t box_rows) {
  const MapKey key{base, rows, cols, box_rows, 0u};
  return map_cache().get(key, map, [&](CUtensorMap* m) {
    return s8_map(m, base, rows, cols, box_rows);
  });
}

template <int BN, bool kFused>
int launch_gemm(const CUtensorMap& wmap, const CUtensorMap& xmap, const Args& a, int slabs,
                int row_tiles, cudaStream_t stream) {
  auto kernel = gemm_sm90_kernel<BN, kFused>;
  constexpr int smem = Cfg<BN, kFused>::kSmem;
  static bool sized = false;  // once per instance: this is on every decode call's path
  if (!sized) {
    cudaError_t r =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (r != cudaSuccess) return (int)r;
    sized = true;
  }
  kernel<<<dim3(a.splits, slabs, row_tiles), kThreads, smem, stream>>>(wmap, xmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32 row-major; qt (N, K) int8 row-major (the (K, N) weight
// K-contiguous); scale (N,) f32; out (M, N) f32; K a multiple of 16, x and
// qt 16-byte aligned. The K tiles (block_k wide, n_k of them) are cut into
// `splits` runs of tiles_per_split. Scratch: at M > 64, xq (M, n_k *
// block_k) int8 and sx (n_k, M) f32 (the pre-pass); when splits > 1, part
// (ceil(N / 64), n_k, M, 64) f32, at M <= 64 also sx_part (ceil(N / 64),
// n_k, M) f32; tickets (ceil(N / 64) * row tiles) int32, all 0 (each
// call leaves them 0). Launches on `stream` (one launch at M <= 64, two
// above) and returns cudaGetLastError(), or cudaErrorInvalidValue for
// operands it does not take.
extern "C" int int8_matmul_sm90_launch(const void* x, const void* qt, const void* scale,
                                       void* out, void* xq, void* sx, void* part, void* sx_part,
                                       void* tickets, int M, int N, int K, int block_k,
                                       int tiles_per_split, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > kMaxBlockK || block_k % 128) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(qt) % 16)
    return (int)cudaErrorInvalidValue;
  const int n_k = (K + block_k - 1) / block_k;
  if (tiles_per_split <= 0 || splits <= 0 || splits > 65535 ||
      (long long)(splits - 1) * tiles_per_split >= n_k ||
      (long long)splits * tiles_per_split < n_k)
    return (int)cudaErrorInvalidValue;
  const bool fused = M <= kFusedMaxM;
  if (splits > 1 && (part == nullptr || tickets == nullptr || (fused && sx_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!fused && (xq == nullptr || sx == nullptr || reinterpret_cast<uintptr_t>(xq) % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int slabs = (N + kSlab - 1) / kSlab;
  Args a{};
  a.x = static_cast<const float*>(x);
  a.sx_in = static_cast<const float*>(sx);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.sx_part = static_cast<float*>(sx_part);
  a.tickets = static_cast<int*>(tickets);
  a.M = M;
  a.N = N;
  a.K = K;
  a.block_k = block_k;
  a.n_k = n_k;
  a.tiles_per_split = tiles_per_split;
  a.splits = splits;
  CUtensorMap wmap;
  int e = cached_s8_map(&wmap, qt, N, K, kSlab);
  if (e != 0) return e;
  if (fused) {
    // xmap unused: the consumers quantize x themselves
    if (M <= 8) return launch_gemm<8, true>(wmap, wmap, a, slabs, 1, st);
    return launch_gemm<64, true>(wmap, wmap, a, slabs, 1, st);
  }
  const int Kp = n_k * block_k;
  quantize_tiles<<<dim3(n_k, (M + 3) / 4), 128, 0, st>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, Kp,
      block_k);
  cudaError_t r = cudaGetLastError();
  if (r != cudaSuccess) return (int)r;
  CUtensorMap xmap;
  e = cached_s8_map(&xmap, xq, M, Kp, 64);
  if (e != 0) return e;
  return launch_gemm<64, false>(wmap, xmap, a, slabs, (M + 63) / 64, st);
}

// Host cost of one TMA map of qt, in ns per map over `reps` encodes:
// encoded afresh (cached == 0) or through the cache (cached != 0).
extern "C" double int8_matmul_sm90_encode_ns(const void* qt, int N, int K, int reps,
                                             int cached) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const int e = cached ? cached_s8_map(&map, qt, N, K, kSlab) : s8_map(&map, qt, N, K, kSlab);
    if (e != 0) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
}
