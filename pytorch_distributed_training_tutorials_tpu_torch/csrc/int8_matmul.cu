// int8 matmul with dynamic per-(row, K-tile) activation quantization, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_training_tutorials_tpu/ops/
// quant.py:_int8_matmul_kernel (pl.pallas_call at ops/quant.py:234, driven
// by int8_matmul). It computes what that kernel computes, not block for
// block:
//
//   out = (sum over K tiles t, in order, of  part_t * sx_t)  *  scale
//   part_t = xq_t . q_t           exact int32 (int8 x int8 products)
//   xq_t   = clamp(rint(x_t / sx_t), -127, 127),
//   sx_t   = max(absmax(x_t), 1e-8) * float32(1/127)   per (row, tile)
//
// with tiles of block_k columns (min(512, max(128, K)) rounded up to a
// multiple of 128, K zero-padded), exactly the grouping of the TPU kernel.
//
// Numerics match the reference as XLA executes it: XLA folds `/ 127.0` into
// a multiply by the float32 reciprocal and contracts `acc + part * sx` into
// one fused multiply-add. So sx is a __fmul_rn by that reciprocal, the
// accumulation is __fmaf_rn, x / sx is an IEEE division (no fast math), and
// rintf rounds half to even like jnp.round. The per-tile integer sum is at
// most 512 * 127 * 127 < 2^24, so its conversion to float is exact.
//
// Two launches, counted as one call by the Python wrapper:
//   1. quantize_tiles: one block per (row, K tile) writes xq (M, Kp) int8,
//      zero-padded to Kp = n_k * block_k, and sx (M, n_k) f32.
//   2. gemm_tiles: one warp per output column, kRows rows per block. The
//      weight is stored (N, K), K-contiguous, so a warp reads one column's
//      K tile as contiguous 4-byte words; each lane dots them with the
//      staged xq tile through __dp4a, a warp sum gives the exact tile dot,
//      and the tile is folded into the f32 accumulator in tile order.
//      Ragged M, N and K are masked here; nothing is padded in memory.
//
// What bounds it on an H100: at decode M is the slot count (4), each weight
// byte is used M times and the kernel is bound by the bytes of the int8
// weight (the 1b preset's decode step reads about 1.14 GB of int8 weights:
// 0.34 ms at 3.35 TB/s). This first version reads the weight with plain
// 4-byte loads and has no wgmma, TMA, pipelining or fused quantize; those
// are later work, measured against this one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 128;
constexpr int kMaxBlockK = 512;
constexpr int kWarps = 8;  // output columns per block: one per warp
constexpr int kRows = 16;  // output rows per block
constexpr int kWordsPerLane = kMaxBlockK / 128;  // 4-byte words per lane per tile
constexpr float kRcp127 = 0x1.020408p-7f;        // float32(1 / 127)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void quantize_tiles(const float* __restrict__ x, int8_t* __restrict__ xq,
                               float* __restrict__ sx, int K, int Kp, int block_k,
                               int n_k) {
  const int m = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * block_k;
  const float* xr = x + (size_t)m * K;
  float v[kMaxBlockK / kQuantThreads];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxBlockK / kQuantThreads; ++j) {
    const int kk = threadIdx.x + j * kQuantThreads;
    const int k = k0 + kk;
    const float val = (kk < block_k && k < K) ? xr[k] : 0.f;
    v[j] = val;
    amax = fmaxf(amax, fabsf(val));
  }
  __shared__ float red[kQuantThreads / 32];
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  float tile_max = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) tile_max = fmaxf(tile_max, red[w]);
  const float s = __fmul_rn(fmaxf(tile_max, 1e-8f), kRcp127);
#pragma unroll
  for (int j = 0; j < kMaxBlockK / kQuantThreads; ++j) {
    const int kk = threadIdx.x + j * kQuantThreads;
    if (kk < block_k) {
      float r = rintf(__fdiv_rn(v[j], s));
      r = fminf(fmaxf(r, -127.f), 127.f);
      xq[(size_t)m * Kp + k0 + kk] = (int8_t)r;
    }
  }
  if (threadIdx.x == 0) sx[(size_t)m * n_k + kt] = s;
}

// Four weight bytes of one column row starting at k; bytes at k >= K read 0.
template <bool kAligned>
__device__ __forceinline__ int load_word(const int8_t* __restrict__ row, int k, int K) {
  if (kAligned) {  // K % 4 == 0 and the row base is 4-byte aligned
    return k < K ? __ldg(reinterpret_cast<const int*>(row + k)) : 0;
  }
  unsigned w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned b = (k + i < K) ? (unsigned)(uint8_t)row[k + i] : 0u;
    w |= b << (8 * i);
  }
  return (int)w;
}

template <bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
gemm_tiles(const int8_t* __restrict__ xq, const float* __restrict__ sx,
           const int8_t* __restrict__ qt, const float* __restrict__ scale,
           float* __restrict__ out, int M, int N, int K, int Kp, int block_k,
           int n_k) {
  __shared__ __align__(16) int xs[kRows][kMaxBlockK / 4];
  __shared__ float ss[kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - m0);
  const bool col_ok = n < N;
  const int8_t* qrow = qt + (size_t)(col_ok ? n : 0) * K;
  const int words = block_k / 4;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * block_k;
    __syncthreads();  // the previous tile's xs/ss reads are done
    for (int i = threadIdx.x; i < kRows * words; i += kWarps * 32) {
      const int r = i / words;
      const int w = i - r * words;
      xs[r][w] = r < rows
          ? *reinterpret_cast<const int*>(xq + (size_t)(m0 + r) * Kp + k0 + 4 * w)
          : 0;
    }
    if (threadIdx.x < kRows) {
      ss[threadIdx.x] = (int)threadIdx.x < rows ? sx[(size_t)(m0 + threadIdx.x) * n_k + kt] : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;  // warp-uniform
    int wq[kWordsPerLane];
#pragma unroll
    for (int j = 0; j < kWordsPerLane; ++j) {
      const int w = lane + 32 * j;
      wq[j] = w < words ? load_word<kAligned>(qrow, k0 + 4 * w, K) : 0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;  // warp-uniform
      int s = 0;
#pragma unroll
      for (int j = 0; j < kWordsPerLane; ++j) {
        const int w = lane + 32 * j;
        if (w < words) s = __dp4a(wq[j], xs[r][w], s);
      }
      s = warp_sum(s);  // exact int32 dot of this tile
      acc[r] = __fmaf_rn(__int2float_rn(s), ss[r], acc[r]);
    }
  }
  if (!col_ok) return;
  const float sc = scale[n];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows && lane == r) out[(size_t)(m0 + r) * N + n] = __fmul_rn(acc[r], sc);
  }
}

}  // namespace

// x (M, K) f32 row-major; qt (N, K) int8 row-major, i.e. the (K, N) weight
// K-contiguous; scale (N,) f32; out (M, N) f32; xq (M, Kp) int8 and sx
// (M, n_k) f32 scratch, Kp = n_k * block_k, n_k = ceil(K / block_k).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int int8_matmul_launch(const void* x, const void* qt, const void* scale,
                                  void* out, void* xq, void* sx, int M, int N, int K,
                                  int block_k, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > kMaxBlockK || block_k % 128) return (int)cudaErrorInvalidValue;
  const int n_k = (K + block_k - 1) / block_k;
  const int Kp = n_k * block_k;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  quantize_tiles<<<dim3(M, n_k), kQuantThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), K, Kp,
      block_k, n_k);
  const dim3 grid((N + kWarps - 1) / kWarps, (M + kRows - 1) / kRows);
  const bool aligned = K % 4 == 0 && reinterpret_cast<uintptr_t>(qt) % 4 == 0;
  if (aligned) {
    gemm_tiles<true><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
        static_cast<const int8_t*>(qt), static_cast<const float*>(scale),
        static_cast<float*>(out), M, N, K, Kp, block_k, n_k);
  } else {
    gemm_tiles<false><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
        static_cast<const int8_t*>(qt), static_cast<const float*>(scale),
        static_cast<float*>(out), M, N, K, Kp, block_k, n_k);
  }
  return (int)cudaGetLastError();
}
