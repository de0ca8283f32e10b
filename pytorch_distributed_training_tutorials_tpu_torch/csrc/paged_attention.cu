// Paged decode attention for Hopper (sm_90a): walk the page table, never
// gather the window.
//
// Replaces the TPU kernel pytorch_distributed_training_tutorials_tpu/ops/
// paged_attention.py:kernel (pl.pallas_call at ops/paged_attention.py:234,
// driven by paged_attention). It computes what that kernel computes, not
// grid step for grid step:
//
//   out[b, s, h] = sum_t softmax_t(q[b, s, h] . k[t] / sqrt(D)) v[t]
//
// over the positions t <= pos[b] + s of row b, where position t lives at
// offset t % page_size of pool page table[b, t / page_size]. Page ids at
// or beyond n_pages (the sentinel) are skipped, so a parked row (all
// sentinel) writes exact zeros.
//
// One block per (batch row b, kv head c), 128 threads. The block holds its
// S * grp query rows (grp = H / KV; row r is query r / grp of head
// c * grp + r % grp) and runs the TPU kernel's sequential page axis as a
// loop, up to the row's last live page ceil((pos + S) / page_size). It
// reads table[b, :] and pos[b] from device memory, so a new page
// assignment needs no host sync, no recompile and no reallocation. For
// each live page:
//   1. the (page_size x D) K and V tiles of head c are staged in shared
//      memory as f32 and dequantized there: int8 codes times f32 scales,
//      or int4 half-split nibbles (byte j: element j low, j + D/2 high,
//      n >= 8 -> n - 16) times bf16 scales, each product rounded to q's
//      type; exact f32 / bf16 pools are widened as stored;
//   2. scores = q . k * (1/sqrt(D)) in f32, -inf where t > pos + r / grp;
//   3. per row (one warp each): m_new = max(m, max_t scores), the shift 0
//      where m_new is -inf, p = exp(scores - shift), corr = exp(m - shift),
//      l = l corr + sum p; p is rounded to the V tile's type (bf16 pools,
//      or bf16 q over a quantized pool) before the PV product;
//   4. acc = acc corr + p @ v in f32.
// Then out = acc / (l == 0 ? 1 : l), written in q's type.
//
// What bounds it on an H100: the bytes of the live pages' K/V (and
// scales), read once — a decode does 2 flops per byte of f32 K/V, far
// below the card's ridge. This first version is simple, not fast: one
// block per (row, kv head) is 16 blocks at B = 4, KV = 4 on 132 SMs, each
// walking its pages one after another with plain loads and no overlap of
// load and compute. Splitting pages across blocks (a second pass combines
// the splits' (m, l, acc)), cp.async/TMA double buffering and tensor-core
// products are the speed work, measured against this one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

enum Store { kF32 = 0, kBF16 = 1, kInt8 = 2, kInt4 = 3 };

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

// Stage the (page_size x D) tile of kv head c of pool page `page` in shared
// memory as f32, row stride ld; quantized storage is dequantized and each
// value rounded to bf16 when `to_bf16` (the kernel's compute type is bf16).
template <int STORE>
__device__ void load_tile(const void* pool, const void* scale, long long page, int c,
                          int page_size, int kv, int d, float* dst, int ld, bool to_bf16) {
  const int ds = STORE == kInt4 ? d / 2 : d;  // stored elements per token-head
  for (int i = threadIdx.x; i < page_size * ds; i += kThreads) {
    const int t = i / ds, j = i % ds;
    const long long tok = (page * page_size + t) * kv + c;  // (page, t, c)
    const long long off = tok * ds + j;
    float* row = dst + t * ld;
    if (STORE == kF32) {
      row[j] = static_cast<const float*>(pool)[off];
    } else if (STORE == kBF16) {
      row[j] = __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[off]);
    } else if (STORE == kInt8) {
      const float s = static_cast<const float*>(scale)[tok];
      const float x = __fmul_rn(static_cast<float>(static_cast<const int8_t*>(pool)[off]), s);
      row[j] = to_bf16 ? round_bf16(x) : x;
    } else {
      const float s = __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[tok]);
      const int byte = static_cast<const uint8_t*>(pool)[off];
      int lo = byte & 0xF, hi = byte >> 4;
      lo = lo >= 8 ? lo - 16 : lo;
      hi = hi >= 8 ? hi - 16 : hi;
      const float xl = __fmul_rn(static_cast<float>(lo), s);
      const float xh = __fmul_rn(static_cast<float>(hi), s);
      row[j] = to_bf16 ? round_bf16(xl) : xl;
      row[j + ds] = to_bf16 ? round_bf16(xh) : xh;
    }
  }
}

template <typename TQ, int STORE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const void* __restrict__ k_pool,
                       const void* __restrict__ v_pool, const void* __restrict__ k_scale,
                       const void* __restrict__ v_scale, const int* __restrict__ table,
                       const void* __restrict__ pos, int pos64, TQ* __restrict__ out,
                       int S, int H, int KV, int D, int page_size, int P, int n_pages,
                       float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, c = blockIdx.y;
  const int grp = H / KV, sg = S * grp;
  const int ldk = D + 1;  // padded: the score loop reads K rows across threads
  float* qs = smem;                      // sg x D
  float* acc = qs + sg * D;              // sg x D
  float* ks = acc + sg * D;              // page_size x ldk
  float* vs = ks + page_size * ldk;      // page_size x D
  float* sc = vs + page_size * D;        // sg x page_size
  float* m = sc + sg * page_size;        // sg
  float* l = m + sg;                     // sg
  float* corr = l + sg;                  // sg

  constexpr bool kQuant = STORE == kInt8 || STORE == kInt4;
  constexpr bool kBf16Q = sizeof(TQ) == 2;
  // dequantized values take q's type; p takes the V tile's type
  constexpr bool kRoundKV = kQuant && kBf16Q;
  constexpr bool kRoundP = kQuant ? kBf16Q : STORE == kBF16;

  const long long depth = pos64 ? static_cast<const long long*>(pos)[b]
                                : static_cast<const int*>(pos)[b];
  for (int i = threadIdx.x; i < sg * D; i += kThreads) {
    const int r = i / D, j = i % D;
    const int s = r / grp, h = c * grp + r % grp;
    qs[i] = to_f32(q[((static_cast<long long>(b) * S + s) * H + h) * D + j]);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < sg; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  __syncthreads();

  // pages past the deepest query position hold no valid position
  const long long last = (depth + S + page_size - 1) / page_size;
  const int n_live = static_cast<int>(last < P ? last : P);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = 0; p < n_live; ++p) {
    const int pid = table[static_cast<long long>(b) * P + p];
    if (pid < 0 || pid >= n_pages) continue;  // sentinel: the same for the whole block
    load_tile<STORE>(k_pool, k_scale, pid, c, page_size, KV, D, ks, ldk, kRoundKV);
    load_tile<STORE>(v_pool, v_scale, pid, c, page_size, KV, D, vs, D, kRoundKV);
    __syncthreads();
    for (int i = threadIdx.x; i < sg * page_size; i += kThreads) {
      const int r = i / page_size, t = i % page_size;
      const float* qr = qs + r * D;
      const float* kr = ks + t * ldk;
      float dot = 0.f;
      for (int j = 0; j < D; ++j) dot = fmaf(qr[j], kr[j], dot);
      const long long tg = static_cast<long long>(p) * page_size + t;
      sc[i] = tg <= depth + r / grp ? dot * sm_scale : -INFINITY;
    }
    __syncthreads();
    for (int r = warp; r < sg; r += kWarps) {
      float* row = sc + r * page_size;
      float mx = -INFINITY;
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
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
    __syncthreads();
    for (int i = threadIdx.x; i < sg * D; i += kThreads) {
      const int r = i / D, j = i % D;
      const float* pr = sc + r * page_size;
      float a = 0.f;
      for (int t = 0; t < page_size; ++t) a = fmaf(pr[t], vs[t * D + j], a);
      acc[i] = acc[i] * corr[r] + a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < sg * D; i += kThreads) {
    const int r = i / D, j = i % D;
    const int s = r / grp, h = c * grp + r % grp;
    const float lv = l[r];
    store(out + ((static_cast<long long>(b) * S + s) * H + h) * D + j,
          acc[i] / (lv == 0.f ? 1.f : lv));
  }
}

template <typename TQ, int STORE>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                   const void* v_scale, const int* table, const void* pos, int pos64, void* out,
                   int B, int S, int H, int KV, int D, int page_size, int P, int n_pages,
                   float sm_scale, int smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<TQ, STORE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), k_pool, v_pool, k_scale, v_scale, table, pos, pos64,
      static_cast<TQ*>(out), S, H, KV, D, page_size, P, n_pages, sm_scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_store(int store, const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale, const int* table,
                           const void* pos, int pos64, void* out, int B, int S, int H, int KV,
                           int D, int page_size, int P, int n_pages, float sm_scale, int smem,
                           cudaStream_t stream) {
#define PAGED_LAUNCH(ST)                                                                    \
  launch<TQ, ST>(q, k_pool, v_pool, k_scale, v_scale, table, pos, pos64, out, B, S, H, KV, \
                 D, page_size, P, n_pages, sm_scale, smem, stream)
  switch (store) {
    case kF32: return PAGED_LAUNCH(kF32);
    case kBF16: return PAGED_LAUNCH(kBF16);
    case kInt8: return PAGED_LAUNCH(kInt8);
    case kInt4: return PAGED_LAUNCH(kInt4);
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_LAUNCH
}

}  // namespace

// q_code: 0 float32, 1 bfloat16 (q and out); store: 0 float32, 1 bfloat16,
// 2 int8 (+ f32 scales), 3 int4 (+ bf16 scales); pos64: pos is int64.
// Returns the CUDA error of the launch (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* k_scale, const void* v_scale,
                                      const void* table, const void* pos, void* out, int B,
                                      int S, int H, int KV, int D, int page_size, int P,
                                      int n_pages, int q_code, int store, int pos64,
                                      float sm_scale, int smem, void* stream) {
  const int* tbl = static_cast<const int*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_code == 0)
    return dispatch_store<float>(store, q, k_pool, v_pool, k_scale, v_scale, tbl, pos, pos64,
                                 out, B, S, H, KV, D, page_size, P, n_pages, sm_scale, smem, st);
  if (q_code == 1)
    return dispatch_store<__nv_bfloat16>(store, q, k_pool, v_pool, k_scale, v_scale, tbl, pos,
                                         pos64, out, B, S, H, KV, D, page_size, P, n_pages,
                                         sm_scale, smem, st);
  return cudaErrorInvalidValue;
}
