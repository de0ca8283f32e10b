// mma.sync fragment helpers shared by the port's tensor-core kernels
// (flash_attention.cu, fused_loss.cu): the element types, the m16n8k16
// product in bf16 on the tensor cores and the same product in f32 on the
// CUDA cores, and the A/B fragment loads from shared memory.
//
// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4 g + t; an A fragment
// holds rows g, g + 8 x columns 2t, 2t + 1, 2t + 8, 2t + 9; a B fragment
// column g x rows (k) 2t, 2t + 1, 2t + 8, 2t + 9; an accumulator rows g,
// g + 8 x columns 2t, 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// the element types: a Pair is two adjacent elements of a row, the unit of
// every fragment

using bf16 = __nv_bfloat16;

template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  using Pair = uint32_t;
  static __device__ __forceinline__ bf16 zero() { return __float2bfloat16_rn(0.f); }
  static __device__ __forceinline__ bf16 cvt(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ Pair ld2(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  // two f32 rounded to bf16 (the cast before a product), low half first
  static __device__ __forceinline__ Pair pair(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void store2(bf16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Elem<float> {
  using Pair = float2;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float cvt(float x) { return x; }
  static __device__ __forceinline__ Pair ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ Pair pair(float lo, float hi) { return make_float2(lo, hi); }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    p[0] = x;
    p[1] = y;
  }
};

// c += a . b for one 16 x 8 x 16 tile; a: 4 pairs (rows g, g + 8 x columns
// 2t, 2t + 8), b: 2 pairs (k 2t, 2t + 8 x column g); c: rows g, g + 8 x
// columns 2t, 2t + 1
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 shfl2(float2 x, int lane) {
  return make_float2(__shfl_sync(0xffffffffu, x.x, lane), __shfl_sync(0xffffffffu, x.y, lane));
}

// the same fragment product in f32 on the CUDA cores: lane (g, t) takes
// row g's and g + 8's A pairs from lanes (g, u) and column 2t + j's B pairs
// from lanes (2t + j, u), u = 0..3, and sums k in the order 2u, 2u + 1,
// 2u + 8, 2u + 9. Out of line: inlined into every unrolled product of
// every instance, it multiplied the build time by ten
__device__ __noinline__ float4 mma_f32(float4 c, float2 a0, float2 a1, float2 a2, float2 a3,
                                       float2 b0, float2 b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 r0 = shfl2(a0, 4 * g + u), r1 = shfl2(a1, 4 * g + u);
    const float2 r2 = shfl2(a2, 4 * g + u), r3 = shfl2(a3, 4 * g + u);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 x0 = shfl2(b0, 4 * (2 * t + j) + u), x1 = shfl2(b1, 4 * (2 * t + j) + u);
      float r = acc[j];
      r = fmaf(r0.x, x0.x, r);
      r = fmaf(r0.y, x0.y, r);
      r = fmaf(r2.x, x1.x, r);
      acc[j] = fmaf(r2.y, x1.y, r);
      r = acc[2 + j];
      r = fmaf(r1.x, x0.x, r);
      r = fmaf(r1.y, x0.y, r);
      r = fmaf(r3.x, x1.x, r);
      acc[2 + j] = fmaf(r3.y, x1.y, r);
    }
  }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__device__ __forceinline__ void mma(float (&c)[4], const float2 (&a)[4], float2 b0, float2 b1) {
  const float4 r = mma_f32(make_float4(c[0], c[1], c[2], c[3]), a[0], a[1], a[2], a[3], b0, b1);
  c[0] = r.x;
  c[1] = r.y;
  c[2] = r.z;
  c[3] = r.w;
}

// the A fragment of rows r0 + [0, 16), columns c0 + [0, 16) of a row-major
// tile with row length ld
template <typename T>
__device__ __forceinline__ void load_a(typename Elem<T>::Pair (&a)[4], const T* tile, int ld,
                                       int r0, int c0, int g, int t) {
  const T* p = tile + (r0 + g) * ld + c0 + 2 * t;
  a[0] = Elem<T>::ld2(p);
  a[1] = Elem<T>::ld2(p + 8 * ld);
  a[2] = Elem<T>::ld2(p + 8);
  a[3] = Elem<T>::ld2(p + 8 * ld + 8);
}

// c += a . b, this lane's B pairs read from a tile stored k-contiguous:
// col points at k = 2t of the lane's column g (k = 2t + 8 follows at + 8)
template <typename T>
__device__ __forceinline__ void mma_b(float (&c)[4], const typename Elem<T>::Pair (&a)[4],
                                      const T* col) {
  mma(c, a, Elem<T>::ld2(col), Elem<T>::ld2(col + 8));
}

// the A fragment of a 16 x 16 slice held as two 16 x 8 score fragments
// (n-tiles j, j + 1), each value rounded to T on the way
template <typename T>
__device__ __forceinline__ void frag_to_a(typename Elem<T>::Pair (&a)[4], const float (&lo)[4],
                                          const float (&hi)[4]) {
  a[0] = Elem<T>::pair(lo[0], lo[1]);
  a[1] = Elem<T>::pair(lo[2], lo[3]);
  a[2] = Elem<T>::pair(hi[0], hi[1]);
  a[3] = Elem<T>::pair(hi[2], hi[3]);
}

}  // namespace
