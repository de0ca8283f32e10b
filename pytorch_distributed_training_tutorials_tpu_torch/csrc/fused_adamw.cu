// Fused AdamW for Hopper (sm_90a): one pass over every parameter leaf.
//
// Replaces the TPU kernel _adamw_kernel of pytorch_distributed_training_
// tutorials_tpu/ops/fused_optim.py (:50, pl.pallas_call at :88). It computes
// optax.adamw's update, in the order of the port's plain version
// (train/optim.py AdamW.update_), and applies it:
//
//   m = m * b1 + g * (1 - b1)
//   v = v * b2 + (g * g) * (1 - b2)
//   u = (m * ibc1) / (sqrt(v * ibc2) + eps)
//   u = (u + p * wd) * (-lr)
//   p = p + u
//
// with ibc1 = 1 / (1 - b1^t) and ibc2 = 1 / (1 - b2^t), the bias
// corrections' float32 reciprocals, computed on the host.
// Every operation is one IEEE float32 rounding, spelled with the _rn
// intrinsics and built with -fmad=false, so the kernel is bitwise the plain
// foreach version on the same inputs. m, v and p are written in place:
// u is rounded to f32 before p + u (optax's update, then apply_updates).
//
// What bounds it on an H100: bytes. It reads g, m, v, p and writes m, v, p
// once, 28 bytes per element: 28.19 GB for the 1,006,708,224 elements of
// the 760m preset, 8.41 ms at 3.35 TB/s. Design for that:
// - One launch for up to kMaxLeaves leaves (a multi-tensor launch): the
//   leaves' pointers and sizes travel in the kernel's parameters (22.5 KB,
//   within the 32 KB a kernel takes under CUDA >= 12.1), so nothing is
//   uploaded and nothing syncs with the host; gradient pointers change
//   every step and the table is built anew for each call.
// - A block owns kChunk consecutive elements of one leaf and finds its leaf
//   by a binary search over the leaves' first blocks; each thread moves
//   16 bytes per load (float4) where all four pointers are 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include <memory>

namespace {

constexpr int kMaxLeaves = 512;
constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 4 * 4;  // elements per block: 4 float4 per thread

struct Leaf {
  const float* g;
  float* m;
  float* v;
  float* p;
  long long n;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int block0[kMaxLeaves + 1];  // first block of each leaf; block0[count] = blocks
  int count;
};

struct Hyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd, neg_lr, ibc1, ibc2;
};

__device__ __forceinline__ void adamw(float g, float& m, float& v, float& p, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.ibc2)), h.eps);
  float u = __fdiv_rn(__fmul_rn(m, h.ibc1), den);
  u = __fmul_rn(__fadd_rn(u, __fmul_rn(p, h.wd)), h.neg_lr);
  p = __fadd_rn(p, u);
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const __grid_constant__ Table t, const Hyper h) {
  const int blk = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last leaf whose first block <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block0[mid] <= blk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long e0 = (long long)(blk - t.block0[lo]) * kChunk;
  const long long e1 = e0 + kChunk < L.n ? e0 + kChunk : L.n;
  const bool vec = ((reinterpret_cast<uintptr_t>(L.g) | reinterpret_cast<uintptr_t>(L.m) |
                     reinterpret_cast<uintptr_t>(L.v) | reinterpret_cast<uintptr_t>(L.p)) &
                    15) == 0;
  long long tail = e0;
  if (vec) {
    const long long n4 = (e1 - e0) >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(L.g + e0);
    float4* m4 = reinterpret_cast<float4*>(L.m + e0);
    float4* v4 = reinterpret_cast<float4*>(L.v + e0);
    float4* p4 = reinterpret_cast<float4*>(L.p + e0);
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      const float4 g = g4[i];
      float4 m = m4[i], v = v4[i], p = p4[i];
      adamw(g.x, m.x, v.x, p.x, h);
      adamw(g.y, m.y, v.y, p.y, h);
      adamw(g.z, m.z, v.z, p.z, h);
      adamw(g.w, m.w, v.w, p.w, h);
      m4[i] = m;
      v4[i] = v;
      p4[i] = p;
    }
    tail = e0 + 4 * n4;
  }
  for (long long e = tail + threadIdx.x; e < e1; e += kThreads) {
    float m = L.m[e], v = L.v[e], p = L.p[e];
    adamw(L.g[e], m, v, p, h);
    L.m[e] = m;
    L.v[e] = v;
    L.p[e] = p;
  }
}

}  // namespace

// One AdamW step over `count` float32 leaves, in place: g[i], m[i], v[i],
// p[i] point at n[i] contiguous elements each. Launches one kernel per
// kMaxLeaves leaves on `stream` and returns the first launch error (or
// cudaErrorInvalidValue for a count or size it does not take); *launches
// receives the number of kernels launched.
extern "C" int fused_adamw_launch(const void* const* g, void* const* m, void* const* v,
                                  void* const* p, const long long* n, int count, float b1,
                                  float one_minus_b1, float b2, float one_minus_b2, float eps,
                                  float wd, float neg_lr, float ibc1, float ibc2, void* stream,
                                  int* launches) {
  *launches = 0;
  if (count < 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, one_minus_b1, b2, one_minus_b2, eps, wd, neg_lr, ibc1, ibc2};
  // 22.5 KB, on the heap: copied into the launch's parameters at the launch
  const std::unique_ptr<Table> table(new Table);
  Table& t = *table;
  for (int first = 0; first < count; first += kMaxLeaves) {
    const int k = count - first < kMaxLeaves ? count - first : kMaxLeaves;
    long long blocks = 0;
    t.count = 0;
    for (int i = 0; i < k; ++i) {
      const long long ni = n[first + i];
      if (ni < 0) return (int)cudaErrorInvalidValue;
      if (ni == 0) continue;
      Leaf& L = t.leaf[t.count];
      L.g = static_cast<const float*>(g[first + i]);
      L.m = static_cast<float*>(m[first + i]);
      L.v = static_cast<float*>(v[first + i]);
      L.p = static_cast<float*>(p[first + i]);
      L.n = ni;
      t.block0[t.count] = (int)blocks;
      blocks += (ni + kChunk - 1) / kChunk;
      if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
      ++t.count;
    }
    if (t.count == 0) continue;
    t.block0[t.count] = (int)blocks;
    adamw_kernel<<<(unsigned)blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(t, h);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
  }
  return 0;
}
