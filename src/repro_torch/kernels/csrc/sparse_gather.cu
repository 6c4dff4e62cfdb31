// Embedding bag (weighted sparse gather-sum) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_gather.py
// (sparse_gather_sum / _gather_kernel): for every output row i,
//
//   out[i] = sum_{j < bag} w[i, j] * table[idx[i, j]]
//
// with table (V, D) f32 or bf16, idx (N, bag) int32, w (N, bag) f32, the
// products and the sum in f32 and one cast of the sum to the table's dtype.
// An index follows JAX's gather: a negative one wraps once (idx + V), then
// it clamps to [0, V - 1]. The contract is kernels/ref.py::
// sparse_gather_sum_ref; kernels/sparse_gather.py::sparse_gather_sum_plain
// walks the bag in this kernel's order.
//
// Bound on an H100: bytes. Every gathered row is read once and nothing is
// reused unless a row repeats, so the least time is the rows the indices
// name (D * elem bytes each) plus idx, w and out, over 3.35 TB/s: at
// MLPerf DLRM-DCNv2's largest tables (128 wide, multi-hot bags of 100),
// N = 8192 bags of f32 rows gather 8192 * 100 * 512 B = 419 MB, ~0.125 ms.
// The flops (2 * N * bag * D) are ~1/4 flop per byte.
//
// Design (simple and correct first). The Pallas kernel ran one bag position
// per grid step, a row DMA'd into VMEM and added to a VMEM accumulator; on
// the card every row is independent, so:
//   * a warp per output row, four rows per block; the lanes stride across D
//     with 16-byte loads where the rows allow them (D % 4 == 0 for f32,
//     D % 8 == 0 for bf16, a 16-byte aligned table) and scalar loads
//     otherwise (the DLRM example's 16-wide table is vectorised; a ragged D
//     is not);
//   * each lane loads 32 of the bag's indices and weights at a time and the
//     warp passes them around with shuffles; the bag is walked in order,
//     j = 0 .. bag - 1, the f32 accumulators stay in registers and each
//     product is one fmaf in f32. One cast row is written per output;
//   * table offsets are 64-bit: a 40M x 128 table holds 5.1e9 elements;
//   * no shared memory, no atomics: a call is bit-reproducible;
//   * planted fault: skip_last != 0 drops bag position bag - 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // output rows per block, one warp each

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* table;
  const int* idx;
  const float* w;
  void* out;
  long long V;
  int D, N;
  int bag;     // positions walked: the bag, less one under skip_last
  int stride;  // the row stride of idx and w: the full bag
};

// JAX's gather index: a negative index wraps once, then clamps.
__device__ __forceinline__ long long table_row(int i, long long V) {
  long long r = i;
  if (r < 0) r += V;
  return r < 0 ? 0 : (r >= V ? V - 1 : r);
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float* x) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
  if constexpr (VEC == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  } else {
    x[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
  if constexpr (VEC == 8) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    *p = __float2bfloat16(x[0]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32) bag_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.N) return;  // whole warps leave together
  const T* table = static_cast<const T*>(a.table);
  const int* idx = a.idx + (size_t)row * a.stride;
  const float* w = a.w + (size_t)row * a.stride;
  T* out = static_cast<T*>(a.out) + (size_t)row * a.D;
  const int nvec = a.D / VEC;  // VEC divides D (VEC == 1 when it does not)

  // the column loop is warp-uniform, so every lane takes part in the
  // shuffles; lanes past the row's last column only skip the loads
  for (int c0 = 0; c0 < nvec; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < nvec;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < a.bag; j0 += 32) {
      const int jn = min(32, a.bag - j0);
      long long my_row = 0;
      float my_w = 0.f;
      if (lane < jn) {
        my_row = table_row(idx[j0 + lane], a.V);
        my_w = w[j0 + lane];
      }
#pragma unroll 4
      for (int jj = 0; jj < jn; ++jj) {
        const long long r = __shfl_sync(0xffffffffu, my_row, jj);
        const float wt = __shfl_sync(0xffffffffu, my_w, jj);
        if (live) {
          float x[VEC];
          load<VEC>(table + r * a.D + (size_t)c * VEC, x);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wt, x[e], acc[e]);
        }
      }
    }
    if (live) store<VEC>(out + (size_t)c * VEC, acc);
  }
}

template <typename T, int VEC>
int launch(const Args& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.N + kWarps - 1) / kWarps);
  bag_kernel<T, VEC><<<blocks, kWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t. table: (V, D) device pointer of `dtype` (0 f32,
// 1 bf16), contiguous; idx (N, bag) int32 and w (N, bag) f32, contiguous;
// out (N, D) of the table's dtype. skip_last != 0 drops bag position
// bag - 1 (a planted fault). Asynchronous on `stream`.
extern "C" int sparse_gather_sum(int dtype, const void* table, const int* idx,
                                 const float* w, void* out, long long V,
                                 int D, int N, int bag, int skip_last,
                                 void* stream) {
  if (N == 0 || D == 0) return 0;
  if (N < 0 || D < 0 || bag < 0 || V < 1) return (int)cudaErrorInvalidValue;
  Args a{table, idx, w, out, V, D, N, skip_last && bag > 0 ? bag - 1 : bag,
         bag};
  const bool aligned = reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      if (aligned && D % 4 == 0) return launch<float, 4>(a, s);
      return launch<float, 1>(a, s);
    case kBF16:
      if (aligned && D % 8 == 0) return launch<__nv_bfloat16, 8>(a, s);
      return launch<__nv_bfloat16, 1>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
