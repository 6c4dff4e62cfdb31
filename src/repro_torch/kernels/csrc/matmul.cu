// Tiled matrix product for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py (matmul /
// _matmul_kernel): out = a @ b for a (M, K) and b (K, N), row-major and
// contiguous, products and sums in fp32, the result cast to the output dtype
// (f32 or bf16) once, at the end. The contract is kernels/ref.py::matmul_ref,
// an fp32 dot of the inputs' values. The Pallas kernel needed its 256/256/512
// blocks to divide the operands (a TPU tiling rule); this one takes any M, N,
// K and masks the edges: elements past an edge load as zeros, which add
// exactly nothing to a sum, and outputs past an edge are not written.
//
// Bound on an H100: operations for the shapes the port runs. The startup
// self-test's 128^3 f32 products do 2 * 128^3 flops on 192 KB (~3.2e-5 ms at
// 67 TFLOP/s, ~6e-5 ms at 3.35 TB/s: bytes); qwen2-0.5B's MLP up projection of
// a 4096-token prefill, (4096, 896) x (896, 4864) in bf16, does 3.6e10 flops
// on 53 MB, 0.036 ms at 989 TFLOP/s against 0.016 ms of bytes.
//
// Design (simple and correct first; no wgmma or TMA yet):
//   * bf16: a block of 8 warps owns a 128 x 128 output tile and walks K in
//     tiles of 32; A (128 x 32) and B (32 x 128) tiles stream into shared
//     memory through cp.async 16-byte copies, double-buffered so the next
//     tile loads while this one is used (plain loads where a row is not a
//     whole number of 16-byte chunks); each warp owns 64 x 32 of the output
//     as 4 x 4 mma.sync m16n8k16 fragments (bf16 in, fp32 accumulation: the
//     bf16 products are exact in fp32), its A fragments read with ldmatrix
//     and its B fragments with ldmatrix.trans;
//   * f32: CUDA-core fmaf only, never TF32 (the reference's f32 dot keeps 24
//     mantissa bits; TF32 keeps 11 and fails its 1e-5 tolerance at K >= 512):
//     a block of 256 threads owns a 64 x 64 tile and walks K in tiles of 16;
//     each thread keeps a 4 x 4 register block of outputs;
//   * no split of K and no atomics: every output is summed over K in one
//     fixed order, so a call is bit-reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* a;
  const void* b;
  void* out;
  int M, N, K;
  int vec_a;  // rows of a are whole, aligned 16-byte chunks: cp.async
  int vec_b;  // the same for b
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLDA = kBK + 8;  // row strides (bf16) that keep ldmatrix's
constexpr int kLDB = kBN + 8;  // eight row addresses on distinct banks

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (16x8, fp32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of a 16 x 16 tile: four 8x8 matrices (rows 0-7 / 8-15 x
// columns 0-7 / 8-15); lane l gives row l % 16 at column (l / 16) * 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The B fragment of a 16 (k) x 8 (n) tile stored k-major: two 8x8 matrices,
// transposed; lanes 0-15 give rows k = 0..15.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// A rows [m0, m0 + kBM) x columns [k0, k0 + kBK) into shared memory.
__device__ __forceinline__ void load_a_bf16(const Args& p, __nv_bfloat16* dst,
                                            int m0, int k0) {
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(p.a);
  if (p.vec_a) {  // K % 8 == 0: a chunk is wholly inside or outside
    for (int i = threadIdx.x; i < kBM * kBK / 8; i += blockDim.x) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int row = m0 + r, col = k0 + c;
      const bool ok = row < p.M && col < p.K;
      cp_async16(dst + r * kLDA + c, ok ? a + (size_t)row * p.K + col : a,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += blockDim.x) {
      const int r = i / kBK, c = i % kBK;
      const int row = m0 + r, col = k0 + c;
      dst[r * kLDA + c] = (row < p.M && col < p.K)
                              ? a[(size_t)row * p.K + col]
                              : __float2bfloat16(0.f);
    }
  }
}

// B rows [k0, k0 + kBK) x columns [n0, n0 + kBN) into shared memory.
__device__ __forceinline__ void load_b_bf16(const Args& p, __nv_bfloat16* dst,
                                            int k0, int n0) {
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(p.b);
  if (p.vec_b) {  // N % 8 == 0
    for (int i = threadIdx.x; i < kBK * kBN / 8; i += blockDim.x) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
      const int row = k0 + r, col = n0 + c;
      const bool ok = row < p.K && col < p.N;
      cp_async16(dst + r * kLDB + c, ok ? b + (size_t)row * p.N + col : b,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kBN; i += blockDim.x) {
      const int r = i / kBN, c = i % kBN;
      const int row = k0 + r, col = n0 + c;
      dst[r * kLDB + c] = (row < p.K && col < p.N)
                              ? b[(size_t)row * p.N + col]
                              : __float2bfloat16(0.f);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(256) matmul_bf16_kernel(const Args p) {
  __shared__ __align__(128) __nv_bfloat16 as[2][kBM * kLDA];
  __shared__ __align__(128) __nv_bfloat16 bs[2][kBK * kLDB];

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // warp's 64 x 32
  const int g = lane >> 2, t = lane & 3;  // quad and lane in it

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_k = (p.K + kBK - 1) / kBK;
  if (n_k > 0) {
    load_a_bf16(p, as[0], m0, 0);
    load_b_bf16(p, bs[0], 0, n0);
  }
  cp_async_commit();
  for (int it = 0; it < n_k; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_k) {  // the next tile streams in while this one runs
      load_a_bf16(p, as[buf ^ 1], m0, (it + 1) * kBK);
      load_b_bf16(p, bs[buf ^ 1], (it + 1) * kBK, n0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const __nv_bfloat16* at = as[buf];
    const __nv_bfloat16* bt = bs[buf];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(af[i], at + (wm + i * 16 + (lane & 15)) * kLDA + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x2_trans(bf[j], bt + (kk * 16 + (lane & 15)) * kLDB + wn + j * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();  // the buffer is free for the load two tiles ahead
  }
  cp_async_wait<0>();

  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + t * 2 + (e & 1);
        if (row < p.M && col < p.N)
          store(out + (size_t)row * p.N + col, acc[i][j][e]);
      }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, a 4 x 4 register block per thread
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;

template <typename OutT>
__global__ void __launch_bounds__(256) matmul_f32_kernel(const Args p) {
  __shared__ float as[kFK][kFM + 1];  // A transposed: k-major
  __shared__ float bs[kFK][kFN];

  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // this thread's outputs: rows m0 + ty + 16 i, columns n0 + tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kFK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kFM * kFK; i += blockDim.x) {
      const int r = i / kFK, c = i % kFK;
      const int row = m0 + r, col = k0 + c;
      as[c][r] = (row < p.M && col < p.K) ? a[(size_t)row * p.K + col] : 0.f;
    }
    for (int i = tid; i < kFK * kFN; i += blockDim.x) {
      const int r = i / kFN, c = i % kFN;
      const int row = k0 + r, col = n0 + c;
      bs[r][c] = (row < p.K && col < p.N) ? b[(size_t)row * p.N + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < p.M && col < p.N)
        store(out + (size_t)row * p.N + col, acc[i][j]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kern, const Args& p, int bm, int bn, cudaStream_t s) {
  const dim3 grid((p.N + bn - 1) / bn, (p.M + bm - 1) / bm);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. a (M, K) and b (K, N) are
// device pointers to contiguous row-major matrices of `in_dtype`, out (M, N)
// of `out_dtype` (0 f32, 1 bf16). K may be 0 (out is zeros). Asynchronous on
// `stream`.
extern "C" int matmul(int in_dtype, int out_dtype, const void* a,
                      const void* b, void* out, int M, int N, int K,
                      void* stream) {
  if (M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  Args p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.vec_a = K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  p.vec_b = N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16 && out_dtype == kF32)
    return launch(matmul_bf16_kernel<float>, p, kBM, kBN, s);
  if (in_dtype == kBF16 && out_dtype == kBF16)
    return launch(matmul_bf16_kernel<__nv_bfloat16>, p, kBM, kBN, s);
  if (in_dtype == kF32 && out_dtype == kF32)
    return launch(matmul_f32_kernel<float>, p, kFM, kFN, s);
  if (in_dtype == kF32 && out_dtype == kBF16)
    return launch(matmul_f32_kernel<__nv_bfloat16>, p, kFM, kFN, s);
  return (int)cudaErrorInvalidValue;
}
