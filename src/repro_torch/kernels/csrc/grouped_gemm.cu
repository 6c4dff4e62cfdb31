// m-grouped MoE GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/moe_gemm.py:
//   grouped_matmul (bodies _grouped_kernel and _grouped_kernel_scaled)
// out[r, :] = x[r, :] @ w[g] (* w_scale[g]) for every row r of an m-tile
// whose expert id is g = group_ids[r / block_m]; a tile with id -1 writes
// zeros. x (M, D) holds the token rows sorted by expert and padded so that
// each m-tile belongs to one expert; w is (E, D, F); out is (M, F) in x's
// dtype. block_m = M / len(group_ids) may be anything the plan gives.
//
// Bound on an H100: memory, at serving shapes. A decode step routes a few
// tokens to at most a few experts, so the kernel must stream every touched
// expert's (D, F) matrix once (201 MB in bf16 at Mixtral's 6144 x 16384)
// and does ~2 * rows flops per weight element, far below the ~295 flop/byte
// ridge; a 128-token prefill chunk (~32 rows per expert) is still below it.
//
// Design (simple and correct first; no wgmma or TMA yet):
//   * the TPU grid (m-tile, F-tile) would re-read an expert's weights once
//     per m-tile; here a block owns one F-tile (128 columns) of a *segment*:
//     up to MT consecutive rows of one expert (the expert's tiles are
//     contiguous in the plan). It streams the weight tile once and applies
//     it to all the segment's rows, so each expert's weights are read once
//     per F-tile as long as the expert has at most MT rows (MT = 64 for
//     bf16, 32 for f32); an expert with more rows is read once per MT rows.
//   * the grid is (m-tile, F-tile, row chunk); a block whose m-tile does not
//     start a segment exits at once. Its block finds the run of equal ids
//     that its tile lies in with one parallel scan over group_ids.
//   * the K loop stages 16-byte loads of the next K-tile in registers while
//     the current one is multiplied from shared memory (double buffer, one
//     barrier per K-tile); int8 weights convert in registers on the way.
//   * bf16 activations: tensor cores (wmma 16x16x16 bf16, f32 accumulation)
//     over bf16 weights, or int8 weights converted to bf16 (|q| <= 127 is
//     exact in bf16), so the product times the per-expert scale equals the
//     reference's f32 dot up to summation order. f32 activations: f32 FMAs
//     on CUDA cores over f32 or int8 weights, exact to f32 rounding.
//   * warps whose rows lie past the segment skip their products, so an
//     8-row decode segment costs the bytes of its weights and little else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr int kThreads = 256;
constexpr int kBN = 128;  // output columns per block

struct Args {
  const void* x;
  const void* w;
  const int* gids;
  const float* scale;  // (E,) or null
  void* out;
  int M, D, E, F, nb, bm;
  int vec_x, vec_w;  // rows 16-byte aligned: 16-byte loads allowed
};

// The block's rows: [r_lo, r_lo + nrows) of expert g (-1: zeros).
struct Segment {
  int g, r_lo, nrows;
};

// Whether this block owns a segment, and which. Every thread returns the
// same answer (the branch on it is block-uniform).
template <int MT>
__device__ bool find_segment(const Args& a, Segment& s) {
  __shared__ int s_hit;
  __shared__ int s_tiles;
  const int i = blockIdx.x;
  const int gi = a.gids[i];
  if (threadIdx.x == 0) s_hit = -1;
  __syncthreads();
  // run start: one past the last tile before i with another id
  for (int base = i - 1; base >= 0; base -= kThreads) {
    const int j = base - (int)threadIdx.x;
    const bool hit = j >= 0 && a.gids[j] != gi;
    if (hit) atomicMax(&s_hit, j);
    if (__syncthreads_or(hit)) break;
  }
  const int run_start = s_hit + 1;
  const int seg_tiles = MT >= a.bm ? MT / a.bm : 1;
  if ((i - run_start) % seg_tiles != 0) return false;
  if (threadIdx.x == 0) {
    int n = 1;
    while (n < seg_tiles && i + n < a.nb && a.gids[i + n] == gi) ++n;
    s_tiles = n;
  }
  __syncthreads();
  const int rows = s_tiles * a.bm;
  s.r_lo = i * a.bm + blockIdx.z * MT;
  s.nrows = min(MT, rows - (int)blockIdx.z * MT);
  s.g = gi < 0 ? -1 : min(gi, a.E - 1);  // ids past E clamp, as a gather
  return s.nrows > 0;
}

template <typename OT>
__device__ __forceinline__ OT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename OT>
__device__ void zero_fill(const Args& a, const Segment& s, int f0) {
  OT* out = static_cast<OT*>(a.out);
  const int cols = min(kBN, a.F - f0);
  for (int idx = threadIdx.x; idx < s.nrows * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (c < cols) out[(size_t)(s.r_lo + r) * a.F + f0 + c] = from_f<OT>(0.f);
  }
}

// 16 bytes of row `row`, columns [col, col + 16 / sizeof(T)) of a row-major
// matrix with leading dimension ld; rows >= nrows and columns >= ncols read
// as zero.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* base, int ld, int row,
                                        int nrows, int col, int ncols,
                                        bool vec) {
  constexpr int V = 16 / sizeof(T);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row >= nrows) return r;
  const T* p = base + (size_t)row * ld + col;
  if (vec && col + V <= ncols) return __ldg(reinterpret_cast<const uint4*>(p));
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (col + k < ncols) e[k] = p[k];
  return r;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// ---------------------------------------------------------------- bf16 path
//
// Block tile 64 rows x 128 columns, K-tile 64; 8 warps as 2 (rows) x 4
// (columns), each owning 32 x 32 outputs as 2 x 2 wmma fragments.

namespace mma_path {

constexpr int MT = 64, BK = 64;
constexpr int LDX = BK + 8;    // bf16 elements; rows stay 32-byte aligned
constexpr int LDW = kBN + 8;
constexpr int LDC = kBN + 4;   // f32 epilogue tile
constexpr int X_STAGE = MT * LDX;       // elements
constexpr int W_STAGE = BK * LDW;
constexpr int STAGE = X_STAGE + W_STAGE;
constexpr size_t SMEM = 2 * STAGE * sizeof(__nv_bfloat16);
static_assert(MT * LDC * sizeof(float) <= SMEM, "epilogue fits");

constexpr int X_CHUNKS = MT * BK / 8 / kThreads;  // 16-byte chunks/thread

template <typename WT>
struct WLoad {
  static constexpr int V = 16 / sizeof(WT);  // elements per chunk
  static constexpr int PER_ROW = kBN / V;
  static constexpr int CHUNKS = BK * kBN / V / kThreads;
};

__device__ __forceinline__ void put(__nv_bfloat16* dst, const uint4& raw,
                                    __nv_bfloat16) {
  *reinterpret_cast<uint4*>(dst) = raw;
}
__device__ __forceinline__ void put(__nv_bfloat16* dst, const uint4& raw,
                                    int8_t) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) __nv_bfloat16 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = __float2bfloat16((float)q[k]);
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(v)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(v)[1];
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) kernel(Args a) {
  using namespace nvcuda;
  using L = WLoad<WT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  Segment s;
  if (!find_segment<MT>(a, s)) return;
  const int f0 = blockIdx.y * kBN;
  if (s.g < 0) {
    zero_fill<__nv_bfloat16>(a, s, f0);
    return;
  }
  const __nv_bfloat16* X =
      static_cast<const __nv_bfloat16*>(a.x) + (size_t)s.r_lo * a.D;
  const WT* W = static_cast<const WT*>(a.w) + (size_t)s.g * a.D * a.F + f0;
  const int fcols = a.F - f0;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;

  uint4 xr[X_CHUNKS], wr[L::CHUNKS];
  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < X_CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      xr[c] = load16(X + k0, a.D, q / (BK / 8), s.nrows, (q % (BK / 8)) * 8,
                     a.D - k0, a.vec_x);
    }
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      wr[c] = load16(W + (size_t)k0 * a.F, a.F, q / L::PER_ROW, a.D - k0,
                     (q % L::PER_ROW) * L::V, fcols, a.vec_w);
    }
  };
  auto store = [&](int stage) {
    __nv_bfloat16* xs = sm + stage * STAGE;
    __nv_bfloat16* ws = xs + X_STAGE;
#pragma unroll
    for (int c = 0; c < X_CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      put(xs + (q / (BK / 8)) * LDX + (q % (BK / 8)) * 8, xr[c],
          __nv_bfloat16());
    }
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      put(ws + (q / L::PER_ROW) * LDW + (q % L::PER_ROW) * L::V, wr[c],
          WT());
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) wmma::fill_fragment(acc[mi][ni], 0.f);
  // fragments of this warp holding rows of the segment (warp-uniform)
  const int live_m = min(2, max(0, (s.nrows - wm * 32 + 15) / 16));

  const int nk = (a.D + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);
    if (live_m > 0) {
      const __nv_bfloat16* xs = sm + (kt & 1) * STAGE;
      const __nv_bfloat16* ws = xs + X_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[2];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          wmma::load_matrix_sync(bf[ni], ws + kk * LDW + wn * 32 + ni * 16,
                                 LDW);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi >= live_m) break;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::load_matrix_sync(af, xs + (wm * 32 + mi * 16) * LDX + kk,
                                 LDX);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            wmma::mma_sync(acc[mi][ni], af, bf[ni], acc[mi][ni]);
        }
      }
    }
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  // epilogue through shared memory: scale, convert, masked coalesced stores
  float* cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    if (mi >= live_m) break;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::store_matrix_sync(cs + (wm * 32 + mi * 16) * LDC + wn * 32 +
                                  ni * 16,
                              acc[mi][ni], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  const float sc = a.scale ? a.scale[s.g] : 1.f;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int cols = min(kBN, fcols);
  for (int idx = tid; idx < s.nrows * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (c < cols)
      out[(size_t)(s.r_lo + r) * a.F + f0 + c] =
          __float2bfloat16(cs[r * LDC + c] * sc);
  }
}

}  // namespace mma_path

// ----------------------------------------------------------------- f32 path
//
// Block tile 32 rows x 128 columns, K-tile 32; thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3 and columns tx + 32 j (j < 4): a warp shares its rows
// (broadcast reads of x) and reads 32 consecutive weight columns.

namespace fma_path {

constexpr int MT = 32, BK = 32;
constexpr int X_STAGE = BK * MT;  // x transposed: [k][row]
constexpr int W_STAGE = BK * kBN;
constexpr int STAGE = X_STAGE + W_STAGE;
constexpr size_t SMEM = 2 * STAGE * sizeof(float);

template <typename WT>
struct WLoad {
  static constexpr int V = 16 / sizeof(WT);
  static constexpr int PER_ROW = kBN / V;
  static constexpr int CHUNKS = BK * kBN / V / kThreads;
};

template <typename WT>
__global__ void __launch_bounds__(kThreads) kernel(Args a) {
  using L = WLoad<WT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);

  Segment s;
  if (!find_segment<MT>(a, s)) return;
  const int f0 = blockIdx.y * kBN;
  if (s.g < 0) {
    zero_fill<float>(a, s, f0);
    return;
  }
  const float* X = static_cast<const float*>(a.x) + (size_t)s.r_lo * a.D;
  const WT* W = static_cast<const WT*>(a.w) + (size_t)s.g * a.D * a.F + f0;
  const int fcols = a.F - f0;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  static_assert(MT * BK / 4 == kThreads, "one x chunk per thread");

  uint4 xr, wr[L::CHUNKS];
  auto load = [&](int k0) {
    xr = load16(X + k0, a.D, tid / (BK / 4), s.nrows, (tid % (BK / 4)) * 4,
                a.D - k0, a.vec_x);
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      wr[c] = load16(W + (size_t)k0 * a.F, a.F, q / L::PER_ROW, a.D - k0,
                     (q % L::PER_ROW) * L::V, fcols, a.vec_w);
    }
  };
  auto store = [&](int stage) {
    float* xs = sm + stage * STAGE;
    float* ws = xs + X_STAGE;
    const float* xv = reinterpret_cast<const float*>(&xr);
    const int row = tid / (BK / 4), col = (tid % (BK / 4)) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[(col + e) * MT + row] = xv[e];
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      float* dst = ws + (q / L::PER_ROW) * kBN + (q % L::PER_ROW) * L::V;
      const WT* e = reinterpret_cast<const WT*>(&wr[c]);
#pragma unroll
      for (int k = 0; k < L::V; ++k) dst[k] = to_f(e[k]);
    }
  };

  float acc[4][4] = {};
  const bool live = ty * 4 < s.nrows;  // warp-uniform
  const int nk = (a.D + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);
    if (live) {
      const float* xs = sm + (kt & 1) * STAGE;
      const float* ws = xs + X_STAGE;
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + k * MT + ty * 4);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wv = ws[k * kBN + tx + 32 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(xa[r], wv, acc[r][j]);
        }
      }
    }
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  const float sc = a.scale ? a.scale[s.g] : 1.f;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= s.nrows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 32 * j;
      if (c < fcols)
        out[(size_t)(s.r_lo + row) * a.F + f0 + c] = acc[r][j] * sc;
    }
  }
}

}  // namespace fma_path

template <typename K>
int launch(K kernel, size_t smem, int mt, const Args& a, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.nb, (a.F + kBN - 1) / kBN,
                  a.bm > mt ? (a.bm + mt - 1) / mt : 1);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. Device pointers to
// contiguous tensors: x (M, D) of x_dtype (f32 or bf16); w (E, D, F) of
// w_dtype (x_dtype or int8); group_ids (nb,) int32 with M % nb == 0;
// w_scale (E,) f32 or null; out (M, F) of x_dtype. Asynchronous on
// `stream`; allocates nothing.
extern "C" int grouped_matmul(int x_dtype, int w_dtype, const void* x,
                              const void* w, const void* group_ids,
                              const void* w_scale, void* out, int M, int D,
                              int E, int F, int nb, void* stream) {
  if (M <= 0 || nb <= 0 || M % nb != 0 || D <= 0 || E <= 0 || F <= 0 ||
      (F + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  if (w_dtype != x_dtype && w_dtype != kI8) return (int)cudaErrorInvalidValue;
  const int xe = x_dtype == kF32 ? 4 : 2;
  const int we = w_dtype == kF32 ? 4 : w_dtype == kBF16 ? 2 : 1;
  Args a;
  a.x = x;
  a.w = w;
  a.gids = static_cast<const int*>(group_ids);
  a.scale = static_cast<const float*>(w_scale);
  a.out = out;
  a.M = M; a.D = D; a.E = E; a.F = F; a.nb = nb; a.bm = M / nb;
  a.vec_x = (D * xe) % 16 == 0 && aligned16(x);
  a.vec_w = (F * we) % 16 == 0 && aligned16(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16) {
    if (w_dtype == kI8)
      return launch(mma_path::kernel<int8_t>, mma_path::SMEM, mma_path::MT,
                    a, st);
    return launch(mma_path::kernel<__nv_bfloat16>, mma_path::SMEM,
                  mma_path::MT, a, st);
  }
  if (x_dtype == kF32) {
    if (w_dtype == kI8)
      return launch(fma_path::kernel<int8_t>, fma_path::SMEM, fma_path::MT,
                    a, st);
    return launch(fma_path::kernel<float>, fma_path::SMEM, fma_path::MT, a,
                  st);
  }
  return (int)cudaErrorInvalidValue;
}
