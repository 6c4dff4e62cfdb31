// Flash attention (forward) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel): blockwise online-softmax attention of
// q (BH, Sq, D) over k, v (BH, Sk, D), heads folded into the leading
// dimension; Sk may differ from Sq only for bidirectional attention (an
// encoder-decoder's cross-attention). For every query row i and key j, the
// score is q_i . k_j / sqrt(D) in fp32; the mask is positional
// (causal: j <= i; window w: i - j < w; bidirectional: none) and masked
// scores are -1e30, as in the reference; the softmax runs online over key
// tiles with fp32 running (max m, sum l, accumulator acc); the probabilities
// enter the PV product in v's dtype; the output is acc / max(l, 1e-30) in q's
// dtype.
//
// Bound on an H100: operations. A causal S = 2048, D = 64 call does
// 4 * D * S * (S + 1) / 2 flops per head against 4 * S * D * 2 bytes moved,
// ~510 flop/byte for bf16, so at the training shape (BH = 56) the least time
// is ~0.03 ms at 989 TFLOP/s (bf16 tensor cores) and ~0.45 ms for f32 on the
// CUDA cores (67 TFLOP/s).
//
// Design (simple and correct first; no wgmma or TMA yet):
//   * one block per (bh, tile of 64 query rows); the grid walks the tiles
//     from the last one, so the causal tiles with the most keys start first;
//   * a block streams only the key tiles some of its rows may see (causal:
//     up to its last row; window: from its first row's window start). Tiles
//     wholly masked for a row add nothing in the reference either: before a
//     row's first valid key, the correction exp(-1e30 - m) at that key is
//     exactly 0 in fp32 and wipes them; after its last one, their own
//     probabilities exp(-1e30 - m) are 0;
//   * bf16: four warps, each owning 16 query rows; K and V tiles of 64 keys
//     (32 at D > 128) stream into shared memory through cp.async 16-byte
//     copies, double-buffered so the next tile loads while this one is used;
//     S = Q K^T and acc += P V run on the tensor cores with warp-level
//     mma.sync m16n8k16 (bf16 in, fp32 accumulation, which is exact against
//     the reference's fp32 dot of bf16 values up to summation order); the
//     scores, the online softmax state and the accumulator stay in
//     registers: each thread of a quad owns two rows of every 16 x 8
//     fragment, so a row's max and sum are quad shuffles, and the score
//     fragments become the A operand of the PV product without touching
//     shared memory (FlashAttention-2's layout). V's B fragments are read
//     with ldmatrix.trans;
//   * f32: 64 rows x 4 threads; each thread holds a quarter of its row's
//     query and accumulator in registers, the fp32 dot over D is a quad
//     shuffle reduction, and K and V tiles of 32 keys sit in fp32 shared
//     memory (CUDA-core products, exact to fp32 rounding);
//   * no atomics and no split of the key range: every output element is
//     summed in one fixed order, so a call is bit-reproducible;
//   * D from 1 to 256, zero-padded in shared memory to 16, 32, 64, 128 or
//     256; any Sq and Sk (keys past Sk carry no weight, rows past Sq are not
//     written);
//   * planted fault: the wrapper may pass kv_len = Sk - 1, so the kernel
//     reads rows of Sk keys but weighs only the first Sk - 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kBlockQ = 64;        // query rows per block
constexpr size_t kSmemMax = 232448;  // an H100 block's opt-in maximum

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int BH, Sq, D;
  int Sk;     // keys in a row of k and v (the row stride)
  int kv_len;  // keys that carry weight: Sk, or less for a planted fault
  int causal;  // 1: key position <= query position
  int window;  // > 0: query position - key position < window
  float scale;
  int vec;  // rows 16-byte aligned: cp.async / float4 loads
};

__device__ __forceinline__ bool allowed(const Args& a, int qp, int kp) {
  return (!a.causal || kp <= qp) && (a.window <= 0 || qp - kp < a.window);
}

// Key tiles [t_begin, t_end) of size kt that rows [q0, q0 + kBlockQ) of a
// block may see.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int kt,
                                           int& t_begin, int& t_end) {
  const int q1 = min(q0 + kBlockQ, a.Sq);
  const int hi = a.causal ? q1 : a.kv_len;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  t_begin = lo / kt;
  t_end = (hi + kt - 1) / kt;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync, softmax in registers
// ---------------------------------------------------------------------------

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

// Two 8x8 bf16 matrices, transposed: rows are given by lanes 0-15.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + nrows) of an (S, D) bf16 matrix into shared memory
// (row stride ld); rows past S become zeros, columns past D are never
// written (zero since the block cleared its shared memory).
__device__ __forceinline__ void load_rows_bf16(const Args& a,
                                               __nv_bfloat16* dst, int ld,
                                               const __nv_bfloat16* src,
                                               int S, int row0, int nrows) {
  if (a.vec) {
    const int cpr = a.D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - (i / cpr) * cpr;
      const int row = row0 + r;
      const __nv_bfloat16* s = src + (size_t)min(row, S - 1) * a.D + c * 8;
      cp_async16(dst + r * ld + c * 8, s, row < S ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * a.D; i += blockDim.x) {
      const int r = i / a.D, c = i - (i / a.D) * a.D;
      const int row = row0 + r;
      dst[r * ld + c] =
          row < S ? src[(size_t)row * a.D + c] : __float2bfloat16(0.f);
    }
  }
}

template <int DP, int KT>
__global__ void __launch_bounds__(128) flash_bf16_kernel(const Args a) {
  constexpr int LD = DP + 8;  // row stride (bf16): conflict-free fragments
  constexpr int NT = DP / 8;  // 8-column output tiles of a warp
  constexpr int ST = KT / 8;  // 8-key score tiles of a warp
  constexpr bool kQInRegs = DP <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBlockQ * LD;  // 2 stages of KT x LD
  __nv_bfloat16* vs = ks + 2 * KT * LD;

  const int n_qt = (a.Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBlockQ;
  const size_t qbase = (size_t)blockIdx.y * a.Sq * a.D;
  const size_t kbase = (size_t)blockIdx.y * a.Sk * a.D;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + qbase;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + kbase;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + kbase;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + qbase;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // quad and lane in it
  const int row_a = q0 + warp * 16 + g;   // fragment rows of this thread
  const int row_b = row_a + 8;

  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    constexpr int n16 = (kBlockQ + 4 * KT) * LD * 2 / 16;
    for (int i = tid; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  int t_begin, t_end;
  tile_range(a, q0, KT, t_begin, t_end);
  load_rows_bf16(a, qs, LD, qg, a.Sq, q0, kBlockQ);
  if (t_begin < t_end) {
    load_rows_bf16(a, ks, LD, kg, a.Sk, t_begin * KT, KT);
    load_rows_bf16(a, vs, LD, vg, a.Sk, t_begin * KT, KT);
  }
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  uint32_t qf[kQInRegs ? DP / 16 : 1][4];
  const __nv_bfloat16* qw = qs + (warp * 16) * LD;

  for (int it = t_begin; it < t_end; ++it) {
    const int buf = (it - t_begin) & 1;
    if (it + 1 < t_end) {  // the next tile streams in while this one runs
      load_rows_bf16(a, ks + (buf ^ 1) * KT * LD, LD, kg, a.Sk, (it + 1) * KT,
                     KT);
      load_rows_bf16(a, vs + (buf ^ 1) * KT * LD, LD, vg, a.Sk, (it + 1) * KT,
                     KT);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and this tile have landed
    __syncthreads();
    const __nv_bfloat16* kt = ks + buf * KT * LD;
    const __nv_bfloat16* vt = vs + buf * KT * LD;
    const int k0 = it * KT;

    if (kQInRegs && it == t_begin) {
#pragma unroll
      for (int kk = 0; kk < (kQInRegs ? DP / 16 : 1); ++kk) {
        qf[kk][0] = lds32(qw + g * LD + kk * 16 + t * 2);
        qf[kk][1] = lds32(qw + (g + 8) * LD + kk * 16 + t * 2);
        qf[kk][2] = lds32(qw + g * LD + kk * 16 + 8 + t * 2);
        qf[kk][3] = lds32(qw + (g + 8) * LD + kk * 16 + 8 + t * 2);
      }
    }

    // raw scores S = Q K^T of this warp's 16 rows x KT keys
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t af[4];
      if (kQInRegs) {
        af[0] = qf[kQInRegs ? kk : 0][0];
        af[1] = qf[kQInRegs ? kk : 0][1];
        af[2] = qf[kQInRegs ? kk : 0][2];
        af[3] = qf[kQInRegs ? kk : 0][3];
      } else {
        af[0] = lds32(qw + g * LD + kk * 16 + t * 2);
        af[1] = lds32(qw + (g + 8) * LD + kk * 16 + t * 2);
        af[2] = lds32(qw + g * LD + kk * 16 + 8 + t * 2);
        af[3] = lds32(qw + (g + 8) * LD + kk * 16 + 8 + t * 2);
      }
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        uint32_t bf[2];
        bf[0] = lds32(kt + (j * 8 + g) * LD + kk * 16 + t * 2);
        bf[1] = lds32(kt + (j * 8 + g) * LD + kk * 16 + 8 + t * 2);
        mma_bf16(s[j], af, bf);
      }
    }

    // scale and mask; the row max over the quad
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + t * 2 + (e & 1);
        const int qp = e < 2 ? row_a : row_b;
        float x = -INFINITY;  // past the keys: no weight at all
        if (kp < a.kv_len)
          x = allowed(a, qp, kp) ? s[j][e] * a.scale : kNegInf;
        s[j][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // p = exp(s - m), the row sums (this thread's share), P as bf16 A
    // fragments: score tiles 2kk and 2kk+1 are the 16 keys of PV step kk
    float ls_a = 0.f, ls_b = 0.f;
    uint32_t pf[KT / 16][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      const float p0 = expf(s[j][0] - mn_a), p1 = expf(s[j][1] - mn_a);
      const float p2 = expf(s[j][2] - mn_b), p3 = expf(s[j][3] - mn_b);
      ls_a += p0 + p1;
      ls_b += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * corr_a + ls_a;
    l_b = l_b * corr_b + ls_b;

#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bv[2];
        ldsm_x2_trans(bv, vt + (kk * 16 + (lane & 15)) * LD + n * 8);
        mma_bf16(acc[n], pf[kk], bv);
      }
    }
    __syncthreads();  // the buffer is free for the load two tiles ahead
  }
  cp_async_wait<0>();

  // the quad's shares of l, then out = acc / max(l, 1e-30)
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + t * 2 + (e & 1);
      const int row = e < 2 ? row_a : row_b;
      if (col < a.D && row < a.Sq)
        og[(size_t)row * a.D + col] =
            __float2bfloat16(acc[n][e] / (e < 2 ? den_a : den_b));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, four threads per query row
// ---------------------------------------------------------------------------

// Rows [row0, row0 + nrows) of an (S, D) f32 matrix into shared memory (row
// stride DP); rows past S become zeros, padding columns stay zero.
template <int DP>
__device__ __forceinline__ void load_rows_f32(const Args& a, float* dst,
                                              const float* src, int S,
                                              int row0, int nrows) {
  if (a.vec) {
    const int cpr = a.D / 4;
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = i - (i / cpr) * cpr;
      const int row = row0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < S)
        x = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * a.D) +
                  c);
      *reinterpret_cast<float4*>(dst + r * DP + c * 4) = x;
    }
  } else {
    for (int i = threadIdx.x; i < nrows * a.D; i += blockDim.x) {
      const int r = i / a.D, c = i - (i / a.D) * a.D;
      const int row = row0 + r;
      dst[r * DP + c] = row < S ? src[(size_t)row * a.D + c] : 0.f;
    }
  }
}

template <int DP, int KT>
__global__ void __launch_bounds__(256) flash_f32_kernel(const Args a) {
  constexpr int NPT = DP / 4;  // dims per thread: d = c + 4 * i
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // KT x DP
  float* vs = ks + KT * DP;

  const int n_qt = (a.Sq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBlockQ;
  const size_t qbase = (size_t)blockIdx.y * a.Sq * a.D;
  const size_t kbase = (size_t)blockIdx.y * a.Sk * a.D;
  const float* qg = static_cast<const float*>(a.q) + qbase;
  const float* kg = static_cast<const float*>(a.k) + kbase;
  const float* vg = static_cast<const float*>(a.v) + kbase;
  float* og = static_cast<float*>(a.out) + qbase;
  const int tid = threadIdx.x;
  const int c = tid & 3;
  const int qp = q0 + (tid >> 2);

  for (int i = tid; i < 2 * KT * DP; i += blockDim.x) ks[i] = 0.f;

  float qv[NPT], acc[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int d = c + 4 * i;
    // (q * scale) . k, the reference kernel's order
    qv[i] = (qp < a.Sq && d < a.D) ? qg[(size_t)qp * a.D + d] * a.scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int t_begin, t_end;
  tile_range(a, q0, KT, t_begin, t_end);
  for (int it = t_begin; it < t_end; ++it) {
    const int k0 = it * KT;
    __syncthreads();  // the previous tile is no longer read
    load_rows_f32<DP>(a, ks, kg, a.Sk, k0, KT);
    load_rows_f32<DP>(a, vs, vg, a.Sk, k0, KT);
    __syncthreads();

    float s[KT];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float* kr = ks + j * DP + c;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) part += qv[i] * kr[4 * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      float x = -INFINITY;  // past the keys: no weight at all
      if (kp < a.kv_len) x = allowed(a, qp, kp) ? part : kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      s[j] = expf(s[j] - mn);
      ls += s[j];
    }
    l = l * corr + ls;
    m = mn;
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const float* vc = vs + c + 4 * i;
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) pv += s[j] * vc[j * DP];
      acc[i] = acc[i] * corr + pv;
    }
  }

  if (qp < a.Sq) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int d = c + 4 * i;
      if (d < a.D) og[(size_t)qp * a.D + d] = acc[i] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch_kernel(Kernel kern, size_t& opted_in, const Args& a, int threads,
                  size_t smem, cudaStream_t stream) {
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.BH);
  kern<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const Args& a, cudaStream_t s) {
  constexpr int KT = DP > 128 ? 32 : 64;
  static size_t opted_in = 48 * 1024;
  const size_t smem = (size_t)(kBlockQ + 4 * KT) * (DP + 8) * 2;
  return launch_kernel(flash_bf16_kernel<DP, KT>, opted_in, a, 128, smem, s);
}

template <int DP>
int launch_f32(const Args& a, cudaStream_t s) {
  constexpr int KT = DP > 128 ? 16 : 32;
  static size_t opted_in = 48 * 1024;
  const size_t smem = (size_t)2 * KT * DP * 4;
  return launch_kernel(flash_f32_kernel<DP, KT>, opted_in, a, 256, smem, s);
}

template <bool BF16>
int launch_dp(const Args& a, cudaStream_t s) {
  const int d = a.D;
  if (d <= 16) return BF16 ? launch_bf16<16>(a, s) : launch_f32<16>(a, s);
  if (d <= 32) return BF16 ? launch_bf16<32>(a, s) : launch_f32<32>(a, s);
  if (d <= 64) return BF16 ? launch_bf16<64>(a, s) : launch_f32<64>(a, s);
  if (d <= 128) return BF16 ? launch_bf16<128>(a, s) : launch_f32<128>(a, s);
  return BF16 ? launch_bf16<256>(a, s) : launch_f32<256>(a, s);
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. q and out are device pointers
// to contiguous (BH, Sq, D) tensors of `dtype` (0 f32, 1 bf16), k and v to
// contiguous (BH, Sk, D) ones; Sk != Sq only when causal == 0 and
// window <= 0. The first kv_len (<= Sk) keys of a row carry weight.
// window <= 0 means none. Asynchronous on `stream`.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int BH, int Sq,
                               int Sk, int kv_len, int D, int causal,
                               int window, float scale, void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (BH < 0 || Sq < 0 || Sk < 1 || kv_len < 0 || kv_len > Sk || D <= 0 ||
      D > 256 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (Sk != Sq && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.BH = BH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.kv_len = kv_len;
  a.D = D;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  const int elem = dtype == kF32 ? 4 : 2;
  a.vec = (D * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_dp<false>(a, s);
    case kBF16: return launch_dp<true>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
