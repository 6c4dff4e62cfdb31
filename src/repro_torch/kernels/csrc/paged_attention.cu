// Paged decode / span attention for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   paged_decode_attention       (_paged_decode_kernel, one query per row)
//   paged_decode_span_attention  (_paged_span_kernel, T queries per row)
// Both compute softmax(q k^T / sqrt(D)) v for each query row against the
// keys of an (N, P, KV, D) page pool reached through a (B, M) page table,
// with GQA (query head h reads KV head h / (H / KV)), an optional sliding
// window and optional int8 pages with bf16 (N, P, KV) scale pages. A one-token
// decode at valid count `pos` is the span case T = 1 with its query at
// position pos - 1, so one templated body serves both (pos_offset -1 / 0).
//
// Bound on an H100: memory for decode and short spans. Each query row reads
// every valid key once and does 4*D flops per key, far below the ~295
// flop/byte ridge, so the least time is (bytes of the valid pages + q + out)
// / 3.35 TB/s. A 128-token prefill span is bound by its operations instead.
//
// Design (simple and correct first; no wgmma or TMA yet):
//   * a block owns one (row b, KV head, tile of `tq` span tokens, split of
//     the key range); its query rows are the tq * (H / KV) heads that share
//     the KV head, so each streamed key is read from device memory once per
//     block and used by all of them (the TPU kernel's GQA fold);
//   * the key range a block streams is only the pages that hold a valid
//     position for one of its rows; when there are fewer blocks than SMs,
//     that range is split over `splits` blocks (flash-decoding) whose
//     partial softmax states a second kernel merges;
//   * the block stages its table row in shared memory, then streams `tk`
//     keys (whole pages) at a time with 16-byte loads, several in flight per
//     thread, dequantizing int8 in registers as it stages K and V in fp32
//     shared memory;
//   * scores, the online-softmax state (m, l) and the accumulator stay in
//     fp32 shared memory; masked keys score -1e30, as in the reference, so a
//     row with no valid key gets the uniform mean of every slot of its table
//     row (its block then streams all M pages to reproduce that exactly);
//   * with bf16 queries (bf16 or int8 pages, D % 16 == 0) both products run
//     on tensor cores through warp-level mma (16x16x16 bf16 tiles, fp32
//     accumulation) over K and V staged in bf16; f32 queries keep fp32
//     CUDA-core products, so an f32 run stays exact to f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kThreads = 128;
constexpr int kLoadsPerThread = 4;  // 16-byte loads in flight per thread
constexpr int kMaxSplits = 32;
constexpr size_t kSmemBudget = 200 * 1024;
constexpr size_t kSmemMax = 232448;  // an H100 block's opt-in maximum

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of page data -> 16 / sizeof(PT) floats
template <typename PT>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(PT); ++i) out[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const __nv_bfloat16* k_scale;
  const __nv_bfloat16* v_scale;
  const int* table;
  const int* pos;
  void* out;
  float* part;  // splits > 1: partial acc (splits, rows, D) then (m, l)
  int B, T, H, KV, D, N, P, M;
  int window;      // <= 0: no window
  int pos_offset;  // query t of row b sits at pos[b] + pos_offset + t
  float scale;
  int tq;      // span tokens per block
  int tk;      // keys per streamed tile, a multiple of P
  int splits;  // blocks sharing one key range
  int vec;     // pages 16-byte aligned with D * sizeof(PT) % 16 == 0
  int r16;     // tensor-core path: query rows padded to a multiple of 16
  int lay[10];  // tensor-core path: shared-memory offsets (MmaLayout)
};

// Key range of one block: the slots valid for some of its query rows, or
// the whole table row when one of them has no valid slot (the reference
// then averages every slot), cut to this block's share of whole tiles.
struct Range {
  int base;     // position of the block's first query
  int nt;       // span tokens in the block
  int slot_hi;  // end of the streamed range (slots past it weigh nothing)
  int k_begin, k_end;  // this split's tiles
};

__device__ __forceinline__ Range block_range(const Args& a, int b, int t0,
                                             int split) {
  Range g;
  g.nt = min(a.tq, a.T - t0);
  const int S = a.M * a.P, P = a.P;
  g.base = a.pos[b] + a.pos_offset + t0;
  const int qlo = g.base, qhi = g.base + g.nt - 1;
  const bool lacks_lo =
      qlo < 0 || (a.window > 0 && qlo - a.window + 1 > S - 1);
  const bool lacks_hi =
      qhi < 0 || (a.window > 0 && qhi - a.window + 1 > S - 1);
  int key_lo = 0, key_hi = S;
  if (!lacks_lo && !lacks_hi) {
    key_hi = min(qhi + 1, S);
    key_lo = a.window > 0 ? max(0, qlo - a.window + 1) : 0;
  }
  const int slot_lo = (key_lo / P) * P;
  g.slot_hi = ((key_hi + P - 1) / P) * P;
  const int ntiles = (g.slot_hi - slot_lo + a.tk - 1) / a.tk;
  const int per = (ntiles + a.splits - 1) / a.splits;
  g.k_begin = slot_lo + min(ntiles, split * per) * a.tk;
  g.k_end = slot_lo + min(ntiles, (split + 1) * per) * a.tk;
  return g;
}

__device__ __forceinline__ bool key_ok(const Args& a, int slot, int qp) {
  return slot <= qp && (a.window <= 0 || slot > qp - a.window);
}

// Normalized rows to `out` (one split), or the unnormalized accumulator and
// (m, l) to the workspace for combine_kernel (several splits).
template <typename QT>
__device__ __forceinline__ void write_rows(const Args& a, const float* acc,
                                           int lda, const float* m_s,
                                           const float* l_s, int rows, int b,
                                           int t0, int kvh, int split) {
  const int D = a.D, groups = a.H / a.KV;
  const int n_rows = a.B * a.T * a.H;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    const int t = r / groups, g = r - t * groups;
    const size_t row = ((size_t)b * a.T + t0 + t) * a.H + kvh * groups + g;
    if (a.splits == 1) {
      store_f(static_cast<QT*>(a.out) + row * D + d,
              acc[r * lda + d] / fmaxf(l_s[r], 1e-30f));
    } else {
      a.part[((size_t)split * n_rows + row) * D + d] = acc[r * lda + d];
      if (d == 0) {
        float* ml = a.part + (size_t)a.splits * n_rows * D;
        ml[((size_t)split * n_rows + row) * 2] = m_s[r];
        ml[((size_t)split * n_rows + row) * 2 + 1] = l_s[r];
      }
    }
  }
}

inline size_t smem_floats(int m, int rows, int tk, int d) {
  const size_t ds = d + 1, ts = tk + 1;
  return m + 2 * rows * ds + 2 * tk * ds + rows * ts + 3 * rows;
}

// Stage K and V of the tile [k0, k0 + tk) in fp32 shared memory; slots at
// or past slot_hi stage zeros.
template <typename PT, bool QUANT>
__device__ __forceinline__ void stage_tile(const Args& a, const PT* kp,
                                           const PT* vp, const int* tab,
                                           int k0, int slot_hi, int kvh,
                                           float* kt, float* vt) {
  const int D = a.D, P = a.P, ds = D + 1, tid = threadIdx.x;
  if (a.vec) {
    constexpr int V = 16 / sizeof(PT);
    const int vpr = D / V;  // 16-byte vectors per key row
    const int nvec = a.tk * vpr;
    for (int base = tid; base < nvec; base += blockDim.x * kLoadsPerThread) {
      uint4 kr[kLoadsPerThread], vr[kLoadsPerThread];
      float ksc[kLoadsPerThread], vsc[kLoadsPerThread];
#pragma unroll
      for (int j = 0; j < kLoadsPerThread; ++j) {
        const int i = base + j * blockDim.x;
        kr[j] = vr[j] = make_uint4(0, 0, 0, 0);
        ksc[j] = vsc[j] = 1.f;
        if (i < nvec) {
          const int key = i / vpr, c = i - key * vpr;
          const int slot = k0 + key;
          if (slot < slot_hi) {
            const int pg = slot / P, s = slot - pg * P;
            const size_t row = ((size_t)tab[pg] * P + s) * a.KV + kvh;
            kr[j] = __ldg(reinterpret_cast<const uint4*>(kp + row * D) + c);
            vr[j] = __ldg(reinterpret_cast<const uint4*>(vp + row * D) + c);
            if (QUANT) {
              ksc[j] = __bfloat162float(a.k_scale[row]);
              vsc[j] = __bfloat162float(a.v_scale[row]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kLoadsPerThread; ++j) {
        const int i = base + j * blockDim.x;
        if (i < nvec) {
          const int key = i / vpr, c = i - key * vpr;
          float kf[V], vf[V];
          unpack16<PT>(kr[j], kf);
          unpack16<PT>(vr[j], vf);
          float* kd = kt + key * ds + c * V;
          float* vd = vt + key * ds + c * V;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            kd[e] = kf[e] * ksc[j];
            vd[e] = vf[e] * vsc[j];
          }
        }
      }
    }
  } else {
    for (int i = tid; i < a.tk * D; i += blockDim.x) {
      const int key = i / D, d = i - (i / D) * D;
      const int slot = k0 + key;
      float kf = 0.f, vf = 0.f;
      if (slot < slot_hi) {
        const int pg = slot / P, s = slot - pg * P;
        const size_t row = ((size_t)tab[pg] * P + s) * a.KV + kvh;
        kf = to_f(kp[row * D + d]);
        vf = to_f(vp[row * D + d]);
        if (QUANT) {
          kf *= __bfloat162float(a.k_scale[row]);
          vf *= __bfloat162float(a.v_scale[row]);
        }
      }
      kt[key * ds + d] = kf;
      vt[key * ds + d] = vf;
    }
  }
}

template <typename QT, typename PT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z % a.splits;
  const int t0 = (blockIdx.z / a.splits) * a.tq;
  const int groups = a.H / a.KV;
  const int rows = min(a.tq, a.T - t0) * groups;  // query rows here
  const int rmax = a.tq * groups;
  const int D = a.D, tk = a.tk;
  const int ds = D + 1;  // padded stride: row-per-thread reads skip banks
  const int ts = tk + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  int* tab = reinterpret_cast<int*>(smem);
  float* qs = smem + a.M;
  float* acc = qs + rmax * ds;
  float* kt = acc + rmax * ds;
  float* vt = kt + tk * ds;
  float* sc = vt + tk * ds;
  float* m_s = sc + rmax * ts;
  float* l_s = m_s + rmax;
  float* c_s = l_s + rmax;

  const QT* q = static_cast<const QT*>(a.q);
  const PT* kp = static_cast<const PT*>(a.k_pages);
  const PT* vp = static_cast<const PT*>(a.v_pages);

  for (int j = tid; j < a.M; j += blockDim.x) {
    const int pid = a.table[(size_t)b * a.M + j];
    tab[j] = min(max(pid, 0), a.N - 1);
  }
  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    const int t = r / groups, g = r - t * groups;
    const size_t off =
        (((size_t)b * a.T + t0 + t) * a.H + kvh * groups + g) * D + d;
    qs[r * ds + d] = to_f(q[off]) * a.scale;
    acc[r * ds + d] = 0.f;
  }
  for (int r = tid; r < rows; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const Range g = block_range(a, b, t0, split);
  const int base = g.base, slot_hi = g.slot_hi;
  __syncthreads();

  for (int k0 = g.k_begin; k0 < g.k_end; k0 += tk) {
    stage_tile<PT, QUANT>(a, kp, vp, tab, k0, slot_hi, kvh, kt, vt);
    __syncthreads();

    // scores: one (row, key) dot product per thread and step
    for (int i = tid; i < rows * tk; i += blockDim.x) {
      const int r = i / tk, key = i - (i / tk) * tk;
      const int slot = k0 + key;
      float s = -INFINITY;  // past the streamed range: no weight at all
      if (slot < slot_hi) {
        const float* qr = qs + r * ds;
        const float* kr = kt + key * ds;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = key_ok(a, slot, base + r / groups) ? dot : kNegInf;
      }
      sc[r * ts + key] = s;
    }
    __syncthreads();

    // online-softmax update, one warp per row
    for (int r = warp; r < rows; r += nwarps) {
      float* sr = sc + r * ts;
      float mx = -INFINITY;
      for (int key = lane; key < tk; key += 32) mx = fmaxf(mx, sr[key]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int key = lane; key < tk; key += 32) {
        const float e = expf(sr[key] - m_new);
        sr[key] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v, one (row, d) element per thread and step
    for (int i = tid; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i - (i / D) * D;
      const float* pr = sc + r * ts;
      float x = acc[r * ds + d] * c_s[r];
      for (int key = 0; key < tk; ++key) x += pr[key] * vt[key * ds + d];
      acc[r * ds + d] = x;
    }
    __syncthreads();
  }

  write_rows<QT>(a, acc, ds, m_s, l_s, rows, b, t0, kvh, split);
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 queries, bf16 or int8 pages, D % 16 == 0): the same
// block and key range, with K and V staged in bf16 and both products on
// warp-level mma (16x16x16 bf16 tiles, fp32 accumulation). The masked,
// scaled scores and the softmax stay in fp32; the probabilities enter the
// PV product in bf16, as the reference gather path casts them.
// ---------------------------------------------------------------------------

// byte offsets of the tensor-core path's shared memory (128-byte aligned)
struct MmaLayout {
  size_t tab, qh, kh, vh, ph, s, acc, m, l, c, total;
};

inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

inline MmaLayout mma_layout(int m, int r16, int tk, int d) {
  MmaLayout L;
  size_t o = 0;
  L.tab = o; o = align128(o + (size_t)m * 4);
  L.qh = o; o = align128(o + (size_t)r16 * (d + 8) * 2);
  L.kh = o; o = align128(o + (size_t)tk * (d + 8) * 2);
  L.vh = o; o = align128(o + (size_t)tk * (d + 8) * 2);
  L.ph = o; o = align128(o + (size_t)r16 * (tk + 8) * 2);
  L.s = o; o = align128(o + (size_t)r16 * (tk + 4) * 4);
  L.acc = o; o = align128(o + (size_t)r16 * (d + 4) * 4);
  L.m = o; o = align128(o + (size_t)r16 * 4);
  L.l = o; o = align128(o + (size_t)r16 * 4);
  L.c = o; o = align128(o + (size_t)r16 * 4);
  L.total = o;
  return L;
}

inline bool use_mma(int q_dtype, int page_dtype, int d, int tk) {
  return q_dtype == kBF16 && page_dtype != kF32 && d % 16 == 0 &&
         tk % 16 == 0;
}

// Stage K and V of the tile [k0, k0 + tk) in bf16 shared memory (row
// stride ldh); bf16 pages copy as they are, int8 pages dequantize first.
template <typename PT, bool QUANT>
__device__ __forceinline__ void stage_tile_h(const Args& a, const PT* kp,
                                             const PT* vp, const int* tab,
                                             int k0, int slot_hi, int kvh,
                                             __nv_bfloat16* kh,
                                             __nv_bfloat16* vh, int ldh) {
  constexpr int V = 16 / sizeof(PT);
  const int D = a.D, P = a.P;
  const int vpr = D / V;
  const int nvec = a.tk * vpr;
  for (int base = threadIdx.x; base < nvec;
       base += blockDim.x * kLoadsPerThread) {
    uint4 kr[kLoadsPerThread], vr[kLoadsPerThread];
    float ksc[kLoadsPerThread], vsc[kLoadsPerThread];
#pragma unroll
    for (int j = 0; j < kLoadsPerThread; ++j) {
      const int i = base + j * blockDim.x;
      kr[j] = vr[j] = make_uint4(0, 0, 0, 0);
      ksc[j] = vsc[j] = 1.f;
      if (i < nvec) {
        const int key = i / vpr, c = i - key * vpr;
        const int slot = k0 + key;
        if (slot < slot_hi) {
          const int pg = slot / P, s = slot - pg * P;
          const size_t row = ((size_t)tab[pg] * P + s) * a.KV + kvh;
          kr[j] = __ldg(reinterpret_cast<const uint4*>(kp + row * D) + c);
          vr[j] = __ldg(reinterpret_cast<const uint4*>(vp + row * D) + c);
          if (QUANT) {
            ksc[j] = __bfloat162float(a.k_scale[row]);
            vsc[j] = __bfloat162float(a.v_scale[row]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLoadsPerThread; ++j) {
      const int i = base + j * blockDim.x;
      if (i < nvec) {
        const int key = i / vpr, c = i - key * vpr;
        uint4* kd = reinterpret_cast<uint4*>(kh + key * ldh + c * V);
        uint4* vd = reinterpret_cast<uint4*>(vh + key * ldh + c * V);
        if constexpr (sizeof(PT) == 2) {
          kd[0] = kr[j];
          vd[0] = vr[j];
        } else {
          float kf[V], vf[V];
          unpack16<PT>(kr[j], kf);
          unpack16<PT>(vr[j], vf);
          __align__(16) __nv_bfloat16 kb[V], vb[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            kb[e] = __float2bfloat16(kf[e] * ksc[j]);
            vb[e] = __float2bfloat16(vf[e] * vsc[j]);
          }
#pragma unroll
          for (int w = 0; w < V / 8; ++w) {
            kd[w] = reinterpret_cast<const uint4*>(kb)[w];
            vd[w] = reinterpret_cast<const uint4*>(vb)[w];
          }
        }
      }
    }
  }
}

template <typename PT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_attention_mma_kernel(const Args a) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z % a.splits;
  const int t0 = (blockIdx.z / a.splits) * a.tq;
  const int groups = a.H / a.KV;
  const int rows = min(a.tq, a.T - t0) * groups;  // query rows here
  const int r16 = a.r16;
  const int D = a.D, tk = a.tk;
  const int ldh = D + 8, ldp = tk + 8, lds = tk + 4, lda = D + 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  int* tab = reinterpret_cast<int*>(smem_mma + a.lay[0]);
  __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(smem_mma + a.lay[1]);
  __nv_bfloat16* kh = reinterpret_cast<__nv_bfloat16*>(smem_mma + a.lay[2]);
  __nv_bfloat16* vh = reinterpret_cast<__nv_bfloat16*>(smem_mma + a.lay[3]);
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(smem_mma + a.lay[4]);
  float* sc = reinterpret_cast<float*>(smem_mma + a.lay[5]);
  float* acc = reinterpret_cast<float*>(smem_mma + a.lay[6]);
  float* m_s = reinterpret_cast<float*>(smem_mma + a.lay[7]);
  float* l_s = reinterpret_cast<float*>(smem_mma + a.lay[8]);
  float* c_s = reinterpret_cast<float*>(smem_mma + a.lay[9]);

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const PT* kp = static_cast<const PT*>(a.k_pages);
  const PT* vp = static_cast<const PT*>(a.v_pages);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int j = tid; j < a.M; j += blockDim.x) {
    const int pid = a.table[(size_t)b * a.M + j];
    tab[j] = min(max(pid, 0), a.N - 1);
  }
  // padding rows (rows .. r16) hold zero queries and zero probabilities
  for (int i = tid; i < r16 * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    __nv_bfloat16 x = zero;
    if (r < rows) {
      const int t = r / groups, g = r - t * groups;
      x = q[(((size_t)b * a.T + t0 + t) * a.H + kvh * groups + g) * D + d];
    }
    qh[r * ldh + d] = x;
    acc[r * lda + d] = 0.f;
  }
  for (int i = tid; i < r16 * tk; i += blockDim.x)
    ph[(i / tk) * ldp + i - (i / tk) * tk] = zero;
  for (int r = tid; r < r16; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    c_s[r] = 1.f;
  }

  const Range g = block_range(a, b, t0, split);
  const int base = g.base, slot_hi = g.slot_hi;
  const int mt = r16 / 16;
  __syncthreads();

  for (int k0 = g.k_begin; k0 < g.k_end; k0 += tk) {
    stage_tile_h<PT, QUANT>(a, kp, vp, tab, k0, slot_hi, kvh, kh, vh, ldh);
    __syncthreads();

    // raw scores S = Q K^T on tensor cores, one 16x16 tile per warp step
    for (int tile = warp; tile < mt * (tk / 16); tile += nwarps) {
      const int ti = tile / (tk / 16), tj = tile - ti * (tk / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
      wmma::fill_fragment(fc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qh + ti * 16 * ldh + kk * 16, ldh);
        wmma::load_matrix_sync(fb, kh + tj * 16 * ldh + kk * 16, ldh);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(sc + ti * 16 * lds + tj * 16, fc, lds,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // scale, mask, online softmax; probabilities to bf16; a warp per row
    for (int r = warp; r < rows; r += nwarps) {
      float* sr = sc + r * lds;
      const int qp = base + r / groups;
      float mx = -INFINITY;
      for (int key = lane; key < tk; key += 32) {
        const int slot = k0 + key;
        float x = -INFINITY;  // past the streamed range: no weight at all
        if (slot < slot_hi)
          x = key_ok(a, slot, qp) ? sr[key] * a.scale : kNegInf;
        sr[key] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int key = lane; key < tk; key += 32) {
        const float e = expf(sr[key] - m_new);
        ph[r * ldp + key] = __float2bfloat16(e);
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      acc[r * lda + i - r * D] *= c_s[r];
    }
    __syncthreads();

    // acc += P V on tensor cores
    for (int tile = warp; tile < mt * (D / 16); tile += nwarps) {
      const int ti = tile / (D / 16), tj = tile - ti * (D / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
      float* ap = acc + ti * 16 * lda + tj * 16;
      wmma::load_matrix_sync(fc, ap, lda, wmma::mem_row_major);
      for (int kk = 0; kk < tk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ph + ti * 16 * ldp + kk * 16, ldp);
        wmma::load_matrix_sync(fb, vh + kk * 16 * ldh + tj * 16, ldh);
        wmma::mma_sync(fc, fa, fb, fc);
      }
      wmma::store_matrix_sync(ap, fc, lda, wmma::mem_row_major);
    }
    __syncthreads();
  }

  write_rows<__nv_bfloat16>(a, acc, lda, m_s, l_s, rows, b, t0, kvh, split);
}

// Merge the splits' partial softmax states of one query row per block.
template <typename QT>
__global__ void combine_kernel(const float* part, QT* out, int n_rows,
                               int D, int splits) {
  const int row = blockIdx.x;
  const float* ml = part + (size_t)splits * n_rows * D;
  float mg = -INFINITY;
  for (int s = 0; s < splits; ++s)
    mg = fmaxf(mg, ml[((size_t)s * n_rows + row) * 2]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t i = ((size_t)s * n_rows + row) * 2;
    l += expf(ml[i] - mg) * ml[i + 1];
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float x = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t i = (size_t)s * n_rows + row;
      x += expf(ml[i * 2] - mg) * part[i * D + d];
    }
    store_f(out + (size_t)row * D + d, x / fmaxf(l, 1e-30f));
  }
}

template <typename Kernel>
int launch_kernel(Kernel kern, size_t& opted_in, const Args& a, size_t smem,
                  cudaStream_t stream) {
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid(a.B, a.KV, ((a.T + a.tq - 1) / a.tq) * a.splits);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT, bool QUANT>
int launch(const Args& a, bool mma, size_t smem, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;  // per instantiation and path
  static size_t opted_in_mma = 48 * 1024;
  cudaError_t e;
  if constexpr (std::is_same<QT, __nv_bfloat16>::value &&
                !std::is_same<PT, float>::value) {
    e = (cudaError_t)(mma ? launch_kernel(
                                paged_attention_mma_kernel<PT, QUANT>,
                                opted_in_mma, a, smem, stream)
                          : launch_kernel(
                                paged_attention_kernel<QT, PT, QUANT>,
                                opted_in, a, smem, stream));
  } else {
    if (mma) return (int)cudaErrorInvalidValue;
    e = (cudaError_t)launch_kernel(paged_attention_kernel<QT, PT, QUANT>,
                                   opted_in, a, smem, stream);
  }
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const int n_rows = a.B * a.T * a.H;
  combine_kernel<QT><<<n_rows, 64, 0, stream>>>(
      a.part, static_cast<QT*>(a.out), n_rows, a.D, a.splits);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_q(int page_dtype, const Args& a, bool mma, size_t smem,
             cudaStream_t s) {
  switch (page_dtype) {
    case kF32: return launch<QT, float, false>(a, mma, smem, s);
    case kBF16: return launch<QT, __nv_bfloat16, false>(a, mma, smem, s);
    case kI8: return launch<QT, int8_t, true>(a, mma, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared memory of a block for a shape and path, in bytes.
inline size_t smem_bytes(bool mma, int m, int rows, int tk, int d) {
  if (mma) return mma_layout(m, (rows + 15) / 16 * 16, tk, d).total;
  return smem_floats(m, rows, tk, d) * 4;
}

}  // namespace

// Launch plan for a shape and dtypes: plan[0] = tq (span tokens per block),
// plan[1] = tk (keys per tile), plan[2] = splits (blocks per key range; the
// caller provides a workspace of splits * B * T * H * (D + 2) floats when
// > 1).
// Returns 0, or cudaErrorInvalidValue for a shape no block can hold.
extern "C" int paged_attention_plan(int q_dtype, int page_dtype, int B,
                                    int T, int H, int KV, int D, int P,
                                    int M, int num_sms, int* plan) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || D <= 0 || P <= 0 ||
      M <= 0)
    return (int)cudaErrorInvalidValue;
  const int groups = H / KV;
  int tq = T == 1 ? 1 : std::max(1, 64 / groups);
  tq = std::min(tq, T);
  int tk = P * std::max(1, 64 / P);
  const bool mma = use_mma(q_dtype, page_dtype, D, tk);
  while (smem_bytes(mma, M, tq * groups, tk, D) > kSmemBudget) {
    if (tk > P && !mma) tk -= P;
    else if (tq > 1) --tq;
    else break;
  }
  if (smem_bytes(mma, M, tq * groups, tk, D) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  // fewer blocks than SMs: split each key range so the card fills twice
  const int blocks = B * KV * ((T + tq - 1) / tq);
  const int max_tiles = (M * P + tk - 1) / tk;
  int splits = 1;
  if (blocks < num_sms)
    splits = std::min(std::min((2 * num_sms + blocks - 1) / blocks,
                               max_tiles), kMaxSplits);
  plan[0] = tq;
  plan[1] = tk;
  plan[2] = std::max(splits, 1);
  return 0;
}

// Returns 0 or the cudaError_t of the launch. Pointers are device pointers
// to contiguous tensors: q and out (B, T, H, D) of q_dtype; pages
// (N, P, KV, D) of page_dtype; scales (N, P, KV) bf16 for int8 pages (else
// null); table (B, M) and pos (B,) int32; workspace as paged_attention_plan
// says (null when splits == 1). Asynchronous on `stream`.
extern "C" int paged_attention(int q_dtype, int page_dtype, const void* q,
                               const void* k_pages, const void* v_pages,
                               const void* k_scale, const void* v_scale,
                               const void* table, const void* pos, void* out,
                               void* workspace, int B, int T, int H, int KV,
                               int D, int N, int P, int M, int window,
                               int pos_offset, float scale, int tq, int tk,
                               int splits, void* stream) {
  if (B == 0 || T == 0) return 0;
  if (KV <= 0 || H % KV != 0 || D <= 0 || P <= 0 || M <= 0 || N <= 0 ||
      tq <= 0 || tk <= 0 || tk % P != 0 || splits <= 0 ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((page_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool mma = use_mma(q_dtype, page_dtype, D, tk);
  const size_t smem = smem_bytes(mma, M, tq * (H / KV), tk, D);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int elem = page_dtype == kF32 ? 4 : page_dtype == kBF16 ? 2 : 1;

  Args a;
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.part = static_cast<float*>(workspace);
  a.B = B; a.T = T; a.H = H; a.KV = KV; a.D = D; a.N = N; a.P = P; a.M = M;
  a.window = window;
  a.pos_offset = pos_offset;
  a.scale = scale;
  a.tq = tq;
  a.tk = tk;
  a.splits = splits;
  a.vec = (D * elem) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  if (mma) {
    if (!a.vec) return (int)cudaErrorMisalignedAddress;
    a.r16 = (tq * (H / KV) + 15) / 16 * 16;
    const MmaLayout L = mma_layout(M, a.r16, tk, D);
    const size_t offs[10] = {L.tab, L.qh, L.kh, L.vh, L.ph,
                             L.s,   L.acc, L.m, L.l,  L.c};
    for (int i = 0; i < 10; ++i) a.lay[i] = (int)offs[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return launch_q<float>(page_dtype, a, mma, smem, s);
    case kBF16:
      return launch_q<__nv_bfloat16>(page_dtype, a, mma, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
