// Dense ring decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// `decode_attention` (_decode_kernel): one query token per request against
// a dense (B, W, KV, D) k/v cache that is a ring when a sliding window makes
// W smaller than the sequence. Slot i holds absolute position
// i + W * floor(max(pos - 1 - i, 0) / W) and is valid below `pos` (and, with
// a window, at or above pos - window). It computes softmax(q k^T / sqrt(D)) v
// with GQA (query head h reads KV head h / (H / KV)); scores and the softmax
// run in fp32, masked keys score -1e30 as in the reference, so a row with no
// valid key gets the uniform mean of all W slots.
//
// Bound on an H100: memory. A row reads each of its min(pos, W) valid keys
// and values once and does 4 * D flops per key and query head, far below
// the ~295 flop/byte ridge, so the least time is (valid K/V bytes + q +
// out) / 3.35 TB/s. At serving batch sizes that is a few microseconds, the
// same order as a launch.
//
// Both bodies stream only a row's valid keys: the absolute positions
// [max(pos - W, pos - window, 0), pos) map to slots position % W, a range
// that may wrap around the ring, so any W and any pos work (the Pallas kernel
// needed W % block_k == 0); a row with no valid key streams all W slots at
// -1e30. A block owns one (row b, KV head, split of the row's keys); its
// query rows are the H / KV heads that share the KV head, so each key is
// read from device memory once per block and used by all of them (the TPU
// kernel's GQA fold). B * KV blocks are far fewer than the 132 SMs at decode
// batch sizes, so each row's keys are split over several blocks
// (flash-decoding); the wrapper's dense_plan sizes the splits.
//
// bf16 design (one launch; kernels/decode_attention.py::dense_plan, and
// dense_split_slots mirrors the split of a row's keys):
//   * the splits of one (b, KV head) are the blocks of one thread-block
//     cluster (at most 8), launched with cudaLaunchKernelEx. Each block keeps
//     its partial (m, l, acc) in shared memory; after a cluster barrier every
//     rank reads all ranks' partials through distributed shared memory
//     (mapa, ld.shared::cluster), merges them in rank order for its share of
//     the row's outputs and writes them normalized. No workspace, no second
//     kernel, one fixed order of every sum: a call is bit-reproducible;
//   * keys stream in stages of 64 through a ring of 3 (D > 64) or 4 stages
//     of bf16 K and V in shared memory, by 16-byte cp.async copies; stages
//     j + 1 .. j + 2 (or j + 3) are in flight while stage j is used, one
//     __syncthreads a stage. Key rows are padded by 16 bytes so ldmatrix is
//     free of bank conflicts; keys past the block's range load as zeros;
//   * the g = H / KV query heads are the rows of mma.sync m16n8k16 (rows
//     past g are zero; g <= 16), bf16 in, fp32 accumulation; each of the 4
//     warps takes 16 keys of a stage: S = Q K^T (K fragments by ldmatrix),
//     the online softmax in fp32 in the exp2 domain in the accumulator
//     registers (a row's max and sum are quad shuffles), then the
//     probabilities as the bf16 A operand of O += P V (V fragments by
//     ldmatrix.trans); Q, O and the softmax state stay in registers. The 4
//     warps' states merge in shared memory in warp order;
//   * D up to 256, a multiple of 8: the tiles are DP = 16, 32, 64, 128 or 256
//     columns wide, zeros past D.
//
// f32 design (simple and correct first; no TMA or tensor cores): a block
// stages 32 keys of K and V at a time in fp32 shared memory with 16-byte
// loads, several in flight per thread; scores, the online softmax and the
// accumulator stay in fp32 and every product runs on the CUDA cores in fp32
// (never TF32), so an f32 run agrees with the plain version to f32 rounding.
// With several splits, each block writes its partial softmax state to a
// workspace and a second kernel merges them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kThreads = 128;
constexpr int kTileKeys = 32;
constexpr int kLoadsPerThread = 4;  // 16-byte loads in flight per thread
constexpr int kMaxSplits = 32;
constexpr size_t kSmemMax = 232448;  // an H100 block's opt-in maximum

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = to_f(e[i]);
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
  const void* q;  // (B, H, D)
  const void* k;  // (B, W, KV, D)
  const void* v;
  const int* pos;  // (B,) valid token count
  void* out;       // (B, H, D)
  float* part;     // splits > 1: partial acc (splits, B*H, D) then (m, l)
  int B, H, KV, D, W;
  int window;  // <= 0: no window
  float scale;
  int splits;
  int vec;  // 16-byte loads: D * sizeof(T) % 16 == 0 and aligned caches
};

// The keys a row streams: logical key j < n is the slot (start + j) % W.
struct RowKeys {
  int start, n;
  bool masked;  // no valid key: all W slots, each scoring -1e30
};

__device__ __forceinline__ RowKeys row_keys(const Args& a, int p) {
  int lo = max(0, p - a.W);
  if (a.window > 0) lo = max(lo, p - a.window);
  RowKeys r;
  r.n = p - lo;
  r.masked = r.n <= 0;
  if (r.masked) {
    r.start = 0;
    r.n = a.W;
  } else {
    r.start = lo % a.W;
  }
  return r;
}

inline size_t smem_floats(int groups, int d) {
  const size_t ds = d + 1, ts = kTileKeys + 1;
  return groups * ds + (size_t)groups * d + 2 * kTileKeys * ds +
         groups * ts + 3 * groups;
}

// Stage the K and V rows of logical keys [j0, j0 + kTileKeys) in fp32
// shared memory (row stride D + 1); keys at or past n stage zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(const Args& a, const T* kc,
                                           const T* vc, int b, int kvh,
                                           const RowKeys& rk, int j0,
                                           float* kt, float* vt) {
  const int D = a.D, ds = D + 1, tid = threadIdx.x;
  if (a.vec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = D / V;  // 16-byte vectors per key row
    const int nvec = kTileKeys * vpr;
    for (int base = tid; base < nvec; base += blockDim.x * kLoadsPerThread) {
      uint4 kr[kLoadsPerThread], vr[kLoadsPerThread];
#pragma unroll
      for (int j = 0; j < kLoadsPerThread; ++j) {
        const int i = base + j * blockDim.x;
        kr[j] = vr[j] = make_uint4(0, 0, 0, 0);
        if (i < nvec) {
          const int key = i / vpr, c = i - key * vpr;
          const int lj = j0 + key;
          if (lj < rk.n) {
            const int slot = (rk.start + lj) % a.W;
            const size_t row = ((size_t)b * a.W + slot) * a.KV + kvh;
            kr[j] = __ldg(reinterpret_cast<const uint4*>(kc + row * D) + c);
            vr[j] = __ldg(reinterpret_cast<const uint4*>(vc + row * D) + c);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kLoadsPerThread; ++j) {
        const int i = base + j * blockDim.x;
        if (i < nvec) {
          const int key = i / vpr, c = i - key * vpr;
          unpack16<T>(kr[j], kt + key * ds + c * V);
          unpack16<T>(vr[j], vt + key * ds + c * V);
        }
      }
    }
  } else {
    for (int i = tid; i < kTileKeys * D; i += blockDim.x) {
      const int key = i / D, d = i - key * D;
      const int lj = j0 + key;
      float kf = 0.f, vf = 0.f;
      if (lj < rk.n) {
        const int slot = (rk.start + lj) % a.W;
        const size_t row = ((size_t)b * a.W + slot) * a.KV + kvh;
        kf = to_f(kc[row * D + d]);
        vf = to_f(vc[row * D + d]);
      }
      kt[key * ds + d] = kf;
      vt[key * ds + d] = vf;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int groups = a.H / a.KV;
  const int D = a.D, ds = D + 1, ts = kTileKeys + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;

  float* qs = smem;
  float* acc = qs + groups * ds;
  float* kt = acc + groups * D;
  float* vt = kt + kTileKeys * ds;
  float* sc = vt + kTileKeys * ds;
  float* m_s = sc + groups * ts;
  float* l_s = m_s + groups;
  float* c_s = l_s + groups;

  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);

  for (int i = tid; i < groups * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    qs[r * ds + d] = to_f(q[((size_t)b * a.H + kvh * groups + r) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < groups; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const RowKeys rk = row_keys(a, a.pos[b]);
  const int ntiles = (rk.n + kTileKeys - 1) / kTileKeys;
  const int per = (ntiles + a.splits - 1) / a.splits;
  const int t_begin = min(ntiles, split * per);
  const int t_end = min(ntiles, (split + 1) * per);
  __syncthreads();

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int j0 = tile * kTileKeys;
    stage_tile<T>(a, kc, vc, b, kvh, rk, j0, kt, vt);
    __syncthreads();

    // scores: one (query head, key) dot product per thread and step
    for (int i = tid; i < groups * kTileKeys; i += blockDim.x) {
      const int r = i / kTileKeys, key = i - r * kTileKeys;
      float s = -INFINITY;  // past the row's keys: no weight at all
      if (j0 + key < rk.n) {
        if (rk.masked) {
          s = kNegInf;
        } else {
          const float* qr = qs + r * ds;
          const float* kr = kt + key * ds;
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          s = dot * a.scale;
        }
      }
      sc[r * ts + key] = s;
    }
    __syncthreads();

    // online-softmax update, one warp per query head
    for (int r = warp; r < groups; r += nwarps) {
      float* sr = sc + r * ts;
      float mx = lane < kTileKeys ? sr[lane] : -INFINITY;
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float e = 0.f;
      if (lane < kTileKeys) {
        e = expf(sr[lane] - m_new);
        sr[lane] = e;
      }
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v, one (query head, d) element per thread
    for (int i = tid; i < groups * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      const float* pr = sc + r * ts;
      float x = acc[i] * c_s[r];
#pragma unroll 8
      for (int key = 0; key < kTileKeys; ++key)
        x += pr[key] * vt[key * ds + d];
      acc[i] = x;
    }
    __syncthreads();
  }

  // normalized rows to `out` (one split), or the unnormalized accumulator
  // and (m, l) to the workspace for combine_kernel (several splits)
  const int n_rows = a.B * a.H;
  for (int i = tid; i < groups * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const size_t row = (size_t)b * a.H + kvh * groups + r;
    if (a.splits == 1) {
      store_f(static_cast<T*>(a.out) + row * D + d,
              acc[i] / fmaxf(l_s[r], 1e-30f));
    } else {
      a.part[((size_t)split * n_rows + row) * D + d] = acc[i];
      if (d == 0) {
        float* ml = a.part + (size_t)a.splits * n_rows * D;
        ml[((size_t)split * n_rows + row) * 2] = m_s[r];
        ml[((size_t)split * n_rows + row) * 2 + 1] = l_s[r];
      }
    }
  }
}

// Merge the splits' partial softmax states of one query row per block.
template <typename T>
__global__ void combine_kernel(const float* part, T* out, int n_rows, int D,
                               int splits) {
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

template <typename T>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid(a.B, a.KV, a.splits);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const int n_rows = a.B * a.H;
  combine_kernel<T><<<n_rows, 64, 0, stream>>>(
      a.part, static_cast<T*>(a.out), n_rows, a.D, a.splits);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: mma.sync over a cp.async ring, the splits merged in a cluster
// ---------------------------------------------------------------------------

constexpr int kStageKeys = 64;  // keys of a ring stage: 16 for each warp
constexpr int kClusterMax = 8;  // splits of a row: blocks of one cluster
constexpr int kBThreads = 128;
constexpr int kRows = 16;       // query heads of a block: mma's 16 rows

struct BArgs {
  const __nv_bfloat16* q;  // (B, H, D)
  const __nv_bfloat16* k;  // (B, W, KV, D)
  const __nv_bfloat16* v;
  const int* pos;          // (B,) valid token count
  __nv_bfloat16* out;      // (B, H, D)
  int B, H, KV, D, W;
  int window;        // <= 0: no window
  float scale_log2;  // D^-0.5 * log2(e): scores in the exp2 domain
  int splits;        // blocks of a cluster sharing one row's keys
};

// Shared memory of a block at tile width DP: the ring, and after the key
// walk, in its place, the merge's partial states.
template <int DP>
struct Ring {
  static constexpr int kLd = DP + 8;  // bf16 a key row (16 bytes of pad)
  static constexpr int kStages = DP > 64 ? 3 : 4;
  static constexpr int kStageElems = 2 * kStageKeys * kLd;  // K, then V
  static constexpr int kRingBytes = kStages * kStageElems * 2;
  // floats: the 4 warps' acc (4 x 16 x DP), m and l (4 x 16 each); the
  // block's acc (16 x DP), m and l (16 each); the cluster merge's weights
  // (16 x kClusterMax) and sums (16)
  static constexpr int kWarpAcc = 0;
  static constexpr int kWarpM = kWarpAcc + 4 * kRows * DP;
  static constexpr int kWarpL = kWarpM + 4 * kRows;
  static constexpr int kAcc = kWarpL + 4 * kRows;
  static constexpr int kM = kAcc + kRows * DP;
  static constexpr int kL = kM + kRows;
  static constexpr int kWeights = kL + kRows;
  static constexpr int kSums = kWeights + kRows * kClusterMax;
  static constexpr int kMergeBytes = (kSums + kRows) * 4;
  static constexpr int kSmem =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static_assert((size_t)kSmem <= kSmemMax, "shared memory of a block");
};

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

// Four 8x8 bf16 matrices; lanes 8i .. 8i + 7 address the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 2^x, flushing results below 2^-126 to 0 (weights that small add nothing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every block of the cluster has arrived; its writes to shared memory
// before the barrier are visible to the others' reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address of `p` (this block's shared memory) in block `rank`'s.
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float peer_ld(unsigned addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(x)
               : "r"(addr)
               : "memory");
  return x;
}

__device__ __forceinline__ float2 peer_ld2(unsigned addr) {
  float2 x;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr)
               : "memory");
  return x;
}

template <int DP>
__global__ void __launch_bounds__(kBThreads)
    decode_mma_kernel(const BArgs a) {
  using R = Ring<DP>;
  constexpr int ST = R::kStages, LD = R::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const unsigned split = cluster_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int groups = a.H / a.KV, D = a.D, W = a.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row

  // this block's keys: stages [tb, te) of the row, keys [.., j_end)
  Args width{};  // row_keys reads W and the window only
  width.W = W;
  width.window = a.window;
  const RowKeys rk = row_keys(width, a.pos[b]);
  const int n_tiles = (rk.n + kStageKeys - 1) / kStageKeys;
  const int per = (n_tiles + a.splits - 1) / a.splits;
  const int tb = min(n_tiles, (int)split * per);
  const int te = min(n_tiles, tb + per);
  const int j_end = min(te * kStageKeys, rk.n);
  const int nt = te - tb;

  // columns D .. DP of every key row stay zero (nothing copies there)
  if (D < DP)
    for (int i = tid; i < ST * 2 * kStageKeys * (DP - D); i += kBThreads) {
      const int row = i / (DP - D), c = D + i % (DP - D);
      ring[row * LD + c] = __float2bfloat16(0.f);
    }

  const size_t kv_stride = (size_t)a.KV * D;  // elements between slots
  const __nv_bfloat16* kbase = a.k + ((size_t)b * W * a.KV + kvh) * D;
  const __nv_bfloat16* vbase = a.v + ((size_t)b * W * a.KV + kvh) * D;
  auto issue = [&](int tile, int stage) {
    __nv_bfloat16* ks = ring + stage * R::kStageElems;
    __nv_bfloat16* vs = ks + kStageKeys * LD;
    for (int i = tid; i < kStageKeys * (DP / 8); i += kBThreads) {
      const int key = i / (DP / 8), c = i % (DP / 8);
      if (c * 8 >= D) continue;
      const int j = tile * kStageKeys + key;
      const bool ok = j < j_end;
      int slot = rk.start + (ok ? j : 0);
      if (slot >= W) slot -= W;
      const size_t off = slot * kv_stride + c * 8;
      cp_async16(ks + key * LD + c * 8, kbase + off, ok ? 16 : 0);
      cp_async16(vs + key * LD + c * 8, vbase + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nt) issue(tb + s, s);
    cp_async_commit();
  }

  // Q as the A fragments of its DP / 16 column steps (rows past g zero)
  uint32_t qa[DP / 16][4];
  const __nv_bfloat16* qrow = a.q + ((size_t)b * a.H + kvh * groups) * D;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gq + (e & 1) * 8, c = kk * 16 + 2 * tq + (e >> 1) * 8;
      qa[kk][e] = (r < groups && c < D)
                      ? *reinterpret_cast<const uint32_t*>(qrow + r * D + c)
                      : 0u;
    }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // rows gq (a) and gq + 8 (b): running max (log2 units) and this lane's
  // share of the running sum
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<ST - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();          // everyone's; stage i - 1 is free
    if (i + ST - 1 < nt) issue(tb + i + ST - 1, (i + ST - 1) % ST);
    cp_async_commit();
    const int j0 = (tb + i) * kStageKeys + warp * 16;  // this warp's keys
    if (j0 >= j_end) continue;
    const __nv_bfloat16* ks =
        ring + (i % ST) * R::kStageElems + warp * 16 * LD;
    const __nv_bfloat16* vs = ks + kStageKeys * LD;

    // S (16 rows x 16 keys) = Q K^T
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + ((mi >> 1) * 8 + r8) * LD + kk * 16 + (mi & 1) * 8);
      mma_bf16(s[0], qa[kk], kb);
      mma_bf16(s[1], qa[kk], kb + 2);
    }
    // scale and mask: keys past the range weigh nothing; a row with no
    // valid key scores -1e30 everywhere (the uniform mean)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + c * 8 + 2 * tq + (e & 1);
        const float x = rk.masked ? kNegInf : s[c][e] * a.scale_log2;
        s[c][e] = j < j_end ? x : -INFINITY;
      }
    const float mx_a =
        quad_max(fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
    const float mx_b =
        quad_max(fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float c_a = ex2(m_a - mn_a), c_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      s[c][0] = ex2(s[c][0] - mn_a);
      s[c][1] = ex2(s[c][1] - mn_a);
      s[c][2] = ex2(s[c][2] - mn_b);
      s[c][3] = ex2(s[c][3] - mn_b);
    }
    l_a = l_a * c_a + (s[0][0] + s[0][1]) + (s[1][0] + s[1][1]);
    l_b = l_b * c_b + (s[0][2] + s[0][3]) + (s[1][2] + s[1][3]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= c_a;
      acc[n][1] *= c_a;
      acc[n][2] *= c_b;
      acc[n][3] *= c_b;
    }
    // O += P V: the probabilities are the A fragment of the 16 keys
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int nc = 0; nc < DP / 16; ++nc) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vs + ((mi & 1) * 8 + r8) * LD + nc * 16 +
                            (mi >> 1) * 8);
      mma_bf16(acc[2 * nc], pa, vb);
      mma_bf16(acc[2 * nc + 1], pa, vb + 2);
    }
  }
  cp_async_wait<0>();
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  __syncthreads();  // the ring is free: the merge's states take its place

  float* f = reinterpret_cast<float*>(smem_raw);
  float* wacc = f + R::kWarpAcc + warp * kRows * DP;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(wacc + gq * DP + c) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(wacc + (gq + 8) * DP + c) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (tq == 0) {
    f[R::kWarpM + warp * kRows + gq] = m_a;
    f[R::kWarpM + warp * kRows + gq + 8] = m_b;
    f[R::kWarpL + warp * kRows + gq] = l_a;
    f[R::kWarpL + warp * kRows + gq + 8] = l_b;
  }
  __syncthreads();
  // the block's state, the warps merged in warp order (a warp that saw no
  // key has l = 0 and weighs nothing)
  for (int i = tid; i < groups * DP; i += kBThreads) {
    const int r = i / DP, c = i % DP;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, f[R::kWarpM + w * kRows + r]);
    float x = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float lw = f[R::kWarpL + w * kRows + r];
      const float wt = lw > 0.f ? ex2(f[R::kWarpM + w * kRows + r] - mx) : 0.f;
      x += wt * f[R::kWarpAcc + (w * kRows + r) * DP + c];
      l += wt * lw;
    }
    f[R::kAcc + r * DP + c] = x;
    if (c == 0) {
      f[R::kM + r] = mx;
      f[R::kL + r] = l;
    }
  }
  cluster_sync();

  // every rank merges all ranks' states, in rank order, for its share of
  // the (row, column pair) outputs; each thread issues all its reads of
  // the other blocks' shared memory before it uses one, so their latencies
  // overlap
  const int S = a.splits;
  if (tid < groups) {
    float m_s[kClusterMax], l_s[kClusterMax];
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
      if (s < S) {
        m_s[s] = peer_ld(peer_addr(f + R::kM + tid, s));
        l_s[s] = peer_ld(peer_addr(f + R::kL + tid, s));
      }
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
      if (s < S) mx = fmaxf(mx, m_s[s]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
      if (s < S) {
        const float wt = l_s[s] > 0.f ? ex2(m_s[s] - mx) : 0.f;
        f[R::kWeights + tid * kClusterMax + s] = wt;
        l += wt * l_s[s];
      }
    f[R::kSums + tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int pairs = groups * D / 2;
  const int p_lo = (int)((long long)pairs * split / S);
  const int p_hi = (int)((long long)pairs * (split + 1) / S);
  __nv_bfloat16* orow = a.out + ((size_t)b * a.H + kvh * groups) * D;
  for (int i = p_lo + tid; i < p_hi; i += kBThreads) {
    const int r = 2 * i / D, c = 2 * i % D;
    float2 v[kClusterMax];
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
      if (s < S) v[s] = peer_ld2(peer_addr(f + R::kAcc + r * DP + c, s));
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
      if (s < S) {
        const float wt = f[R::kWeights + r * kClusterMax + s];
        x0 += wt * v[s].x;
        x1 += wt * v[s].y;
      }
    const float l = f[R::kSums + r];
    *reinterpret_cast<__nv_bfloat162*>(orow + r * D + c) =
        __floats2bfloat162_rn(x0 / l, x1 / l);
  }
  cluster_sync();  // no block leaves while another still reads its states
}

template <int DP>
int launch_mma(const BArgs& a, cudaStream_t stream) {
  using R = Ring<DP>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        R::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.KV, a.B);
  cfg.blockDim = dim3(kBThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, decode_mma_kernel<DP>, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. Pointers are device pointers
// to contiguous tensors of `dtype` (0 f32, 1 bf16): q and out (B, H, D),
// caches (B, W, KV, D); pos (B,) int32. f32: `splits` (<= 32) blocks a row
// with a workspace of splits * B * H * (D + 2) floats when splits > 1 (null
// otherwise). bf16: `splits` (<= 8) blocks of one cluster a row, no
// workspace (null), H / KV <= 16, D a multiple of 8 up to 256 and 16-byte-
// aligned tensors. Asynchronous on `stream`.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* pos, void* out,
                                void* workspace, int B, int H, int KV, int D,
                                int W, int window, float scale, int splits,
                                void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || D <= 0 || W <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const uintptr_t misaligned =
        reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
    if (H / KV > kRows || D % 8 != 0 || D > 256 || splits > kClusterMax ||
        workspace != nullptr || misaligned % 16 != 0 || B > 65535 ||
        KV > 65535)
      return (int)cudaErrorInvalidValue;
    BArgs a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.pos = static_cast<const int*>(pos);
    a.out = static_cast<__nv_bfloat16*>(out);
    a.B = B; a.H = H; a.KV = KV; a.D = D; a.W = W;
    a.window = window;
    a.scale_log2 = scale * 1.4426950408889634f;
    a.splits = splits;
    if (D <= 16) return launch_mma<16>(a, s);
    if (D <= 32) return launch_mma<32>(a, s);
    if (D <= 64) return launch_mma<64>(a, s);
    if (D <= 128) return launch_mma<128>(a, s);
    return launch_mma<256>(a, s);
  }
  if (dtype != kF32 || splits > kMaxSplits ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(H / KV, D) * sizeof(float);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;

  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.part = static_cast<float*>(workspace);
  a.B = B; a.H = H; a.KV = KV; a.D = D; a.W = W;
  a.window = window;
  a.scale = scale;
  a.splits = splits;
  a.vec = (D * 4) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return launch<float>(a, smem, s);
}

// The bf16 body's shape at tile width dp (16, 32, 64, 128 or 256): out =
// {keys a stage, stages, most splits a row, shared-memory bytes a block}
// (decode_attention.py's DENSE_KEYS and DENSE_MAX_SPLITS mirror the first
// and third). Returns 0, or cudaErrorInvalidValue for another dp.
extern "C" int decode_attention_bf16_ring(int dp, int* out) {
  int stages = 0, smem = 0;
  switch (dp) {
    case 16: stages = Ring<16>::kStages; smem = Ring<16>::kSmem; break;
    case 32: stages = Ring<32>::kStages; smem = Ring<32>::kSmem; break;
    case 64: stages = Ring<64>::kStages; smem = Ring<64>::kSmem; break;
    case 128: stages = Ring<128>::kStages; smem = Ring<128>::kSmem; break;
    case 256: stages = Ring<256>::kStages; smem = Ring<256>::kSmem; break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = kStageKeys;
  out[1] = stages;
  out[2] = kClusterMax;
  out[3] = smem;
  return 0;
}
