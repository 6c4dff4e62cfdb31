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
// Design (simple and correct first; no TMA or tensor cores):
//   * a block owns one (row b, KV head, split of the row's valid keys); its
//     query rows are the H / KV heads that share the KV head, so each key is
//     read from device memory once per block and used by all of them (the
//     TPU kernel's GQA fold);
//   * it streams only the valid keys: the absolute positions
//     [max(pos - W, pos - window, 0), pos) map to slots position % W, a
//     range that may wrap around the ring, so any W and any pos work (the
//     Pallas kernel needed W % block_k == 0); a row with no valid key
//     streams all W slots at -1e30;
//   * B * KV blocks are far fewer than the 132 SMs at decode batch sizes,
//     so each row's keys are split over `splits` blocks whose partial
//     softmax states (m, l, acc) a second kernel merges (flash-decoding);
//   * a block stages 32 keys of K and V at a time in fp32 shared memory with
//     16-byte loads, several in flight per thread; scores, the online
//     softmax and the accumulator stay in fp32 and every product runs on
//     the CUDA cores in fp32 (never TF32), so an f32 run agrees with the
//     plain version to f32 rounding.

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

}  // namespace

// Splits of each row's keys for a shape: enough blocks to fill the card
// twice, at most one per tile of W keys. The caller provides a workspace of
// splits * B * H * (D + 2) floats when it is > 1.
extern "C" int decode_attention_splits(int B, int KV, int W, int num_sms) {
  const int blocks = B * KV;
  if (blocks <= 0 || W <= 0) return 1;
  if (blocks >= num_sms) return 1;
  int s = (2 * num_sms + blocks - 1) / blocks;
  const int tiles = (W + kTileKeys - 1) / kTileKeys;
  if (s > tiles) s = tiles;
  if (s > kMaxSplits) s = kMaxSplits;
  return s < 1 ? 1 : s;
}

// Returns 0 or the cudaError_t of the launch. Pointers are device pointers
// to contiguous tensors of `dtype` (0 f32, 1 bf16): q and out (B, H, D),
// caches (B, W, KV, D); pos (B,) int32; workspace as decode_attention_splits
// says (null when splits == 1). Asynchronous on `stream`.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* pos, void* out,
                                void* workspace, int B, int H, int KV, int D,
                                int W, int window, float scale, int splits,
                                void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || D <= 0 || W <= 0 || splits <= 0 ||
      splits > kMaxSplits || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(H / KV, D) * sizeof(float);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;

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
  a.vec = (D * elem) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(a, smem, s);
    case kBF16: return launch<__nv_bfloat16>(a, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
