// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv_scan.py (rwkv_wkv /
// _wkv_kernel) with the function of src/repro/models/rwkv6.py::_chunked_wkv,
// which the reference model runs: per (batch, head), with a per-step log
// decay logw clamped to [-4, 0] by the caller,
//
//   out_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
//   S_t   = diag(exp(logw_t)) S_{t-1} + k_t^T v_t,
//
// evaluated chunk by chunk: inside a chunk of c <= 16 tokens, with cum the
// inclusive cumulative log decay and cum_excl = cum - logw,
//
//   out = (r e^cum_excl) S_start                         (inter)
//       + tril_{s<t}((r e^cum_excl)(k e^-cum)^T) v       (intra)
//       + (r . u k) v                                    (bonus)
//   S_end = e^total S_start + (k e^(total - cum))^T v.
//
// The contract is kernels/rwkv_scan.py::chunked_wkv_plain, the torch twin of
// _chunked_wkv; with a zero initial state and the final state dropped it is
// kernels/ref.py::rwkv_wkv_ref. All inputs are f32 in the model's own layout,
// r, k, v, logw (B, S, H, hd) and out (B, S, H, hd), u (H, hd), the states
// (B, H, hd, hd) with the key index first; no transpose to (B*H, S, hd).
//
// Bound on an H100: bytes at the shapes the port runs. A 1024-token prefill
// of rwkv6-1.6B's 32 heads x 64 moves 5 * 1024 * 32 * 64 * 4 bytes of
// sequence plus two 32 * 64 * 64 f32 states, 43 MB (12.8 us at 3.35 TB/s),
// against ~2.7e8 f32 flops (4 us at 67 TFLOP/s); a decode step of 4 rows
// moves 4.3 MB of state (1.3 us) and is bound in practice by the launch.
//
// Design (simple and correct first):
//   * a block per (value-column tile of 16, head, batch row): the columns of
//     S are independent, so a block keeps an (hd x 16) tile of the state in
//     shared memory through a loop over the chunks of its sequence. That
//     gives 4 blocks per (b, h) at hd = 64: 128 blocks for a 1-row prefill
//     of 32 heads, on 132 SMs;
//   * per chunk the block stages r, k, logw (c x hd) and its tile of v
//     (c x 16) in shared memory, forms the decay factors column by column,
//     and computes the (c x c) strictly lower scores, the inter, intra and
//     bonus terms and the state update with fmaf on the CUDA cores, in f32:
//     the contract is an f32 recurrence, and the model feeds it f32. The
//     scores are recomputed by each of a head's tiles (c*c*hd flops, small
//     beside the state update);
//   * the chunk is the caller's (fit_chunk of the sequence and the context's
//     rwkv_chunk, as on the plain path) and must be <= 16: exp(-cum) reaches
//     e^64 at 16 steps of the -4 clamp, inside f32 range; a chunk picked here
//     would change the rounding against the plain path;
//   * exact zeros: a front-padded row has r = k = v = 0 with a finite decay,
//     so every factor is finite and a zero state stays exactly zero;
//   * in place: s_final may be s0 (the serving cache row). Each block reads
//     its own slice of the state into shared memory before anything is
//     written, and writes only that slice, at the end;
//   * planted fault: skip_bonus != 0 leaves out the current-token bonus.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;      // value columns of the state per block
constexpr int kMaxChunk = 16;  // the -4 clamp bounds exp(-cum) only so far

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;  // may be null: a zero initial state
  float* out;
  float* s_final;   // may alias s0
  int B, S, H, chunk, skip_bonus;
};

template <int HD>
__global__ void __launch_bounds__(kThreads) wkv_kernel(Args p) {
  __shared__ float sS[HD][kTile];        // the state tile, S[key][value]
  __shared__ float sR[kMaxChunk][HD];    // r
  __shared__ float sK[kMaxChunk][HD];    // k
  __shared__ float sRi[kMaxChunk][HD];   // r * exp(cum_excl)
  __shared__ float sKn[kMaxChunk][HD];   // k * exp(-cum)
  __shared__ float sKo[kMaxChunk][HD];   // k * exp(total - cum)
  __shared__ float sC[kMaxChunk][HD];    // logw, then cum
  __shared__ float sV[kMaxChunk][kTile];
  __shared__ float sA[kMaxChunk][kMaxChunk];  // strictly lower scores
  __shared__ float sB[kMaxChunk];        // bonus r_t . (u * k_t)
  __shared__ float sT[HD];               // exp(total)

  const int j0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = p.H, S = p.S, c = p.chunk;
  const size_t state_base = ((size_t)b * H + h) * HD * HD;

  // this block's slice of the state, read before anything is written
  for (int i = tid; i < HD * kTile; i += kThreads) {
    const int d = i / kTile, j = i % kTile;
    sS[d][j] = p.s0 ? p.s0[state_base + (size_t)d * HD + j0 + j] : 0.f;
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = 0; t0 < S; t0 += c) {
    __syncthreads();  // the previous chunk is done with the staged rows
    for (int i = tid; i < c * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const size_t off = (((size_t)b * S + t0 + t) * H + h) * HD + d;
      sR[t][d] = p.r[off];
      sK[t][d] = p.k[off];
      sC[t][d] = p.lw[off];
    }
    for (int i = tid; i < c * kTile; i += kThreads) {
      const int t = i / kTile, j = i % kTile;
      sV[t][j] = p.v[(((size_t)b * S + t0 + t) * H + h) * HD + j0 + j];
    }
    __syncthreads();

    // bonus: one warp per token, lanes over the key dim
    for (int t = warp; t < c; t += kThreads / 32) {
      float acc = 0.f;
      for (int d = lane; d < HD; d += 32)
        acc += sR[t][d] * (sK[t][d] * p.u[h * HD + d]);
      for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) sB[t] = acc;
    }
    // decay factors: one thread per key column, serial over the chunk
    for (int d = tid; d < HD; d += kThreads) {
      float cum = 0.f;
      for (int t = 0; t < c; ++t) {
        const float w = sC[t][d];
        cum += w;
        const float cex = cum - w;
        sC[t][d] = cum;
        sRi[t][d] = sR[t][d] * expf(cex);
        sKn[t][d] = sK[t][d] * expf(-cum);
      }
      sT[d] = expf(cum);
      for (int t = 0; t < c; ++t) sKo[t][d] = sK[t][d] * expf(cum - sC[t][d]);
    }
    __syncthreads();

    // scores (t, s), s < t only: the other entries are never read
    const int t = tid / kTile, j = tid % kTile;  // also (token, column)
    {
      const int ts = tid / kMaxChunk, ss = tid % kMaxChunk;
      if (ts < c && ss < ts) {
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) acc = fmaf(sRi[ts][d], sKn[ss][d], acc);
        sA[ts][ss] = acc;
      }
    }
    // inter: r_t reads the state decayed to t - 1
    float inter = 0.f;
    if (t < c) {
#pragma unroll 8
      for (int d = 0; d < HD; ++d) inter = fmaf(sRi[t][d], sS[d][j], inter);
    }
    __syncthreads();
    if (t < c) {
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra = fmaf(sA[t][s], sV[s][j], intra);
      if (!p.skip_bonus) intra = intra + sB[t] * sV[t][j];
      p.out[(((size_t)b * S + t0 + t) * H + h) * HD + j0 + j] = inter + intra;
    }
    // state update: every read of sS for this chunk is behind the barrier
    for (int i = tid; i < HD * kTile; i += kThreads) {
      const int d = i / kTile, jj = i % kTile;
      float acc = 0.f;
      for (int s = 0; s < c; ++s) acc = fmaf(sKo[s][d], sV[s][jj], acc);
      sS[d][jj] = sS[d][jj] * sT[d] + acc;
    }
  }
  // each thread writes back the entries it updated last
  for (int i = tid; i < HD * kTile; i += kThreads) {
    const int d = i / kTile, j = i % kTile;
    p.s_final[state_base + (size_t)d * HD + j0 + j] = sS[d][j];
  }
}

template <int HD>
int launch(const Args& p, cudaStream_t s) {
  const dim3 grid(HD / kTile, p.H, p.B);
  wkv_kernel<HD><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t. r, k, v, lw, out: (B, S, H, hd) f32 device
// pointers, contiguous; u (H, hd); s0 (B, H, hd, hd) or null for zeros;
// s_final (B, H, hd, hd), which may be s0. hd in {16, 64}; 1 <= chunk
// <= 16 and chunk divides S. Asynchronous on `stream`.
extern "C" int rwkv_wkv(const float* r, const float* k, const float* v,
                        const float* lw, const float* u, const float* s0,
                        float* out, float* s_final, int B, int S, int H,
                        int hd, int chunk, int skip_bonus, void* stream) {
  if (B < 1 || S < 1 || H < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (chunk < 1 || chunk > kMaxChunk || S % chunk)
    return (int)cudaErrorInvalidValue;
  Args p{r, k, v, lw, u, s0, out, s_final, B, S, H, chunk, skip_bonus};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, s);
    case 64: return launch<64>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
