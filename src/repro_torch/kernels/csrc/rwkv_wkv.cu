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
// Bound on an H100 (bytes; 3.35 TB/s): a 1024-token bucketed prefill of
// rwkv6-1.6B's 32 heads x 64 reads r, k, v, logw and writes out, 5 * 1024 *
// 32 * 64 * 4 bytes, plus the final state, 43 MB: 12.7 us (the f32 work,
// ~6.7e8 flops counted as 4 hd^2 + 4 c hd a token and head, is 10 us at 67
// TFLOP/s). The serve's other buckets (512, 256, 128, 64) scale with S. A
// decode step of 4 rows reads and writes 4 * 32 * 64 * 64 * 4 bytes of
// state, 4.2 MB: 1.3 us.
//
// The work splits because the columns and rows of the state update
// S' = diag(e^total) S + (k e^(total - cum))^T v are independent, the
// decay factors of a chunk depend on that chunk's logw alone, and only the
// state carries from chunk to chunk. The host plan (rwkv_scan.wkv_plan)
// picks one of three bodies; an entry call is one counted launch whatever
// it runs:
//
//   * "split" (more than one group of G chunks), three kernels:
//     - wkv_state_pass, a block a (group, head, batch row): the group's
//       contribution to the state from a zero start, Delta_g, and its
//       decay D_g (the product of its chunks' e^total), into the group's
//       slot of a scratch tensor (B, H, groups, hd + 1, hd) that the
//       wrapper allocates. The groups run in parallel: the serial walk is G
//       chunks long, not the whole sequence.
//     - wkv_state_scan, a thread a float4 of a head's state: S = s0 (or
//       zeros), then for each group in order its start state written over
//       its slot and S = D_g S + Delta_g, the loads of 8 groups in flight;
//       then the final state (read before written: in place is safe).
//     - wkv_output_pass, a block a (group, head, batch row): the group's
//       start state from its slot (never s0, which the scan may have
//       overwritten in place), then its G chunks with its own copy of the
//       state in shared memory. The B * H * groups blocks run in parallel.
//   * wkv_onepass (one chunk, or a few chunks of so few heads that a split
//     could not fill half the card: spans, the smoke shapes): the output
//     pass's body started from s0 (or zeros) that also updates after its
//     last chunk and writes the final state.
//   * wkv_decode (S 1, chunk 1): a streaming pass over the state, a float4
//     of it a thread: one reduction over the key rows for out, one barrier.
//
// A chunk body (state, output and one pass; 256 threads) stages r, k, logw
// and v of the next chunk by 16-byte cp.async copies while it computes this
// one, then: the decay factors once for the whole head, all threads over
// (token, key); the strictly lower scores and the inter term (a 4-token x
// 4-column tile over a quarter of the keys a thread, the quarters summed by
// a shuffle reduce-scatter); the intra and bonus terms and out; the state
// update (a 4 x 4 tile of the state a thread). Three barriers a chunk (one
// in the state pass, which has no outputs, plus its update's).
//
// What the bodies do about the faults of the single block that walked every
// chunk before them:
//   1. one block a value tile walked all the chunks in series (128 blocks
//      at a 1-row prefill): the state pass walks G chunks a block and the
//      groups run in parallel; only the scan is serial, one fmaf an entry a
//      group;
//   2. synchronous loads, a barrier behind them: the next chunk's copies
//      (and the start state's) are in flight while this chunk computes;
//   3. the decay factors as a serial chain on a quarter of the block: cum
//      is summed in order t = 0..c-1 (as the plain version does: a tree
//      would change its rounding, which e^(+-cum) carries up to e^64), by
//      every thread for the four tokens it owns, and the exponentials are
//      spread over (token, key): 4 tokens x 3 expf a thread a chunk;
//   4. every value tile recomputed the whole head's factors and scores:
//      a block holds the whole head, so they are computed once;
//   5. the 16-way bank conflict of the score phase (row stride 64 words):
//      r and k are staged with rows padded to hd + 4 words and the state to
//      hd + 8, so the rows a quarter-warp reads as float4 fall in distinct
//      banks; r e^cum_excl is also kept key-major for the inter tiles;
//   6. decode ran the chunk body with four barriers: wkv_decode is one pass
//      of 16-byte loads with one barrier.
// The token loops carry no branch a token: rows c..15 of the staged chunks
// are zero (set once a block), and add exact zeros.
//
// Precision: f32 on the CUDA cores throughout (the contract is an f32
// recurrence; TF32 would break the token equality the checks hold), expf
// and not __expf (exp(-cum) reaches e^64 at chunk 16 and the -4 clamp,
// where the fast exponential's error grows with the argument), no fast
// math. The group decays are products of the chunks' e^total and the scan
// adds the groups' contributions: the plain version's terms, in another
// fp32 order. Deterministic: no atomics, and the same bits in place as out
// of place.
//
// Exact zeros: a front-padded row has r = k = v = 0 with a finite decay, so
// every factor is finite and a zero state stays exactly zero.
//
// Planted faults for the checks: skip_bonus leaves out the current-token
// bonus (every body); stale_state has the output pass start each group from
// the state one group behind, group 0 from zeros (a no-op on the one-pass
// and decode bodies, which have one group).
//
// Measured (chip_smoke.py's device_ms over 20 L2-flushed launches, NVIDIA
// H100 80GB HBM3, 700.00 W; the single-block walk before it in brackets,
// in the same run): the 1024-token prefill 0.0662 ms [0.5344], of which
// the output pass is about two thirds (its sweep: state pass 0.0193, scan
// 0.0038, output pass 0.0438 at G 8; all 64 chunks in one group 0.2747);
// a decode step of 4 rows 0.0039 [0.0070]; 16-token spans of 4 rows
// 0.0076 [0.0188]; a 256-token prefill 0.0235 [0.1342]. PERF.md has every
// case and what holds the prefill at 5.2x its byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 16;  // the -4 clamp bounds exp(-cum) only so far
constexpr int kThreads = 256;  // output and one-pass blocks
constexpr int kPad = 4;        // row padding of the staged r and k (floats)
constexpr int kStages = 2;     // the chunk ring of a chunk body

enum Body { kDecode = 0, kOnePass = 1, kSplit = 2 };

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;  // may be null: a zero initial state
  float* out;
  float* s_final;   // may alias s0
  float* scratch;   // (B, H, n_groups, hd + 1, hd) groups' states (split)
  int B, S, H, chunk, group, n_groups, skip_bonus, stale_state;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// acc[t] summed over the 4 lanes of a quad (lane bits 0-1, iq): the lane
// keeps token 2 (iq & 1) + (iq >> 1) of the 4
__device__ __forceinline__ float4 reduce_scatter4(const float4* acc, int iq) {
  const bool b0 = iq & 1, b1 = iq & 2;
  float4 keep[2];
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) {  // lanes b0 keep tokens 2, 3
    const float4 mine = b0 ? acc[tt + 2] : acc[tt];
    const float4 give = b0 ? acc[tt] : acc[tt + 2];
    keep[tt] = make_float4(
        mine.x + __shfl_xor_sync(0xffffffffu, give.x, 1),
        mine.y + __shfl_xor_sync(0xffffffffu, give.y, 1),
        mine.z + __shfl_xor_sync(0xffffffffu, give.z, 1),
        mine.w + __shfl_xor_sync(0xffffffffu, give.w, 1));
  }
  const float4 mine = b1 ? keep[1] : keep[0];
  const float4 give = b1 ? keep[0] : keep[1];
  return make_float4(mine.x + __shfl_xor_sync(0xffffffffu, give.x, 2),
                     mine.y + __shfl_xor_sync(0xffffffffu, give.y, 2),
                     mine.z + __shfl_xor_sync(0xffffffffu, give.z, 2),
                     mine.w + __shfl_xor_sync(0xffffffffu, give.w, 2));
}

// zero `bytes` (a multiple of 16) of shared memory with `nt` threads
__device__ __forceinline__ void zero_smem(void* base, size_t bytes, int nt) {
  float4* p = reinterpret_cast<float4*>(base);
  for (size_t i = threadIdx.x; i < bytes / 16; i += nt)
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// offset of row (b, t, h) of a (B, S, H, HD) tensor
__device__ __forceinline__ size_t row_of(const Args& p, int b, int t, int h,
                                         int hd) {
  return (((size_t)b * p.S + t) * p.H + h) * hd;
}

// -------------------------------------------- state, output, one pass
// Block (group, head, batch row), 256 threads, the whole head. Per
// chunk: decay factors over (t, d) -> scores and inter -> intra, bonus,
// out and the state update; three barriers (the state pass, without
// outputs, two), the next chunk's copies in flight behind them.

template <int HD>
struct ChunkSmem {
  float S[HD][HD + 2 * kPad];           // the state
  float R[kStages][kMaxChunk][HD + kPad];  // r, then r e^cum_excl in place
  float K[kStages][kMaxChunk][HD + kPad];  // k, then k e^(total - cum)
  float W[kStages][kMaxChunk][HD];         // logw
  float V[kStages][kMaxChunk][HD];         // v
  float Kn[kMaxChunk][HD + kPad];       // k e^-cum
  float RiT[HD][kMaxChunk + 8];         // r e^cum_excl, key-major
  float A[kMaxChunk][kMaxChunk + 1];    // strictly lower scores
  float T[HD];                          // e^total
  float Bon[kMaxChunk][HD >= 32 ? HD / 32 : 1];  // bonus partial sums
};

// kOutput: outputs of a group from its start state in the scratch;
// kOnePass: outputs and the final state from s0; kLocal: the group's
// contribution to the state from a zero start (no outputs), written with
// the group's decay over the group's start state in the scratch
enum class Mode { kOutput, kOnePass, kLocal };

template <int HD, Mode MODE>
__device__ __forceinline__ void chunk_body(const Args& p, ChunkSmem<HD>& sm) {
  constexpr bool OUT = MODE != Mode::kLocal;
  constexpr int TQ = kThreads / HD;     // token slots of the decay phase
  constexpr int TPT = kMaxChunk / TQ;   // contiguous tokens a slot
  constexpr int RED = HD >= 32 ? 32 : HD;  // lanes of a bonus partial
  constexpr int Q = HD / 4;             // float4 columns of a row
  const int tid = threadIdx.x;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c = p.chunk, nc = p.S / c;
  const int first = g * p.group;
  const int n = min(p.group, nc - first);  // chunks of this block
  const size_t head = (size_t)b * p.H + h;

  float* slot = MODE == Mode::kLocal
                    ? p.scratch + (head * p.n_groups + g) * (HD + 1) * HD
                    : nullptr;
  // the start state: scratch (output pass), s0 / zeros (one pass), zeros
  const float* src = nullptr;
  if (MODE == Mode::kOnePass) {
    if (p.s0) src = p.s0 + head * HD * HD;
  } else if (MODE == Mode::kOutput) {
    const int sg = p.stale_state ? g - 1 : g;  // planted fault: one behind
    if (sg >= 0) src = p.scratch + (head * p.n_groups + sg) * (HD + 1) * HD;
  }
  // rows c..15 of the staged chunks and the scores stay zero: the token
  // loops below run without a branch a token and add exact zeros there
  zero_smem(&sm.R, sizeof(sm) - sizeof(sm.S), kThreads);
  __syncthreads();
  for (int it = tid; it < HD * Q; it += kThreads) {  // with chunk 0's copies
    const int d = it / Q, jq = it % Q;
    if (src)
      cp_async16(&sm.S[d][4 * jq], src + (size_t)d * HD + 4 * jq);
    else
      st4(&sm.S[d][4 * jq], make_float4(0.f, 0.f, 0.f, 0.f));
  }

  auto load = [&](int i) {  // chunk first + i into stage i % kStages
    if (i >= n) return;
    const int st = i % kStages, t0 = (first + i) * c;
    for (int e = tid; e < c * Q; e += kThreads) {  // r, k, logw, v rows
      const int t = e / Q, x = 4 * (e % Q);
      const size_t off = row_of(p, b, t0 + t, h, HD) + x;
      if (OUT) cp_async16(&sm.R[st][t][x], p.r + off);
      cp_async16(&sm.K[st][t][x], p.k + off);
      cp_async16(&sm.W[st][t][x], p.lw + off);
      cp_async16(&sm.V[st][t][x], p.v + off);
    }
  };

  const int d = tid % HD, tq = tid / HD;  // decay phase: (token slot, key)
  const float ud = OUT ? p.u[h * HD + d] : 0.f;
  float decay = 1.f;  // kLocal: the group's decay of key row d
  // inter phase: a 4-token x 4-column tile over a quarter of the keys
  // (d = 4 k + iq), the quarters in the lanes' low bits; after the reduce-
  // scatter a thread owns one (token, column quad) of out
  const bool has_tile = tid < 16 * Q;  // whole warps
  const int iq = tid % 4, tg = (tid / 4) % 4, oq = tid / 16;
  const int ot = 4 * tg + 2 * (iq & 1) + (iq >> 1);
  const bool has_out = has_tile && ot < c;
  const int ss = tid % kMaxChunk, ts = tid / kMaxChunk;  // score pair

  for (int i = 0; i < kStages - 1; ++i) {  // chunk 0 with the start state
    load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    cp_async_wait<kStages - 2>();  // chunk i landed (this thread's copies)
    __syncthreads();  // ... everyone's; the last chunk's update is done and
                      // its stage free
    load(i + kStages - 1);
    cp_async_commit();

    // decay factors, once for the whole head: cum in order t = 0..c-1
    float cum = 0.f, cw[TPT], cx[TPT], part[TPT];
#pragma unroll
    for (int t = 0; t < kMaxChunk; ++t) {  // zero logw past c
      const float w = sm.W[st][t][d];
      cum += w;
      if (t / TPT == tq) {
        cw[t % TPT] = cum;
        cx[t % TPT] = cum - w;
      }
    }
    float ri[TPT];
#pragma unroll
    for (int j = 0; j < TPT; ++j) {  // zero r and k past c: zero factors
      const int t = tq * TPT + j;
      const float kk = sm.K[st][t][d];
      if (OUT) {
        const float rr = sm.R[st][t][d];
        part[j] = rr * (kk * ud);
        ri[j] = rr * expf(cx[j]);
        sm.R[st][t][d] = ri[j];
        sm.Kn[t][d] = kk * expf(-cw[j]);
      }
      sm.K[st][t][d] = kk * expf(cum - cw[j]);
    }
    if constexpr (OUT) {
      if constexpr (TPT == 4)
        st4(&sm.RiT[d][tq * TPT], make_float4(ri[0], ri[1], ri[2], ri[3]));
      else
#pragma unroll
        for (int j = 0; j < TPT; ++j) sm.RiT[d][tq * TPT + j] = ri[j];
    }
    if (tq == 0) {
      const float et = expf(cum);
      sm.T[d] = et;
      decay *= et;
    }
    if (OUT) {
#pragma unroll
      for (int j = 0; j < TPT; ++j) {  // bonus partials over RED key dims
        float x = part[j];
#pragma unroll
        for (int o = RED / 2; o > 0; o /= 2)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        if (d % RED == 0) sm.Bon[tq * TPT + j][d / RED] = x;
      }
    }
    __syncthreads();

    // scores, s < t (the zero-filled entries s >= t stay zero)
    if (OUT && ts < c && ss < ts) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int e = 0; e < HD; e += 4) {
        const float4 a = ld4(&sm.R[st][ts][e]), bb = ld4(&sm.Kn[ss][e]);
        acc.x = fmaf(a.x, bb.x, acc.x);
        acc.y = fmaf(a.y, bb.y, acc.y);
        acc.z = fmaf(a.z, bb.z, acc.z);
        acc.w = fmaf(a.w, bb.w, acc.w);
      }
      sm.A[ts][ss] = (acc.x + acc.y) + (acc.z + acc.w);
    }
    // inter: r_t reads the state decayed to t - 1
    float4 inter = make_float4(0.f, 0.f, 0.f, 0.f);
    if (OUT && has_tile) {
      float4 acc[4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) acc[tt] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int k = 0; k < HD / 4; ++k) {
        const float4 rt = ld4(&sm.RiT[4 * k + iq][4 * tg]);
        const float4 sv = ld4(&sm.S[4 * k + iq][4 * oq]);
        fma4(acc[0], rt.x, sv);
        fma4(acc[1], rt.y, sv);
        fma4(acc[2], rt.z, sv);
        fma4(acc[3], rt.w, sv);
      }
      inter = reduce_scatter4(acc, iq);
    }
    if (OUT) __syncthreads();  // scores visible; every read of S is done

    if (OUT && has_out) {
      float4 intra = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < c; s0 += 4)  // A[t][s] = 0 for s >= t
#pragma unroll
        for (int s = s0; s < s0 + 4; ++s)
          fma4(intra, sm.A[ot][s], ld4(&sm.V[st][s][4 * oq]));
      if (!p.skip_bonus) {
        float bon = 0.f;
        for (int e = 0; e < HD / RED; ++e) bon += sm.Bon[ot][e];
        fma4(intra, bon, ld4(&sm.V[st][ot][4 * oq]));
      }
      const int t = (first + i) * c + ot;
      st4(p.out + row_of(p, b, t, h, HD) + 4 * oq,
          make_float4(inter.x + intra.x, inter.y + intra.y,
                      inter.z + intra.z, inter.w + intra.w));
    }
    // the state update, skipped after an output block's last chunk
    if (MODE != Mode::kOutput || i + 1 < n) {
      for (int it = tid; it < Q * Q; it += kThreads) {
        const int dq = it / Q, jq = it % Q;
        float4 acc[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int t0 = 0; t0 < c; t0 += 4) {  // zero k_out past c
#pragma unroll
          for (int t = t0; t < t0 + 4; ++t) {
            const float4 ko = ld4(&sm.K[st][t][4 * dq]);
            const float4 vv = ld4(&sm.V[st][t][4 * jq]);
            fma4(acc[0], ko.x, vv);
            fma4(acc[1], ko.y, vv);
            fma4(acc[2], ko.z, vv);
            fma4(acc[3], ko.w, vv);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int row = 4 * dq + rr;
          const float tt = sm.T[row];
          float4 sv = ld4(&sm.S[row][4 * jq]);
          sv = make_float4(sv.x * tt + acc[rr].x, sv.y * tt + acc[rr].y,
                           sv.z * tt + acc[rr].z, sv.w * tt + acc[rr].w);
          st4(&sm.S[row][4 * jq], sv);
        }
      }
    }
  }
  if (MODE != Mode::kOutput) {  // the final state (one pass, the head's,
                                // read at the start) or the group's contribution
    __syncthreads();
    float* dst = MODE == Mode::kOnePass ? p.s_final + head * HD * HD : slot;
    for (int it = tid; it < HD * Q; it += kThreads) {
      const int dd = it / Q, jq = it % Q;
      st4(dst + (size_t)dd * HD + 4 * jq, ld4(&sm.S[dd][4 * jq]));
    }
    if (MODE == Mode::kLocal && tq == 0) slot[HD * HD + d] = decay;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 3) wkv_state_pass(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  chunk_body<HD, Mode::kLocal>(p, *reinterpret_cast<ChunkSmem<HD>*>(smem_raw));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 3) wkv_output_pass(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  chunk_body<HD, Mode::kOutput>(p, *reinterpret_cast<ChunkSmem<HD>*>(smem_raw));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 3) wkv_onepass(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  chunk_body<HD, Mode::kOnePass>(p, *reinterpret_cast<ChunkSmem<HD>*>(smem_raw));
}

// ------------------------------------------------------------- state scan
// S_{g+1} = D_g S_g + Delta_g over the groups, in order: a thread owns one
// float4 of a head's state, reads each group's contribution from its slot
// and writes the group's start state over it. Then the final state.

constexpr int kScanBatch = 8;  // groups whose loads are in flight at once

template <int HD>
__host__ __device__ constexpr int scan_threads() {
  return HD * HD / 4 < kThreads ? HD * HD / 4 : kThreads;
}

template <int HD>
__global__ void __launch_bounds__(scan_threads<HD>()) wkv_state_scan(Args p) {
  constexpr int Q = HD / 4;
  const int it = blockIdx.x * scan_threads<HD>() + threadIdx.x;
  const int d = it / Q, jq = it % Q;
  const size_t head = (size_t)blockIdx.z * p.H + blockIdx.y;
  const size_t at = (size_t)d * HD + 4 * jq;
  float4 s = p.s0 ? ld4(p.s0 + head * HD * HD + at)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  float* slots = p.scratch + head * p.n_groups * (HD + 1) * HD;
  for (int g0 = 0; g0 < p.n_groups; g0 += kScanBatch) {
    float4 delta[kScanBatch];
    float dec[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (g0 + j < p.n_groups) {
        const float* slot = slots + (size_t)(g0 + j) * (HD + 1) * HD;
        delta[j] = ld4(slot + at);
        dec[j] = slot[HD * HD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (g0 + j < p.n_groups) {
        st4(slots + (size_t)(g0 + j) * (HD + 1) * HD + at, s);
        s = make_float4(s.x * dec[j] + delta[j].x, s.y * dec[j] + delta[j].y,
                        s.z * dec[j] + delta[j].z, s.w * dec[j] + delta[j].w);
      }
    }
  }
  st4(p.s_final + head * HD * HD + at, s);
}

// ----------------------------------------------------------------- decode
// S 1, chunk 1: cum = logw, cum_excl = 0, so out = r S + (r . u k) v and
// S' = e^logw S + k^T v. Block (16 value columns, head, batch row); a thread
// owns one float4 of the state: key row tid / 4, columns 4 (tid % 4).

constexpr int kDecodeCols = 16;

template <int HD>
__global__ void __launch_bounds__(HD * kDecodeCols / 4) wkv_decode(Args p) {
  constexpr int Q = kDecodeCols / 4;
  constexpr int NW = HD * Q / 32;  // warps
  __shared__ float red[NW][kDecodeCols + 1];
  const int j0 = blockIdx.x * kDecodeCols, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, d = tid / Q, q = tid % Q;
  const size_t x = ((size_t)b * p.H + h) * HD;  // row (b, 0, h)
  const size_t at = x * HD + (size_t)d * HD + j0 + 4 * q;
  const float rd = p.r[x + d], kd = p.k[x + d], w = p.lw[x + d];
  const float4 vj = ld4(p.v + x + j0 + 4 * q);
  const float4 s = p.s0 ? ld4(p.s0 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
  float a[5] = {rd * s.x, rd * s.y, rd * s.z, rd * s.w,
                rd * (kd * p.u[h * HD + d])};
#pragma unroll
  for (int o = 16; o >= Q; o /= 2)
#pragma unroll
    for (int e = 0; e < 5; ++e) a[e] += __shfl_xor_sync(0xffffffffu, a[e], o);
  const int lane = tid % 32, warp = tid / 32;
  if (lane < Q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][4 * lane + e] = a[e];
    if (lane == 0) red[warp][kDecodeCols] = a[4];
  }
  // the new state: this thread's float4, read above, written here
  const float ew = expf(w);
  st4(p.s_final + at, make_float4(s.x * ew + kd * vj.x, s.y * ew + kd * vj.y,
                                  s.z * ew + kd * vj.z, s.w * ew + kd * vj.w));
  __syncthreads();
  if (tid < kDecodeCols) {
    float inter = 0.f, bon = 0.f;
    for (int wi = 0; wi < NW; ++wi) {
      inter += red[wi][tid];
      bon += red[wi][kDecodeCols];
    }
    const float vv = p.v[x + j0 + tid];
    p.out[x + j0 + tid] = p.skip_bonus ? inter : inter + bon * vv;
  }
}

// ------------------------------------------------------------------ host

template <int HD>
size_t chunk_smem() {
  return sizeof(ChunkSmem<HD>);
}

template <int HD>
int grids(const Args& p, int body, int* o) {
  // o: state pass grid x, y, z, threads; body grid x, y, z, threads;
  // dynamic shared memory of a chunk body; scan grid x, y, z, threads
  for (int i = 0; i < 13; ++i) o[i] = 0;
  if (body == kDecode) {
    o[4] = HD / kDecodeCols > 0 ? HD / kDecodeCols : 1;
    o[5] = p.H;
    o[6] = p.B;
    o[7] = HD * kDecodeCols / 4;
    return 0;
  }
  o[4] = p.n_groups;
  o[5] = p.H;
  o[6] = p.B;
  o[7] = kThreads;
  o[8] = (int)chunk_smem<HD>();
  if (body == kSplit) {
    for (int i = 0; i < 4; ++i) o[i] = o[4 + i];
    o[9] = HD * HD / 4 / scan_threads<HD>();
    o[10] = p.H;
    o[11] = p.B;
    o[12] = scan_threads<HD>();
  }
  return 0;
}

template <int HD>
int launch(const Args& p, int body, cudaStream_t s) {
  int o[13];
  grids<HD>(p, body, o);
  if (body == kDecode) {
    wkv_decode<HD><<<dim3(o[4], o[5], o[6]), o[7], 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  const size_t smem = chunk_smem<HD>();
  static bool ready = false;
  if (!ready) {
    int rc = 0;
    for (auto fn : {wkv_state_pass<HD>, wkv_output_pass<HD>, wkv_onepass<HD>})
      if (!rc)
        rc = (int)cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    ready = true;
  }
  if (body == kOnePass) {
    wkv_onepass<HD><<<dim3(o[4], o[5], o[6]), o[7], smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  wkv_state_pass<HD><<<dim3(o[0], o[1], o[2]), o[3], smem, s>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  wkv_state_scan<HD><<<dim3(o[9], o[10], o[11]), o[12], 0, s>>>(p);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  wkv_output_pass<HD><<<dim3(o[4], o[5], o[6]), o[7], smem, s>>>(p);
  return (int)cudaGetLastError();
}

// the plan's numbers checked against what the built bodies take
int check(const Args& p, int hd, int body) {
  if (p.B < 1 || p.S < 1 || p.H < 1 || p.H > 65535 || p.B > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.chunk < 1 || p.chunk > kMaxChunk || p.S % p.chunk)
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 64) return (int)cudaErrorInvalidValue;
  const int nc = p.S / p.chunk;
  if (body == kDecode) return p.S == 1 ? 0 : (int)cudaErrorInvalidValue;
  if (body != kOnePass && body != kSplit) return (int)cudaErrorInvalidValue;
  if (p.group < 1 || p.n_groups != (nc + p.group - 1) / p.group)
    return (int)cudaErrorInvalidValue;
  if (body == kOnePass && p.n_groups != 1) return (int)cudaErrorInvalidValue;
  if (body == kSplit && !p.scratch) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Returns 0 or a cudaError_t. r, k, v, lw, out: (B, S, H, hd) f32 device
// pointers, contiguous and 16-byte aligned; u (H, hd); s0 (B, H, hd, hd) or
// null for zeros; s_final (B, H, hd, hd), which may be s0; scratch (B, H,
// n_groups, hd + 1, hd) for the split body, else null: a group's state
// rows, then its decay. hd in {16, 64}; 1 <=
// chunk <= 16 and chunk divides S. body: 0 decode (S 1), 1 one pass
// (n_groups 1), 2 state pass + output pass; group: chunks a group.
// Asynchronous on `stream`.
extern "C" int rwkv_wkv(const float* r, const float* k, const float* v,
                        const float* lw, const float* u, const float* s0,
                        float* out, float* s_final, float* scratch, int B,
                        int S, int H, int hd, int chunk, int body, int group,
                        int n_groups, int skip_bonus, int stale_state,
                        void* stream) {
  Args p{r, k, v, lw, u, s0, out, s_final, scratch, B, S, H, chunk, group,
         n_groups, skip_bonus, stale_state};
  const int rc = check(p, hd, body);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 16 ? launch<16>(p, body, s) : launch<64>(p, body, s);
}

// The grids a call with these numbers launches: out[0..3] the state pass's
// grid and threads (zeros without one), out[4..7] the output, one-pass or
// decode body's, out[8] the dynamic shared memory of a chunk body (zero for
// decode), out[9..12] the state scan's grid and threads (zeros without
// one).
extern "C" int rwkv_wkv_grids(int B, int S, int H, int hd, int chunk,
                              int body, int group, int n_groups,
                              int* out) {
  Args p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, body == kSplit ? reinterpret_cast<float*>(16) : nullptr,
         B, S, H, chunk, group, n_groups, 0, 0};
  const int rc = check(p, hd, body);
  if (rc) return rc;
  return hd == 16 ? grids<16>(p, body, out) : grids<64>(p, body, out);
}
