// Backward of the chunked RWKV-6 WKV for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the Pallas WKV (src/repro/kernels/rwkv_scan.py,
// rwkv_wkv) has no backward, and the reference trains through jax.grad of
// src/repro/models/rwkv6.py::_chunked_wkv. This is that gradient for the
// port's kernel route (kernels/rwkv_scan.py::WkvFunction), whose contract is
// kernels/rwkv_scan.py::wkv_backward_plain. Per (batch row, head), with
// S_t = diag(w_t) S_{t-1} + k_t^T v_t, out_t = r_t S_{t-1} + (r_t . u k_t) v_t
// and G_t the gradient of S_t (G_T = d_state, G_{t-1} = diag(w_t) G_t +
// r_t^T dout_t):
//
//   dr_t = dout_t S_{t-1}^T + (dout_t . v_t) u k_t
//   dk_t = G_t v_t^T + (dout_t . v_t) u r_t
//   dv_t = k_t G_t + (r_t . u k_t) dout_t
//   dlogw_t = w_t rowsum(S_{t-1} o G_t)
//   du = sum over rows and tokens of (dout_t . v_t) r_t k_t,  ds0 = G_0.
//
// Inside a chunk of c <= 16 tokens the states are read through the
// forward's bounded factors (cum the inclusive cumulative log decay,
// cum_excl = cum - logw, total = cum[c-1]):
//
//   S_{t-1} = e^cum_excl[t] (S_start + sum_{s<t} e^-cum[s] k_s^T v_s)
//   G_t     = e^-cum[t] (e^total G_end + sum_{s>t} e^cum_excl[s] r_s^T dout_s)
//
// dr needs only the states S (a walk forward), dk and dv only the
// gradients G (a walk backward). dlogw needs both, but as a sum: the walk
// depends on the log decays only through their cumulative sums, so over any
// run of tokens ending at T' (a chunk, or a group of chunks)
//
//   dlogw_t = sum_{t<=m<=T'} (r_{m+1} o dr'_{m+1} - k_m o dk'_m)
//             + rowsum(G_T' o S_T')
//
// with r_{T'+1} taken as zero and primes marking dr and dk without their
// bonus terms. The plain version takes the run to be a chunk; the kernels
// take the forward's group, so one rowsum a group replaces one a chunk and
// no chunk's state has to meet its gradient. No decay is ever divided by
// (one step at the -4 clamp is x e^4; inverting a chunk's overflows).
//
// The work follows the forward's split body (csrc/rwkv_wkv.cu): the
// sequence is cut into the forward's groups of G chunks, whose start
// states the forward's scratch holds (B, H, groups, hd + 1, hd); a
// one-pass or decode forward gives one group, started from s0. Four
// kernels, one counted launch (the first two only with more than one
// group):
//
//   * wkv_bwd_local, a block a (group after the first, head, batch row):
//     the group's contribution to the gradient of the state before it,
//     walking its chunks backward from a zero end (G <- e^total G + (r
//     e^cum_excl)^T dout), and its decay (the product of its chunks'
//     e^total), into the group's slot of a scratch (B, H, groups, hd + 1,
//     hd). It reads r, logw and dout only.
//   * wkv_bwd_scan, a thread a float4 of a head's gradient: from d_state
//     (or zeros), for each group from the last, its end gradient written
//     over its slot and G = D_g G + dG_g; the loads of 16 groups in flight.
//   * wkv_bwd_grad, a block a (group, head, batch row): a forward walk over
//     the group's chunks from its start state, writing dr and r o dr' (the
//     latter into dlogw's rows, as scratch) and carrying the state in
//     shared memory; rowsum(G_end o S_end) for the group; then a backward
//     walk from the group's end gradient (the scan's slot; d_state or zeros
//     for one group), writing dk, dv and, one chunk behind, dlogw over the
//     r o dr' it read back, carrying the gradient in shared memory; ds0 from
//     the first group; the group's share of du.
//   * wkv_bwd_du: du summed over rows and groups in a fixed order.
//
// Bound on an H100 at rwkv6-1.6B's training shape (B 4, S 2048, 32 heads
// x 64, chunk 16; the split forward's 16 groups of 8 chunks; 3.35 TB/s): r,
// k, v, logw and dout read once, dr, dk, dv and dlogw written once, the
// forward's group states read: ~0.64 GB, 0.19 ms. The f32 work, ~2 (4 hd^2 +
// 3 c hd) a token and head (1.0e10 flops), is 0.15 ms at 67 TFLOP/s.
//
// What this design moves at that shape: wkv_bwd_local reads r, logw and
// dout of 15 of the 16 groups (0.20 GB) and writes 34.6 MB of slots; the
// scan reads and writes them (69 MB); wkv_bwd_grad reads the five inputs
// (0.34 GB) and the group states (34.6 MB), writes dr, dk, dv and dlogw
// (0.27 GB) and r o dr' (67 MB, into dlogw's rows), and reads its group's
// inputs and r o dr' again on the backward walk, within a few microseconds,
// mostly from L2 (its resident blocks' inputs are ~43 MB). ~1.0 GB from
// device memory if L2 holds, ~1.4 GB if it does not, against the 0.64 GB
// bound. No chunk's state leaves the chip: the only scratch is the slots
// and du's shares, 35.1 MB, where the design before this one wrote and read
// every chunk's start state (270.5 MB each way). The work: the local walk
// and the forward walk's state update add two hd^2 products a token to the
// bound's four (1.5e10 flops, 0.23 ms at the f32 peak); that, at about a
// quarter of the peak, is what holds the kernels, not the bytes.
//
// A step of wkv_bwd_grad (256 threads; two blocks an SM, 105 KB of shared
// memory and 128 registers a thread each; three barriers a step, where the
// design before had five): the next chunk's r, k, v, logw and dout are
// staged by 16-byte cp.async copies into a ring of two while this one
// computes; the backward walk's first chunk is the forward walk's last,
// still staged. Then
//   1. the decay factors, once for the head, over (token, key): cum summed
//      in order t = 0..15 (zero logw past c) as the plain version does; the
//      bonus dots dout_t . v_t and r_t . u k_t; forward, the strictly lower
//      scores dout_t . v_s; backward, dlogw of the previous step's chunk
//      (a reverse sum spread over the block, 4 threads a key) and the loads
//      of r o dr' the outputs need, in flight until phase 3;
//   2. backward, the strictly lower scores (r e^cum_excl)_t . (k e^-cum)_s
//      and dout_t . v_s; the hd^2 products over register tiles, a thread 4
//      tokens x 4 columns over a quarter of the reduction (float4 loads, 16
//      FMAs a pair of them; the quarters summed by a shuffle reduce-
//      scatter): dout S^T with the intra term folded in (forward), G v^T
//      and (k e^(total - cum)) G (backward); the scores the same way, 64
//      threads a matrix; and the state or gradient update, a 4 x 4 tile of
//      it a thread, into the other of two buffers so that no barrier waits
//      for the products' reads;
//   3. the remaining intra-chunk terms (two accumulator chains a thread)
//      and the outputs, a thread a (token, column quad).
// wkv_bwd_local keeps its 4 x 4 tile of G in registers (two barriers a
// step); the scan keeps 16 groups' loads in flight.
// Rows are padded to hd + 4 words, so a quarter-warp's float4 reads of the
// tiles fall in distinct banks. The token loops carry no branch a token:
// rows c..15 of the staged chunks are zero (set once a block), and add
// exact zeros.
//
// Precision: f32 on the CUDA cores, expf and no fast math (exp(-cum)
// reaches e^64 at chunk 16), as the forward. Deterministic: no atomics;
// every sum, du's partial sums included, is added in a fixed order.
//
// Planted fault for the checks: drop_carry starts every group's backward
// walk from zero, ignoring the later groups and d_state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;        // row padding (floats) of tiles and states
constexpr int kStages = 2;     // the chunk ring of a walk
constexpr int kScanBatch = 16;  // groups whose loads the scan has in flight
constexpr int kScoreRow = kMaxChunk + 4;  // row of a score matrix (float4s)

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* lw;
  const float* u;
  const float* s0;      // may be null: zeros (one group only)
  const float* states;  // the forward's split scratch, or null (one group)
  const float* dout;
  const float* dstate;  // may be null: zeros
  float* dr;
  float* dk;
  float* dv;
  float* dlw;  // r o dr' of the forward walk, then dlogw
  float* du;
  float* ds0;  // may be null: not wanted
  float* gs;   // (B, H, n_groups, hd + 1, hd): dG and decay, then G_end
  float* dup;  // (B, H, n_groups, hd): each group's share of du
  int B, S, H, chunk, group, n_groups, drop_carry;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
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

// the token a lane keeps after reduce_scatter4 of a 4-token tile tg
__device__ __forceinline__ int kept_token(int tg, int iq) {
  return 4 * tg + 2 * (iq & 1) + (iq >> 1);
}

// zero `bytes` (a multiple of 16) of shared memory
__device__ __forceinline__ void zero_smem(void* base, size_t bytes) {
  float4* p = reinterpret_cast<float4*>(base);
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads) p[i] = zero4();
}

// offset of row (b, t, h) of a (B, S, H, HD) tensor
__device__ __forceinline__ size_t row_of(const Args& p, int b, int t, int h,
                                         int hd) {
  return (((size_t)b * p.S + t) * p.H + h) * hd;
}

// copy an (HD, HD) state from global memory (rows of HD) into padded rows,
// or zeros for a null source
template <int HD>
__device__ __forceinline__ void stage_state(float (*X)[HD + kPad],
                                            const float* src) {
  constexpr int Q = HD / 4;
  for (int it = threadIdx.x; it < HD * Q; it += kThreads) {
    const int d = it / Q, x = 4 * (it % Q);
    if (src)
      cp_async16(&X[d][x], src + (size_t)d * HD + x);
    else
      st4(&X[d][x], zero4());
  }
}

// Xn[i][j] = T[i] X[i][j] + sum_t L[t][i] M[t][j] over the chunk's rows (c
// rounded up to 4; zero rows past c): a 4 x 4 tile a thread, a warp's tiles
// 4 rows x 8 columns of quads so that its float4 reads of L and M are one
// wavefront each
template <int HD>
__device__ __forceinline__ void tile_update(float (*Xn)[HD + kPad],
                                            float (*X)[HD + kPad],
                                            const float* T,
                                            float (*L)[HD + kPad],
                                            float (*M)[HD + kPad], int c) {
  constexpr int Q = HD / 4;
  const int tid = threadIdx.x;
  if (tid >= Q * Q) return;
  const int jq = Q >= 8 ? (tid & 7) + 8 * (tid / (8 * Q)) : tid % Q;
  const int dq = Q >= 8 ? (tid >> 3) % Q : tid / Q;
  float4 acc[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) acc[rr] = zero4();
  for (int t0 = 0; t0 < c; t0 += 4) {
#pragma unroll
    for (int t = t0; t < t0 + 4; ++t) {
      const float4 l = ld4(&L[t][4 * dq]);
      const float4 m = ld4(&M[t][4 * jq]);
      fma4(acc[0], l.x, m);
      fma4(acc[1], l.y, m);
      fma4(acc[2], l.z, m);
      fma4(acc[3], l.w, m);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int row = 4 * dq + rr;
    const float tt = T[row];
    const float4 x = ld4(&X[row][4 * jq]);
    st4(&Xn[row][4 * jq],
        make_float4(fmaf(tt, x.x, acc[rr].x), fmaf(tt, x.y, acc[rr].y),
                    fmaf(tt, x.z, acc[rr].z), fmaf(tt, x.w, acc[rr].w)));
  }
}

// C[t][s] = sum_e L[t][e] M[s][e] for s < t, zero for s >= t (16 x 16):
// 64 threads (th 0..63, whole warps), a 4 x 4 tile (tg, sg) over a quarter
// iq of e a thread, the quarters summed by the reduce-scatter
template <int HD>
__device__ __forceinline__ void lower_scores(float (*C)[kScoreRow],
                                             float (*L)[HD + kPad],
                                             float (*M)[HD + kPad], int th) {
  constexpr int Q = HD / 4;
  const int iq = th & 3, tg = (th >> 2) & 3, sg = th >> 4;
  float4 acc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a] = zero4();
#pragma unroll
  for (int s4 = 0; s4 < Q / 4; ++s4) {
    const int e0 = 4 * (4 * s4 + iq);
    float4 l[4], m[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) l[a] = ld4(&L[4 * tg + a][e0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = ld4(&M[4 * sg + e][e0]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc[a].x = dot4(l[a], m[0], acc[a].x);
      acc[a].y = dot4(l[a], m[1], acc[a].y);
      acc[a].z = dot4(l[a], m[2], acc[a].z);
      acc[a].w = dot4(l[a], m[3], acc[a].w);
    }
  }
  const float4 x = reduce_scatter4(acc, iq);
  const int t = kept_token(tg, iq), s = 4 * sg;
  st4(&C[t][s], make_float4(s < t ? x.x : 0.f, s + 1 < t ? x.y : 0.f,
                            s + 2 < t ? x.z : 0.f, s + 3 < t ? x.w : 0.f));
}

// ------------------------------------------------------------ local pass
// Block (group g >= 1, head, batch row): the group's contribution to the
// gradient of the state before it, from a zero end, and its decay. Two
// barriers a chunk; a thread keeps its 4 x 4 tile of G in registers.

template <int HD>
struct LocalSmem {
  float R[kStages][kMaxChunk][HD + kPad];
  float D[kStages][kMaxChunk][HD + kPad];  // dout
  float W[kStages][kMaxChunk][HD];         // logw
  float Rin[kMaxChunk][HD + kPad];         // r e^cum_excl
  float T[HD];                             // e^total
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 4) wkv_bwd_local(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LocalSmem<HD>& sm = *reinterpret_cast<LocalSmem<HD>*>(smem_raw);
  constexpr int Q = HD / 4;
  constexpr int TQ = kThreads / HD;    // token slots of the decay phase
  constexpr int TPT = kMaxChunk / TQ;  // tokens a slot
  const int tid = threadIdx.x;
  const int g = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int c = p.chunk, nc = p.S / c;
  const int first = g * p.group, n = min(p.group, nc - first);
  const size_t head = (size_t)b * p.H + h;

  zero_smem(&sm, sizeof(sm));  // rows c..15 stay zero
  __syncthreads();
  auto load = [&](int i) {  // walk step i: chunk first + n - 1 - i
    const int st = i % kStages, t0 = (first + n - 1 - i) * c;
    for (int e = tid; e < c * Q; e += kThreads) {
      const int t = e / Q, x = 4 * (e % Q);
      const size_t off = row_of(p, b, t0 + t, h, HD) + x;
      cp_async16(&sm.R[st][t][x], p.r + off);
      cp_async16(&sm.D[st][t][x], p.dout + off);
      cp_async16(&sm.W[st][t][x], p.lw + off);
    }
  };
  const int d = tid % HD, tq = tid / HD;
  float decay = 1.f;  // threads of token slot 0: key row d's
  // the thread's tile of G: rows 4 dq.., columns 4 jq.. (as tile_update's)
  const bool has_tile = tid < Q * Q;
  const int jq = Q >= 8 ? (tid & 7) + 8 * (tid / (8 * Q)) : tid % Q;
  const int dq = Q >= 8 ? (tid >> 3) % Q : tid / Q;
  float4 gt[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) gt[rr] = zero4();
  load(0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    cp_async_wait_all();
    __syncthreads();  // chunk landed; the last update done, its stage free
    if (i + 1 < n) load(i + 1);
    cp_async_commit();
    float cum = 0.f, cx[TPT];
#pragma unroll
    for (int t = 0; t < kMaxChunk; ++t) {
      const float w = sm.W[st][t][d];
      cum += w;
      if (t / TPT == tq) cx[t % TPT] = cum - w;
    }
#pragma unroll
    for (int j = 0; j < TPT; ++j) {
      const int t = tq * TPT + j;
      sm.Rin[t][d] = sm.R[st][t][d] * expf(cx[j]);
    }
    if (tq == 0) {
      const float et = expf(cum);
      sm.T[d] = et;
      decay *= et;
    }
    __syncthreads();
    if (has_tile) {  // G <- e^total G + (r e^cum_excl)^T dout
      float4 acc[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) acc[rr] = zero4();
#pragma unroll
      for (int t = 0; t < kMaxChunk; ++t) {  // zero rows past c
        const float4 l = ld4(&sm.Rin[t][4 * dq]);
        const float4 m = ld4(&sm.D[st][t][4 * jq]);
        fma4(acc[0], l.x, m);
        fma4(acc[1], l.y, m);
        fma4(acc[2], l.z, m);
        fma4(acc[3], l.w, m);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float tt = sm.T[4 * dq + rr];
        gt[rr] = make_float4(
            fmaf(tt, gt[rr].x, acc[rr].x), fmaf(tt, gt[rr].y, acc[rr].y),
            fmaf(tt, gt[rr].z, acc[rr].z), fmaf(tt, gt[rr].w, acc[rr].w));
      }
    }
  }
  float* slot = p.gs + (head * p.n_groups + g) * (HD + 1) * HD;
  if (has_tile)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
      st4(slot + (size_t)(4 * dq + rr) * HD + 4 * jq, gt[rr]);
  if (tq == 0) slot[HD * HD + d] = decay;
}

// ------------------------------------------------------------- the scan
// G_end of group g-1 = D_g G_end of g + dG_g, from the last group; a
// thread owns one float4 of a head's gradient.

template <int HD>
__host__ __device__ constexpr int scan_threads() {
  return HD * HD / 4 < kThreads ? HD * HD / 4 : kThreads;
}

template <int HD>
__global__ void __launch_bounds__(scan_threads<HD>()) wkv_bwd_scan(Args p) {
  constexpr int Q = HD / 4;
  const int it = blockIdx.x * scan_threads<HD>() + threadIdx.x;
  const int d = it / Q, jq = it % Q;
  const size_t head = (size_t)blockIdx.z * p.H + blockIdx.y;
  const size_t at = (size_t)d * HD + 4 * jq;
  float4 g = p.dstate ? ld4(p.dstate + head * HD * HD + at) : zero4();
  float* slots = p.gs + head * p.n_groups * (HD + 1) * HD;
  for (int g0 = p.n_groups - 1; g0 >= 1; g0 -= kScanBatch) {
    float4 delta[kScanBatch];
    float dec[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (g0 - j >= 1) {
        const float* slot = slots + (size_t)(g0 - j) * (HD + 1) * HD;
        delta[j] = ld4(slot + at);
        dec[j] = slot[HD * HD + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (g0 - j >= 1) {
        st4(slots + (size_t)(g0 - j) * (HD + 1) * HD + at, g);
        g = make_float4(fmaf(dec[j], g.x, delta[j].x),
                        fmaf(dec[j], g.y, delta[j].y),
                        fmaf(dec[j], g.z, delta[j].z),
                        fmaf(dec[j], g.w, delta[j].w));
      }
    }
  }
  st4(slots + at, g);  // group 0's end gradient
}

// ---------------------------------------------------------- gradient pass
// Block (group, head, batch row): the forward walk over the group's chunks
// (dr, r o dr'), then the backward walk (dk, dv, dlogw), steps i = 0..2n-1.
// Step i of the forward walk reads the state in X[i % 2] and writes the
// next into X[(i + 1) % 2]; step i of the backward walk reads the gradient
// in X[(i + 1) % 2] and writes the next into X[i % 2].

template <int HD>
struct GradSmem {
  float X[2][HD][HD + kPad];  // the state, then its gradient
  float R[kStages][kMaxChunk][HD + kPad];
  float K[kStages][kMaxChunk][HD + kPad];
  float V[kStages][kMaxChunk][HD + kPad];
  float D[kStages][kMaxChunk][HD + kPad];  // dout
  float W[kStages][kMaxChunk][HD];         // logw
  // the chunk's factors: forward e^cum_excl, k e^-cum, k e^(total - cum);
  // backward r e^cum_excl, k e^-cum, k e^(total - cum), e^-cum,
  // e^(total - cum)
  float F[5][kMaxChunk][HD + kPad];
  float Y[kMaxChunk][HD + kPad];     // r_{t+1} o dr'_{t+1} - k_t o dk'_t
  float A[kMaxChunk][kScoreRow];   // (r e^cum_excl)_t . (k e^-cum)_s
  float Dv[kMaxChunk][kScoreRow];  // dout_t . v_s (both s < t)
  float T[HD];      // e^total
  float U[HD];      // u of the head
  float P[HD];      // rowsum(G_end o S_end) of the group
  float Xn[2][HD];  // r o dr' of the next chunk's first token
  float Bv[kMaxChunk];  // dout_t . v_t
  float Bu[kMaxChunk];  // r_t . (u k_t)
};

enum { kRin = 0, kEcx = 0, kKn = 1, kKo = 2, kEn = 3, kEo = 4 };

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) wkv_bwd_grad(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem<HD>& sm = *reinterpret_cast<GradSmem<HD>*>(smem_raw);
  constexpr int Q = HD / 4;
  constexpr int TQ = kThreads / HD;    // token slots of the decay phase
  constexpr int TPT = kMaxChunk / TQ;  // tokens a slot
  constexpr int NQ = 16 * Q;           // threads of a reduce-split product
  const int tid = threadIdx.x;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c = p.chunk, nc = p.S / c;
  const int first = g * p.group, n = min(p.group, nc - first);
  const size_t head = (size_t)b * p.H + h;

  // rows c..15 of every staged and derived chunk, Y, the scores above the
  // diagonal and the first Xn stay zero
  zero_smem(&sm, sizeof(sm));
  __syncthreads();
  stage_state<HD>(sm.X[0],
                  p.states ? p.states + (head * p.n_groups + g) * (HD + 1) * HD
                           : (p.s0 ? p.s0 + head * HD * HD : nullptr));
  if (tid < HD) sm.U[tid] = p.u[h * HD + tid];

  auto load = [&](int i) {  // the chunk of step i into its stage
    const int ci = i < n ? i : 2 * n - 1 - i;
    const int st = (i < n ? i : i - 1) % kStages;
    const int t0 = (first + ci) * c;
    for (int e = tid; e < c * Q; e += kThreads) {
      const int t = e / Q, x = 4 * (e % Q);
      const size_t off = row_of(p, b, t0 + t, h, HD) + x;
      cp_async16(&sm.R[st][t][x], p.r + off);
      cp_async16(&sm.K[st][t][x], p.k + off);
      cp_async16(&sm.V[st][t][x], p.v + off);
      cp_async16(&sm.D[st][t][x], p.dout + off);
      cp_async16(&sm.W[st][t][x], p.lw + off);
    }
  };

  // the tiles of the reduce-split products: 4 tokens (tg) x 4 columns over
  // a quarter iq of the reduction; after the reduce-scatter the thread owns
  // one (token, column quad): (ot, dg) of dout S^T and G v^T, (ot2, jg) of
  // (k e^(total - cum)) G
  const bool has_q = tid < NQ;  // whole warps
  const int iq = tid & 3;
  const int tg = (tid >> 2) & 3, dg = tid >> 4;
  const int tg2 = (tid >> 4) & 3, jg = ((tid >> 2) & 3) + 4 * (tid >> 6);
  const int ot = kept_token(tg, iq), ot2 = kept_token(tg2, iq);
  const int d = tid % HD, tq = tid / HD;  // decay phase
  const int bt = tid >> 4, bpart = tid & 15;  // bonus dots: a token, a part
  const int ld_d = tid >> 2, ld_part = tid & 3;  // dlogw sums and P
  const bool has_ld = tid < 4 * HD;  // whole warps
  float4 du_acc = zero4();  // du of (ot, dg)'s columns over the chunks
  float carry = 0.f;        // dlogw's sum from the later chunks, key ld_d

  // dlogw of the chunk at row t0 from Y: the reverse sum over its tokens
  // plus the carry, 4 threads a key, each over 4 tokens
  auto dlogw_sum = [&](int t0) {
    if (!has_ld) return;
    float y[4], s[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) y[m] = sm.Y[4 * ld_part + m][ld_d];
    s[3] = y[3];
#pragma unroll
    for (int m = 2; m >= 0; --m) s[m] = y[m] + s[m + 1];
    const int base = threadIdx.x & ~3 & 31;
    const float x0 = __shfl_sync(0xffffffffu, s[0], base);
    const float x1 = __shfl_sync(0xffffffffu, s[0], base + 1);
    const float x2 = __shfl_sync(0xffffffffu, s[0], base + 2);
    const float x3 = __shfl_sync(0xffffffffu, s[0], base + 3);
    const float x23 = x2 + x3, x123 = x1 + x23;
    const float above = ld_part == 3 ? 0.f
                        : ld_part == 2 ? x3 : ld_part == 1 ? x23 : x123;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int t = 4 * ld_part + m;
      if (t < c)
        p.dlw[row_of(p, b, t0 + t, h, HD) + ld_d] = carry + (above + s[m]);
    }
    carry += x0 + x123;
  };

  load(0);
  cp_async_commit();
  for (int i = 0; i < 2 * n; ++i) {
    const bool fwd = i < n;
    const int ci = fwd ? i : 2 * n - 1 - i;
    const int st = (fwd ? i : i - 1) % kStages;
    const int t0 = (first + ci) * c;
    float (*Xc)[HD + kPad] = sm.X[fwd ? i % 2 : (i + 1) % 2];
    float (*Xw)[HD + kPad] = sm.X[fwd ? (i + 1) % 2 : i % 2];
    cp_async_wait_all();
    __syncthreads();  // chunk (and G_end) landed; the last step's reads done
    if (i + 1 < 2 * n && i + 1 != n) load(i + 1);  // step n reuses n - 1's
    cp_async_commit();

    // ---- 1. factors, bonus dots; backward: dlogw one chunk behind, P
    {
      float cum = 0.f, cw[TPT], cx[TPT];
#pragma unroll
      for (int t = 0; t < kMaxChunk; ++t) {  // zero logw past c
        const float w = sm.W[st][t][d];
        cum += w;
        if (t / TPT == tq) {
          cw[t % TPT] = cum;
          cx[t % TPT] = cum - w;
        }
      }
#pragma unroll
      for (int j = 0; j < TPT; ++j) {
        const int t = tq * TPT + j;
        const float kk = sm.K[st][t][d];
        const float en = expf(-cw[j]), eo = expf(cum - cw[j]);
        sm.F[kKn][t][d] = kk * en;
        sm.F[kKo][t][d] = kk * eo;
        if (fwd) {
          sm.F[kEcx][t][d] = expf(cx[j]);
        } else {
          sm.F[kRin][t][d] = sm.R[st][t][d] * expf(cx[j]);
          sm.F[kEn][t][d] = en;
          sm.F[kEo][t][d] = eo;
        }
      }
      if (tq == 0) sm.T[d] = expf(cum);
    }
    {
      float bv = 0.f, bu = 0.f;
      for (int x = 4 * bpart; x < HD; x += 64) {
        bv = dot4(ld4(&sm.D[st][bt][x]), ld4(&sm.V[st][bt][x]), bv);
        if (!fwd) {
          const float4 kk = ld4(&sm.K[st][bt][x]), uu = ld4(&sm.U[x]);
          bu = dot4(ld4(&sm.R[st][bt][x]),
                    make_float4(uu.x * kk.x, uu.y * kk.y, uu.z * kk.z,
                                uu.w * kk.w),
                    bu);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o /= 2) {
        bv += __shfl_xor_sync(0xffffffffu, bv, o);
        bu += __shfl_xor_sync(0xffffffffu, bu, o);
      }
      if (bpart == 0) {
        sm.Bv[bt] = bv;
        sm.Bu[bt] = bu;
      }
    }
    // backward: r o dr' of token ot + 1, and (threads below Q) of this
    // chunk's first token for the next step, in flight until phase 3
    float4 xr = zero4(), xn = zero4();
    if (fwd && tid >= 64 && tid < 128)  // dout_t . v_s for the (ot, dg) tiles
      lower_scores<HD>(sm.Dv, sm.D[st], sm.V[st], tid - 64);
    if (!fwd) {
      if (i == n) {  // P = rowsum(G_end o S_end), S_end in Xw
        if (has_ld) {
          float acc = 0.f;
          for (int x = 4 * ld_part; x < HD; x += 16)
            acc = dot4(ld4(&Xc[ld_d][x]), ld4(&Xw[ld_d][x]), acc);
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          if (ld_part == 0) sm.P[ld_d] = acc;
        }
      } else {  // dlogw of the last step's chunk (the one after this)
        if (i == n + 1 && has_ld) carry = sm.P[ld_d];
        dlogw_sum(t0 + c);
      }
      if (has_q && ot + 1 < c)
        xr = ld4(p.dlw + row_of(p, b, t0 + ot + 1, h, HD) + 4 * dg);
      if (tid < Q) xn = ld4(p.dlw + row_of(p, b, t0, h, HD) + 4 * tid);
    }
    __syncthreads();

    // ---- 2. scores; the reduce-split products; the state update
    if (!fwd && tid < 64)
      lower_scores<HD>(sm.A, sm.F[kRin], sm.F[kKn], tid);
    else if (!fwd && tid >= 64 && tid < 128)
      lower_scores<HD>(sm.Dv, sm.D[st], sm.V[st], tid - 64);
    // (ot, dg): forward dout S^T plus sum_{s<t} (dout_t . v_s) (k e^-cum)_s,
    // backward G v^T, over quarter iq of the value columns (and of the
    // tokens s); then (ot2, jg): (k e^(total - cum)) G over quarter iq of
    // the key rows
    float4 red1 = zero4(), red2 = zero4();
    if (has_q) {
      float (*L)[HD + kPad] = fwd ? sm.D[st] : sm.V[st];
      float4 acc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a] = zero4();
#pragma unroll
      for (int s4 = 0; s4 < Q / 4; ++s4) {
        const int jb = 4 * (4 * s4 + iq);
        float4 l[4], x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) l[a] = ld4(&L[4 * tg + a][jb]);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = ld4(&Xc[4 * dg + e][jb]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a].x = dot4(l[a], x[0], acc[a].x);
          acc[a].y = dot4(l[a], x[1], acc[a].y);
          acc[a].z = dot4(l[a], x[2], acc[a].z);
          acc[a].w = dot4(l[a], x[3], acc[a].w);
        }
      }
      if (fwd) {  // tokens s = 4 iq .. 4 iq + 3 of the intra term
        float4 l[4], x[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) l[a] = ld4(&sm.Dv[4 * tg + a][4 * iq]);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = ld4(&sm.F[kKn][4 * iq + e][4 * dg]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          fma4(acc[a], l[a].x, x[0]);
          fma4(acc[a], l[a].y, x[1]);
          fma4(acc[a], l[a].z, x[2]);
          fma4(acc[a], l[a].w, x[3]);
        }
      }
      red1 = reduce_scatter4(acc, iq);
      if (!fwd) {
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a] = zero4();
#pragma unroll
        for (int s4 = 0; s4 < Q / 4; ++s4) {
          const int db = 4 * (4 * s4 + iq);
          float4 l[4], x[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) l[a] = ld4(&sm.F[kKo][4 * tg2 + a][db]);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[e] = ld4(&Xc[db + e][4 * jg]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            fma4(acc[a], l[a].x, x[0]);
            fma4(acc[a], l[a].y, x[1]);
            fma4(acc[a], l[a].z, x[2]);
            fma4(acc[a], l[a].w, x[3]);
          }
        }
        red2 = reduce_scatter4(acc, iq);
      }
    }
    // the state (forward: S <- e^total S + (k e^(total - cum))^T v) or its
    // gradient (backward: G <- e^total G + (r e^cum_excl)^T dout), but for
    // the gradient after the group's first chunk unless it is ds0
    if (fwd)
      tile_update<HD>(Xw, Xc, sm.T, sm.F[kKo], sm.V[st], c);
    else if (i + 1 < 2 * n || (g == 0 && p.ds0))
      tile_update<HD>(Xw, Xc, sm.T, sm.F[kRin], sm.D[st], c);
    __syncthreads();

    // ---- 3. intra-chunk terms and the outputs
    if (fwd) {
      if (has_q) {  // dr of (ot, dg): dr' = e^cum_excl (dout S^T + ...)
        const float4 ex = ld4(&sm.F[kEcx][ot][4 * dg]);
        const float4 drn = make_float4(ex.x * red1.x, ex.y * red1.y,
                                       ex.z * red1.z, ex.w * red1.w);
        if (ot < c) {
          const size_t at = row_of(p, b, t0 + ot, h, HD) + 4 * dg;
          const float4 rr = ld4(&sm.R[st][ot][4 * dg]);
          const float4 kk = ld4(&sm.K[st][ot][4 * dg]);
          const float4 uu = ld4(&sm.U[4 * dg]);
          const float bv = sm.Bv[ot];
          st4(p.dr + at, make_float4(fmaf(bv, uu.x * kk.x, drn.x),
                                     fmaf(bv, uu.y * kk.y, drn.y),
                                     fmaf(bv, uu.z * kk.z, drn.z),
                                     fmaf(bv, uu.w * kk.w, drn.w)));
          st4(p.dlw + at, make_float4(rr.x * drn.x, rr.y * drn.y,
                                      rr.z * drn.z, rr.w * drn.w));
        }
      }
      if (i == n - 1) {  // the group's end gradient, behind the last step
        const float* src =
            p.drop_carry ? nullptr
            : p.n_groups > 1
                ? p.gs + (head * p.n_groups + g) * (HD + 1) * HD
                : (p.dstate ? p.dstate + head * HD * HD : nullptr);
        stage_state<HD>(Xc, src);  // S_{n-1}, read in phase 2 above
        cp_async_commit();
      }
    } else {
      if (tid < Q) st4(&sm.Xn[i % 2][4 * tid], xn);  // read next step
      if (has_q) {  // dk of (ot, dg); du's terms
        float4 ki = zero4(), k2 = zero4();  // two chains: even, odd s
#pragma unroll
        for (int s = 0; s < kMaxChunk; s += 2) {  // Dv[s][t] = 0 for s <= t
          fma4(ki, sm.Dv[s][ot], ld4(&sm.F[kRin][s][4 * dg]));
          fma4(k2, sm.Dv[s + 1][ot], ld4(&sm.F[kRin][s + 1][4 * dg]));
        }
        ki = make_float4(ki.x + k2.x, ki.y + k2.y, ki.z + k2.z, ki.w + k2.w);
        const float4 en = ld4(&sm.F[kEn][ot][4 * dg]);
        const float4 eo = ld4(&sm.F[kEo][ot][4 * dg]);
        const float4 dkn = make_float4(
            fmaf(en.x, ki.x, eo.x * red1.x), fmaf(en.y, ki.y, eo.y * red1.y),
            fmaf(en.z, ki.z, eo.z * red1.z), fmaf(en.w, ki.w, eo.w * red1.w));
        if (ot < c) {
          const size_t at = row_of(p, b, t0 + ot, h, HD) + 4 * dg;
          const float4 rr = ld4(&sm.R[st][ot][4 * dg]);
          const float4 kk = ld4(&sm.K[st][ot][4 * dg]);
          const float4 uu = ld4(&sm.U[4 * dg]);
          const float bv = sm.Bv[ot];
          st4(p.dk + at, make_float4(fmaf(bv, uu.x * rr.x, dkn.x),
                                     fmaf(bv, uu.y * rr.y, dkn.y),
                                     fmaf(bv, uu.z * rr.z, dkn.z),
                                     fmaf(bv, uu.w * rr.w, dkn.w)));
          const float4 nx =
              ot + 1 < c ? xr : ld4(&sm.Xn[(i + 1) % 2][4 * dg]);
          st4(&sm.Y[ot][4 * dg],
              make_float4(nx.x - kk.x * dkn.x, nx.y - kk.y * dkn.y,
                          nx.z - kk.z * dkn.z, nx.w - kk.w * dkn.w));
          du_acc.x = fmaf(bv * rr.x, kk.x, du_acc.x);
          du_acc.y = fmaf(bv * rr.y, kk.y, du_acc.y);
          du_acc.z = fmaf(bv * rr.z, kk.z, du_acc.z);
          du_acc.w = fmaf(bv * rr.w, kk.w, du_acc.w);
        }
        float4 vi = zero4(), v2 = zero4();  // dv of (ot2, jg)
#pragma unroll
        for (int s = 0; s < kMaxChunk; s += 2) {  // A[s][t] = 0 for s <= t
          fma4(vi, sm.A[s][ot2], ld4(&sm.D[st][s][4 * jg]));
          fma4(v2, sm.A[s + 1][ot2], ld4(&sm.D[st][s + 1][4 * jg]));
        }
        vi = make_float4(vi.x + v2.x, vi.y + v2.y, vi.z + v2.z, vi.w + v2.w);
        if (ot2 < c) {
          const float4 dd = ld4(&sm.D[st][ot2][4 * jg]);
          const float bu = sm.Bu[ot2];
          st4(p.dv + row_of(p, b, t0 + ot2, h, HD) + 4 * jg,
              make_float4(fmaf(bu, dd.x, vi.x + red2.x),
                          fmaf(bu, dd.y, vi.y + red2.y),
                          fmaf(bu, dd.z, vi.z + red2.z),
                          fmaf(bu, dd.w, vi.w + red2.w)));
        }
      }
    }
  }
  __syncthreads();  // Y of the group's first chunk; its gradient update
  if (n == 1 && has_ld) carry = sm.P[ld_d];
  dlogw_sum(first * c);
  if (has_q) st4(&sm.F[kEcx][ot][4 * dg], du_acc);  // F free now
  if (g == 0 && p.ds0) {  // the gradient of the initial state
    float* dst = p.ds0 + head * HD * HD;
    for (int it = tid; it < HD * Q; it += kThreads) {
      const int dd = it / Q, x = 4 * (it % Q);
      st4(dst + (size_t)dd * HD + x, ld4(&sm.X[1][dd][x]));
    }
  }
  __syncthreads();
  if (tid < HD) {  // the group's share of du, over its tokens in order
    float acc = 0.f;
    for (int t = 0; t < kMaxChunk; ++t) acc += sm.F[kEcx][t][tid];
    p.dup[(head * p.n_groups + g) * HD + tid] = acc;
  }
}

// du[h] = sum over batch rows, then groups, of the groups' shares
template <int HD>
__global__ void __launch_bounds__(HD) wkv_bwd_du(Args p) {
  const int h = blockIdx.x, i = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int g = 0; g < p.n_groups; ++g)
      acc += p.dup[(((size_t)b * p.H + h) * p.n_groups + g) * HD + i];
  p.du[h * HD + i] = acc;
}

// ------------------------------------------------------------------ host

template <int HD>
int launch(const Args& p, cudaStream_t s) {
  const size_t local_smem = sizeof(LocalSmem<HD>);
  const size_t grad_smem = sizeof(GradSmem<HD>);
  static bool ready = false;
  if (!ready) {
    int rc = (int)cudaFuncSetAttribute(
        wkv_bwd_local<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)local_smem);
    if (!rc)
      rc = (int)cudaFuncSetAttribute(
          wkv_bwd_grad<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)grad_smem);
    if (rc) return rc;
    ready = true;
  }
  int rc = 0;
  if (p.n_groups > 1) {
    wkv_bwd_local<HD><<<dim3(p.n_groups - 1, p.H, p.B), kThreads,
                        local_smem, s>>>(p);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    wkv_bwd_scan<HD><<<dim3(HD * HD / 4 / scan_threads<HD>(), p.H, p.B),
                       scan_threads<HD>(), 0, s>>>(p);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  wkv_bwd_grad<HD><<<dim3(p.n_groups, p.H, p.B), kThreads, grad_smem, s>>>(p);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  wkv_bwd_du<HD><<<p.H, HD, 0, s>>>(p);
  return (int)cudaGetLastError();
}

int check(const Args& p, int hd) {
  if (p.B < 1 || p.S < 1 || p.H < 1 || p.H > 65535 || p.B > 65535)
    return (int)cudaErrorInvalidValue;
  if (p.chunk < 1 || p.chunk > kMaxChunk || p.S % p.chunk)
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 64) return (int)cudaErrorInvalidValue;
  const int nc = p.S / p.chunk;
  if (p.group < 1 || p.n_groups != (nc + p.group - 1) / p.group ||
      p.n_groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (!p.states && p.n_groups != 1) return (int)cudaErrorInvalidValue;
  if (!p.gs || !p.dup) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Returns 0 or a cudaError_t. r, k, v, lw, dout and the outputs dr, dk, dv,
// dlw: (B, S, H, hd) f32 device pointers, contiguous and 16-byte aligned; u
// and du (H, hd); s0, dstate and ds0 (B, H, hd, hd), each may be null
// (zeros; zeros; not written); states: the forward's split scratch (B, H,
// n_groups, hd + 1, hd), null for one group (started from s0); scratch gs
// (B, H, n_groups, hd + 1, hd) and dup (B, H, n_groups, hd). hd in {16,
// 64}; 1 <= chunk <= 16 dividing S; group: chunks a group. Asynchronous on
// `stream`.
extern "C" int rwkv_wkv_backward(
    const float* r, const float* k, const float* v, const float* lw,
    const float* u, const float* s0, const float* states, const float* dout,
    const float* dstate, float* dr, float* dk, float* dv, float* dlw,
    float* du, float* ds0, float* gs, float* dup, int B, int S, int H, int hd,
    int chunk, int group, int n_groups, int drop_carry, void* stream) {
  Args p{r,  k,  v,   lw,  u,  s0,    states, dout,  dstate,
         dr, dk, dv,  dlw, du, ds0,   gs,     dup,   B,
         S,  H,  chunk, group, n_groups, drop_carry};
  const int rc = check(p, hd);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 16 ? launch<16>(p, s) : launch<64>(p, s);
}
