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
// and dlogw as the chunk's reverse sum over tokens m >= t of
// r_{m+1} . dr'_{m+1} - k_m . dk'_m (primes: without the bonus term), plus
// rowsum(G_end o S_end): the chunk depends on its log decays only through
// their cumulative sums, so no decay is ever divided by (one step at the -4
// clamp is x e^4; inverting a chunk's overflows).
//
// The work follows the forward's split body (csrc/rwkv_wkv.cu): the
// sequence is cut into the forward's groups of G chunks, whose start
// states the forward's scratch holds (B, H, groups, hd + 1, hd); a
// one-pass or decode forward gives one group, started from s0. Four
// kernels, one counted launch:
//
//   * wkv_bwd_state, a block a (group, head, batch row): walks its chunks
//     forward from the group's start state, writing every chunk's start
//     state (and, for the last group, the final state) to a scratch
//     (B, H, chunks + 1, hd, hd); then backward from G = 0, writing the
//     group's gradient contribution and its decay (the product of its
//     chunks' e^total) to a second scratch (B, H, groups, hd + 1, hd).
//   * wkv_bwd_scan, a thread a float4 of a head's gradient: from d_state
//     (or zeros), for each group from the last, its end gradient written
//     over its slot and G = D_g G + dG_g; then ds0.
//   * wkv_bwd_grad, a block a (group, head, batch row): walks its chunks
//     backward from the group's end gradient, the chunk's start and end
//     states read from the first scratch, and writes dr, dk, dv and dlogw
//     of every token and the group's share of du.
//   * wkv_bwd_du: du summed over rows and groups in a fixed order.
//
// Bound on an H100 at rwkv6-1.6B's training shape (B 4, S 2048, 32 heads
// x 64, chunk 16; 3.35 TB/s): r, k, v, logw and dout read once, dr, dk, dv
// and dlogw written once, the forward's group states read: ~0.64 GB, 0.19
// ms. The f32 work, ~2 (4 hd^2 + 3 c hd) a token and head (1.0e10), is 0.15
// ms at 67 TFLOP/s. The chunk states cost this design another ~0.54 GB
// written and read.
//
// A chunk step of wkv_bwd_grad (256 threads; five barriers): stage r, k,
// v, logw and dout (rows c..15 zero, so the token loops add exact zeros)
// while rowsum(G_end o S_end) is summed; the start state and the decay
// factors once for the head; the strictly lower scores (r e^cum_excl)_t .
// (k e^-cum)_s and dout_t . v_s; dr, dk and dv, a thread a key (or value)
// column over 4 tokens (hd 64) so that each state entry it reads serves
// them all; then dlogw's reverse sums and G <- e^total G + (r
// e^cum_excl)^T dout. Shared rows are padded by one word, so a warp's
// column reads fall in distinct banks.
//
// Precision: f32 on the CUDA cores, expf and no fast math (exp(-cum)
// reaches e^64 at chunk 16), as the forward. Deterministic: no atomics;
// du's partial sums are added in a fixed order.
//
// Planted fault for the checks: drop_carry starts every group's gradient
// walk from zero, ignoring the later groups and d_state.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 16;
constexpr int kThreads = 256;

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
  float* dlw;
  float* du;
  float* ds0;  // may be null: not wanted
  float* gs;   // (B, H, n_groups, hd + 1, hd): dG and decay, then G_end
  float* cs;   // (B, H, chunks + 1, hd, hd): each chunk's start state
  float* dup;  // (B, H, n_groups, hd): each group's share of du
  int B, S, H, chunk, group, n_groups, drop_carry;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// offset of row (b, t, h) of a (B, S, H, HD) tensor
__device__ __forceinline__ size_t row_of(const Args& p, int b, int t, int h,
                                         int hd) {
  return (((size_t)b * p.S + t) * p.H + h) * hd;
}

template <int HD>
struct Smem {
  float S[HD][HD + 1];  // a state (key rows)
  float G[HD][HD + 1];  // the gradient of the state after this chunk
  float R[kMaxChunk][HD + 1];
  float K[kMaxChunk][HD + 1];
  float V[kMaxChunk][HD + 1];
  float W[kMaxChunk][HD + 1];    // logw
  float D[kMaxChunk][HD + 1];    // dout
  float Cum[kMaxChunk][HD + 1];  // inclusive cumulative log decay
  float Rin[kMaxChunk][HD + 1];  // r e^cum_excl
  float Kn[kMaxChunk][HD + 1];   // k e^-cum
  float Ko[kMaxChunk][HD + 1];   // k e^(total - cum)
  float Xr[kMaxChunk][HD + 1];   // r o dr' (no bonus)
  float Xk[kMaxChunk][HD + 1];   // k o dk' (no bonus)
  float A[kMaxChunk][kMaxChunk + 1];   // (r e^cum_excl)_t . (k e^-cum)_s
  float Dv[kMaxChunk][kMaxChunk + 1];  // dout_t . v_s (both s < t)
  float T[HD];    // e^total
  float P[HD];    // rowsum(G_end o S_end)
  float U[HD];    // u of the head
  float Bv[kMaxChunk];  // dout_t . v_t
  float Bu[kMaxChunk];  // r_t . (u k_t)
};

// stage chunk rows t0 .. t0 + c - 1 of the chosen tensors (zeros past c)
template <int HD>
__device__ __forceinline__ void stage(const Args& p, Smem<HD>& sm, int b,
                                      int h, int t0, int c, bool with_r,
                                      bool with_kv, bool with_d) {
  constexpr int Q = HD / 4;
  for (int e = threadIdx.x; e < kMaxChunk * Q; e += kThreads) {
    const int t = e / Q, x = 4 * (e % Q);
    const bool in = t < c;
    const size_t off = in ? row_of(p, b, t0 + t, h, HD) + x : 0;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    auto put = [&](float (*dst)[HD + 1], const float* src) {
      const float4 a = in ? ld4(src + off) : z;
      dst[t][x] = a.x;
      dst[t][x + 1] = a.y;
      dst[t][x + 2] = a.z;
      dst[t][x + 3] = a.w;
    };
    put(sm.W, p.lw);
    if (with_r) put(sm.R, p.r);
    if (with_kv) {
      put(sm.K, p.k);
      put(sm.V, p.v);
    }
    if (with_d) put(sm.D, p.dout);
  }
}

// the decay factors of a staged chunk, once for the head: cum summed in
// order t = 0..15 (zero logw past c) by every thread for its key column,
// the exponentials spread over (token slot, key)
template <int HD>
__device__ __forceinline__ void factors(Smem<HD>& sm, bool with_r,
                                        bool with_k) {
  constexpr int TQ = kThreads / HD;
  constexpr int TPT = kMaxChunk / TQ;
  const int d = threadIdx.x % HD, tq = threadIdx.x / HD;
  float cum = 0.f, cw[TPT], cx[TPT];
#pragma unroll
  for (int t = 0; t < kMaxChunk; ++t) {
    const float w = sm.W[t][d];
    cum += w;
    if (t / TPT == tq) {
      cw[t % TPT] = cum;
      cx[t % TPT] = cum - w;
    }
  }
#pragma unroll
  for (int j = 0; j < TPT; ++j) {
    const int t = tq * TPT + j;
    sm.Cum[t][d] = cw[j];
    if (with_r) sm.Rin[t][d] = sm.R[t][d] * expf(cx[j]);
    if (with_k) {
      const float kk = sm.K[t][d];
      sm.Kn[t][d] = kk * expf(-cw[j]);
      sm.Ko[t][d] = kk * expf(cum - cw[j]);
    }
  }
  if (tq == 0) sm.T[d] = expf(cum);
}

// X[i][j] <- T[i] X[i][j] + sum_t L[t][i] M[t][j] over the chunk's 16 rows
template <int HD>
__device__ __forceinline__ void decay_update(float (*X)[HD + 1],
                                             const float* T,
                                             float (*L)[HD + 1],
                                             float (*M)[HD + 1]) {
  constexpr int TQ = kThreads / HD;
  const int j = threadIdx.x % HD, i0 = threadIdx.x / HD;
  float col[kMaxChunk];
#pragma unroll
  for (int t = 0; t < kMaxChunk; ++t) col[t] = M[t][j];
  for (int i = i0; i < HD; i += TQ) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxChunk; ++t) acc = fmaf(L[t][i], col[t], acc);
    X[i][j] = fmaf(T[i], X[i][j], acc);
  }
}

template <int HD>
__device__ __forceinline__ void load_state(float (*X)[HD + 1],
                                           const float* src) {
  for (int e = threadIdx.x; e < HD * HD; e += kThreads)
    X[e / HD][e % HD] = src ? src[e] : 0.f;
}

template <int HD>
__device__ __forceinline__ void store_state(float* dst,
                                            float (*X)[HD + 1]) {
  for (int e = threadIdx.x; e < HD * HD; e += kThreads)
    dst[e] = X[e / HD][e % HD];
}

// ------------------------------------------------------------ state pass
// Block (group, head, batch row): the chunks' start states forward from
// the group's start state, then the group's gradient contribution backward
// from zero and its decay.

template <int HD>
__global__ void __launch_bounds__(kThreads) wkv_bwd_state(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c = p.chunk, nc = p.S / c;
  const int first = g * p.group, n = min(p.group, nc - first);
  const size_t head = (size_t)b * p.H + h;
  const float* start =
      p.states ? p.states + (head * p.n_groups + g) * (HD + 1) * HD
               : (p.s0 ? p.s0 + head * HD * HD : nullptr);
  float* cs = p.cs + head * (nc + 1) * HD * HD;

  load_state<HD>(sm.S, start);
  for (int i = 0; i < n; ++i) {
    __syncthreads();  // S complete; the last update's reads of K, V done
    store_state<HD>(cs + (size_t)(first + i) * HD * HD, sm.S);
    stage<HD>(p, sm, b, h, (first + i) * c, c, false, true, false);
    __syncthreads();
    factors<HD>(sm, false, true);
    __syncthreads();
    decay_update<HD>(sm.S, sm.T, sm.Ko, sm.V);
  }
  if (g == p.n_groups - 1) {  // the final state
    __syncthreads();
    store_state<HD>(cs + (size_t)nc * HD * HD, sm.S);
  }

  load_state<HD>(sm.G, nullptr);
  const int d = threadIdx.x % HD;
  float decay = 1.f;  // threads of token slot 0: key row d's
  for (int i = n - 1; i >= 0; --i) {
    __syncthreads();
    stage<HD>(p, sm, b, h, (first + i) * c, c, true, false, true);
    __syncthreads();
    factors<HD>(sm, true, false);
    __syncthreads();
    if (threadIdx.x < HD) decay *= sm.T[d];
    decay_update<HD>(sm.G, sm.T, sm.Rin, sm.D);
  }
  __syncthreads();
  float* slot = p.gs + (head * p.n_groups + g) * (HD + 1) * HD;
  store_state<HD>(slot, sm.G);
  if (threadIdx.x < HD) slot[HD * HD + d] = decay;
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
  float4 g = p.dstate ? ld4(p.dstate + head * HD * HD + at)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  float* slots = p.gs + head * p.n_groups * (HD + 1) * HD;
  for (int gi = p.n_groups - 1; gi >= 0; --gi) {
    float* slot = slots + (size_t)gi * (HD + 1) * HD;
    const float4 delta = ld4(slot + at);
    const float dec = slot[HD * HD + d];
    st4(slot + at, g);
    g = make_float4(fmaf(dec, g.x, delta.x), fmaf(dec, g.y, delta.y),
                    fmaf(dec, g.z, delta.z), fmaf(dec, g.w, delta.w));
  }
  if (p.ds0) st4(p.ds0 + head * HD * HD + at, g);
}

// ---------------------------------------------------------- gradient pass
// Block (group, head, batch row): the group's chunks from the last, G from
// the group's end gradient, each chunk's start and end states from the
// state pass's scratch.

template <int HD>
__global__ void __launch_bounds__(kThreads) wkv_bwd_grad(Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  constexpr int TQ = kThreads / HD;    // token slots
  constexpr int TPT = kMaxChunk / TQ;  // tokens a slot
  constexpr int TPR = kThreads / HD;   // threads a row of rowsum(G o S)
  const int tid = threadIdx.x;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c = p.chunk, nc = p.S / c;
  const int first = g * p.group, n = min(p.group, nc - first);
  const size_t head = (size_t)b * p.H + h;
  const float* cs = p.cs + head * (nc + 1) * HD * HD;
  const int d = tid % HD, tq = tid / HD;

  load_state<HD>(sm.G, p.drop_carry ? nullptr
                                    : p.gs + (head * p.n_groups + g) *
                                                 (HD + 1) * HD);
  load_state<HD>(sm.S, cs + (size_t)(first + n) * HD * HD);  // S_end
  if (tid < HD) sm.U[tid] = p.u[h * HD + tid];
  float du = 0.f;  // threads below HD: key column tid's share

  for (int i = n - 1; i >= 0; --i) {
    const int t0 = (first + i) * c;
    __syncthreads();  // G, S of this chunk's end; last chunk's reads done
    stage<HD>(p, sm, b, h, t0, c, true, true, true);
    {  // rowsum(G_end o S_end), TPR threads a row
      const int row = tid / TPR, part = tid % TPR;
      float acc = 0.f;
      for (int j = part; j < HD; j += TPR)
        acc = fmaf(sm.G[row][j], sm.S[row][j], acc);
#pragma unroll
      for (int o = TPR / 2; o > 0; o /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (part == 0) sm.P[row] = acc;
    }
    __syncthreads();
    load_state<HD>(sm.S, cs + (size_t)(first + i) * HD * HD);  // S_start
    factors<HD>(sm, true, true);
    {  // the bonus dots, a warp a token
      const int lane = tid % 32, warp = tid / 32;
      for (int t = warp; t < kMaxChunk; t += kThreads / 32) {
        float bv = 0.f, bu = 0.f;
        for (int e = lane; e < HD; e += 32) {
          bv = fmaf(sm.D[t][e], sm.V[t][e], bv);
          bu = fmaf(sm.R[t][e], sm.U[e] * sm.K[t][e], bu);
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2) {
          bv += __shfl_xor_sync(0xffffffffu, bv, o);
          bu += __shfl_xor_sync(0xffffffffu, bu, o);
        }
        if (lane == 0) {
          sm.Bv[t] = bv;
          sm.Bu[t] = bu;
        }
      }
    }
    __syncthreads();

    {  // the strictly lower scores, a thread a pair (t, s)
      const int t = tid / kMaxChunk, s = tid % kMaxChunk;
      float a = 0.f, dv = 0.f;
      if (s < t) {
        for (int e = 0; e < HD; ++e) {
          a = fmaf(sm.Rin[t][e], sm.Kn[s][e], a);
          dv = fmaf(sm.D[t][e], sm.V[s][e], dv);
        }
      }
      sm.A[t][s] = a;
      sm.Dv[t][s] = dv;
    }
    __syncthreads();

    {  // dr, dk, dv: column d over the tokens tq * TPT + m
      float sdo[TPT], gv[TPT], kg[TPT];
#pragma unroll
      for (int m = 0; m < TPT; ++m) sdo[m] = gv[m] = kg[m] = 0.f;
      for (int j = 0; j < HD; ++j) {
        const float sv = sm.S[d][j], gd = sm.G[d][j], gj = sm.G[j][d];
#pragma unroll
        for (int m = 0; m < TPT; ++m) {
          const int t = tq * TPT + m;
          sdo[m] = fmaf(sm.D[t][j], sv, sdo[m]);  // (dout_t S^T)[d]
          gv[m] = fmaf(gd, sm.V[t][j], gv[m]);    // (G v_t^T)[d]
          kg[m] = fmaf(sm.Ko[t][j], gj, kg[m]);   // (k_out_t G)[d]
        }
      }
      const float ud = sm.U[d];
#pragma unroll
      for (int m = 0; m < TPT; ++m) {
        const int t = tq * TPT + m;
        float ri = 0.f, ki = 0.f, vi = 0.f;
        for (int s = 0; s < kMaxChunk; ++s) {
          ri = fmaf(sm.Dv[t][s], sm.Kn[s][d], ri);  // s < t
          ki = fmaf(sm.Dv[s][t], sm.Rin[s][d], ki);  // s > t
          vi = fmaf(sm.A[s][t], sm.D[s][d], vi);     // s > t
        }
        const float cum = sm.Cum[t][d], w = sm.W[t][d];
        const float kk = sm.K[t][d], rr = sm.R[t][d];
        const float drn = expf(cum - w) * (sdo[m] + ri);
        const float dkn = expf(-cum) * ki + expf(sm.Cum[kMaxChunk - 1][d] -
                                                 cum) * gv[m];
        sm.Xr[t][d] = rr * drn;
        sm.Xk[t][d] = kk * dkn;
        if (t < c) {
          const size_t at = row_of(p, b, t0 + t, h, HD) + d;
          const float bv = sm.Bv[t];
          p.dr[at] = fmaf(bv, ud * kk, drn);
          p.dk[at] = fmaf(bv, ud * rr, dkn);
          p.dv[at] = fmaf(sm.Bu[t], sm.D[t][d], vi + kg[m]);
        }
      }
    }
    __syncthreads();

    if (tid < HD) {  // dlogw: the reverse sum over the chunk, and du
      float acc = sm.P[tid];
      for (int t = kMaxChunk - 1; t >= 0; --t) {
        const float next = t + 1 < kMaxChunk ? sm.Xr[t + 1][tid] : 0.f;
        acc += next - sm.Xk[t][tid];
        if (t < c) p.dlw[row_of(p, b, t0 + t, h, HD) + tid] = acc;
      }
      for (int t = 0; t < c; ++t)
        du = fmaf(sm.Bv[t], sm.R[t][tid] * sm.K[t][tid], du);
    }
    decay_update<HD>(sm.G, sm.T, sm.Rin, sm.D);
  }
  if (tid < HD) p.dup[(head * p.n_groups + g) * HD + tid] = du;
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
  const size_t smem = sizeof(Smem<HD>);
  static bool ready = false;
  if (!ready) {
    int rc = 0;
    for (auto fn : {wkv_bwd_state<HD>, wkv_bwd_grad<HD>})
      if (!rc)
        rc = (int)cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
    ready = true;
  }
  const dim3 grid(p.n_groups, p.H, p.B);
  wkv_bwd_state<HD><<<grid, kThreads, smem, s>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  wkv_bwd_scan<HD><<<dim3(HD * HD / 4 / scan_threads<HD>(), p.H, p.B),
                     scan_threads<HD>(), 0, s>>>(p);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  wkv_bwd_grad<HD><<<grid, kThreads, smem, s>>>(p);
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
  if (!p.gs || !p.cs || !p.dup) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Returns 0 or a cudaError_t. r, k, v, lw, dout and the outputs dr, dk, dv,
// dlw: (B, S, H, hd) f32 device pointers, contiguous and 16-byte aligned; u
// and du (H, hd); s0, dstate and ds0 (B, H, hd, hd), each may be null
// (zeros; zeros; not written); states: the forward's split scratch (B, H,
// n_groups, hd + 1, hd), null for one group (started from s0); scratch gs
// (B, H, n_groups, hd + 1, hd), cs (B, H, S / chunk + 1, hd, hd), dup (B, H,
// n_groups, hd). hd in {16, 64}; 1 <= chunk <= 16 dividing S; group: chunks
// a group. Asynchronous on `stream`.
extern "C" int rwkv_wkv_backward(
    const float* r, const float* k, const float* v, const float* lw,
    const float* u, const float* s0, const float* states, const float* dout,
    const float* dstate, float* dr, float* dk, float* dv, float* dlw,
    float* du, float* ds0, float* gs, float* cs, float* dup, int B, int S,
    int H, int hd, int chunk, int group, int n_groups, int drop_carry,
    void* stream) {
  Args p{r,  k,  v,  lw, u,  s0,  states, dout, dstate, dr, dk, dv,
         dlw, du, ds0, gs, cs, dup, B,     S,    H,      chunk, group,
         n_groups, drop_carry};
  const int rc = check(p, hd);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 16 ? launch<16>(p, s) : launch<64>(p, s);
}
