// Paged span attention for Hopper (sm_90a), bf16 route, plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:276
// paged_decode_span_attention (_paged_span_kernel) for bf16 queries over bf16
// or int8 pages; f32 queries or pages keep paged_attention.cu's body. For
// each row b of a (B, M) page table and each query t of a span of T tokens at
// position pos[b] + t, out[b, t, h] = softmax(q . k^T / sqrt(D)) v over the
// M * P slots of the row's pages in an (N, P, KV, D) pool; query head h reads
// KV head h / (H / KV). Slot s is valid iff s <= qpos and, with a window,
// s > qpos - window; invalid slots score the finite -1e30, so a row with no
// valid key gets the uniform mean of every slot of its table row. int8 pages
// carry bf16 (N, P, KV) scales and dequantize as the reference's gather
// does: int8 x scale in fp32, rounded to bf16.
//
// Bound on an H100: operations at a 128-token prefill span (each key meets
// T * groups query rows, 768 at Mixtral's heads: ~4 * rows * D flops per
// 4 * D bytes of K and V, past the ~295 flop/byte ridge), bytes at short
// spans (verify spans of 3 tokens, 16-token chunks), where each key meets
// only a few rows. The design answers the first with tensor cores fed from
// registers and many rows per gathered tile, the second with a key-range
// split that puts every SM on the stream.
//
// Design:
//   * a block owns one (row b, KV head, tile of packed query rows, key-range
//     split). Rows are the (t, g) pairs of the span, t-major, of the GQA
//     group that shares the KV head, packed without gaps: a block's rows may
//     start and end inside a token's group, so only the last row tile of a
//     span pads (the grid is B x KV x ceil(T * groups / rows) x splits), and
//     each gathered key feeds every query head of its group. The grid walks
//     the row tiles from the last one, whose causal ranges are the longest;
//   * warps of 16 rows: 12 warps (192 rows) at D = 112 and 128, 8 up to
//     D = 64, 4 at D = 256 (threads_of). Q fragments stay in registers for
//     the whole key walk up to D = 64 and are read from shared memory at
//     each use above, where registers run out first;
//   * K and V stream through a ring of 64-key stages in dynamic shared
//     memory (2 to 4 stages, as many as fit) by 16-byte cp.async.cg copies
//     addressed through the page ids of the stage's keys, so any page size
//     works. Those ids (at most 65 a stage) are read from the table one
//     stage ahead into a small ring of their own, so shared memory does not
//     grow with the table's width. Tiles j + 1 .. j + 3 are in flight while
//     tile j is multiplied: one __syncthreads a tile. Rows are padded by 16
//     bytes so ldmatrix is free of bank conflicts; slots past the streamed
//     range are zero-filled (src-size 0), since garbage V times a
//     probability of 0 can be NaN;
//   * S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 accumulation), K
//     fragments by ldmatrix. Scale, mask and the online softmax stay in the
//     accumulator registers, in the exp2 domain; a row's max and sum are quad
//     shuffles. Only tiles that straddle the causal diagonal, the window's
//     edge or the end of the streamed range pay for the mask. A row's
//     running max moves, and its sum and accumulator are rescaled, only when
//     a tile raises it by more than 2^8 for some row of the warp, so most
//     tiles skip the rescale. The score fragments become the bf16 A operand
//     of O += P V with no trip through shared memory, V fragments by
//     ldmatrix.trans; O stays in registers;
//   * int8 pages: cp.async brings the int8 bytes into the ring; cp.async has
//     no 2-byte form, so each of 128 threads loads one bf16 scale into a
//     register when it issues a stage and stores it beside the stage after
//     the tile's products. One dequantize pass per tile writes a bf16 K and
//     V tile, and the register core is the same as for bf16 (two
//     __syncthreads a tile);
//   * with fewer blocks than the card holds at once, each block's key range
//     is split (choose_splits); the splits write (acc, m, l) to an fp32
//     workspace and a second kernel merges them, as paged_attention.cu's
//     combine_kernel does;
//   * padding rows load zero queries, never produce NaN and write nothing;
//     warps whose 16 rows are all padding skip the products.
// The key-range rules (block_range, key_ok) are paged_attention.cu's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;  // keys of a ring stage
// page ids of a stage: its 64 keys lie on at most 63 / P + 2 <= 65 pages
constexpr int kPids = kKeys + 1;
constexpr int kPidLd = 68;  // ints a stage's ids take, 16-byte aligned
constexpr int kMaxSplits = 32;
constexpr size_t kSmemMax = 232448;  // an H100 block's opt-in maximum
// a row's running max is moved (and its sums rescaled) only when a tile
// raises it by more than this (log2 units): exp2(s - m) stays <= 256
constexpr float kRescaleAbove = 8.f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Args {
  const __nv_bfloat16* q;
  const void* k_pages;
  const void* v_pages;
  const __nv_bfloat16* k_scale;
  const __nv_bfloat16* v_scale;
  const int* table;
  const int* pos;
  __nv_bfloat16* out;
  float* part;  // splits > 1: partial acc (splits, rows, D) then (m, l)
  int B, T, H, KV, N, P, M;
  int p_shift;       // log2(P) when P is a power of two, else -1
  int window;        // <= 0: no window
  float scale_log2;  // D^-0.5 * log2(e): scores in the exp2 domain
  int splits;        // blocks sharing one key range
  int row_tiles;     // ceil(T * groups / rows of a block)
};

// Warps of a block, each owning 16 query rows: twelve at D = 112 and 128
// (192 rows share each gathered tile, and three warps a scheduler hide each
// other's latency), eight up to D = 64 (the Q fragments then fit in
// registers), four at D = 256, whose accumulator takes twice the registers
// and whose tiles twice the shared memory.
template <int D>
constexpr int threads_of() {
  return 32 * (D <= 64 ? 8 : D <= 128 ? 12 : 4);
}

// Tiling and shared-memory layout of one instantiation, in bytes.
template <int D, bool QUANT>
struct Cfg {
  static constexpr int kThreads = threads_of<D>();
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRows = 16 * kWarps;  // packed query rows
  // Q fragments in registers for the whole key walk, else read from
  // shared memory at each use (what fits without spilling)
  static constexpr bool kQRegs = D <= 64;
  static constexpr int kLd = D + 8;  // bf16 row stride of the Q, K, V tiles
  static constexpr int kTile = kKeys * kLd * 2;  // one bf16 K or V tile
  static constexpr int kQBytes = kRows * kLd * 2;
  static constexpr int kKeyBytes = QUANT ? D : 2 * D;  // a key's page row
  // a ring stage: K then V (int8 rows packed, bf16 rows padded), then for
  // int8 the stage's bf16 K and V scales
  static constexpr int kStage = QUANT ? 2 * kKeys * D + 2 * kKeys * 2
                                      : 2 * kTile;
  static constexpr int kDequant = QUANT ? 2 * kTile : 0;  // bf16 K, V tile
  // as many stages (2 to 4) as fit in 220 KB beside Q and the bf16 tile
  static constexpr int kFree = 220 * 1024 - kQBytes - kDequant;
  static constexpr int kStages = kFree / kStage < 2   ? 2
                                 : kFree / kStage > 4 ? 4
                                                      : kFree / kStage;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kQOff = kRing + kDequant;
  static constexpr int kPidOff = kQOff + kQBytes;  // the page-id ring
  static constexpr int kSmem = kPidOff + kStages * kPidLd * 4;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kStage % 16 == 0 && kTile % 16 == 0, "16-byte alignment");
  static_assert(kSmem <= kSmemMax, "shared memory of a block");
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

// Key range of one block: the slots valid for some of its query rows, or
// the whole table row when one of them has no valid slot (the reference
// then averages every slot), cut to this block's share of whole tiles.
// paged_attention.cu's rule, with the block's token count passed in.
struct Range {
  int base;     // position of the block's first query
  int nt;       // span tokens in the block
  int slot_hi;  // end of the streamed range (slots past it weigh nothing)
  int k_begin, k_end;  // this split's tiles
};

__device__ __forceinline__ Range block_range(const Args& a, int b, int t0,
                                             int nt, int split) {
  Range g;
  g.nt = nt;
  const int S = a.M * a.P, P = a.P;
  g.base = a.pos[b] + t0;
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
  const int ntiles = (g.slot_hi - slot_lo + kKeys - 1) / kKeys;
  const int per = (ntiles + a.splits - 1) / a.splits;
  g.k_begin = slot_lo + min(ntiles, split * per) * kKeys;
  g.k_end = slot_lo + min(ntiles, (split + 1) * per) * kKeys;
  return g;
}

__device__ __forceinline__ bool key_ok(const Args& a, int slot, int qp) {
  return slot <= qp && (a.window <= 0 || slot > qp - a.window);
}

__device__ __forceinline__ int page_of(const Args& a, int slot) {
  return a.p_shift >= 0 ? slot >> a.p_shift : slot / a.P;
}

// Entry i of the page ids of the stage whose keys start at slot k0: the
// table entry of page page_of(k0) + i of row b, clamped into the pool (0
// past the row's end, where no streamed slot lies).
__device__ __forceinline__ int load_pid(const Args& a, int b, int k0,
                                        int i) {
  const int pg = page_of(a, k0) + i;
  if (pg >= a.M) return 0;
  return min(max(a.table[(size_t)b * a.M + pg], 0), a.N - 1);
}

// Pool row (page row, KV head) of a slot of the stage whose keys start at
// k0 and whose page ids are pids.
__device__ __forceinline__ size_t pool_row(const Args& a, const int* pids,
                                           int k0, int slot, int kvh) {
  const int pg = page_of(a, slot);
  return ((size_t)pids[pg - page_of(a, k0)] * a.P + (slot - pg * a.P)) *
             a.KV + kvh;
}

// Issue the gather of keys [k0, k0 + kKeys) into a ring stage: K then V,
// 16-byte cp.async chunks; slots at or past slot_hi are zero-filled.
template <int D, bool QUANT>
__device__ __forceinline__ void issue_tile(const Args& a, const int* pids,
                                           int k0, int slot_hi, int kvh,
                                           unsigned char* stage) {
  using C = Cfg<D, QUANT>;
  constexpr int kChunks = C::kKeyBytes / 16;  // per key row
  const unsigned char* kp = static_cast<const unsigned char*>(a.k_pages);
  const unsigned char* vp = static_cast<const unsigned char*>(a.v_pages);
  // bf16 rows land padded (kLd), int8 rows packed
  constexpr int kDst = QUANT ? D : C::kLd * 2;
  constexpr int kVOff = QUANT ? kKeys * D : C::kTile;
#pragma unroll
  for (int it = 0; it < (kKeys * kChunks + C::kThreads - 1) / C::kThreads;
       ++it) {
    const int i = threadIdx.x + it * C::kThreads;
    if (i >= kKeys * kChunks) break;
    const int key = i / kChunks, c = i - key * kChunks;
    const int slot = k0 + key;
    const bool ok = slot < slot_hi;
    const size_t off =
        (ok ? pool_row(a, pids, k0, slot, kvh) : 0) * C::kKeyBytes +
        c * 16;
    cp_async16(stage + key * kDst + c * 16, kp + off, ok ? 16 : 0);
    cp_async16(stage + kVOff + key * kDst + c * 16, vp + off, ok ? 16 : 0);
  }
}

// int8: the scale of thread tid < 2 * kKeys in the stage (keys 0-63: K,
// 64-127: V); 0 past slot_hi, where the zero-filled bytes make zeros anyway.
__device__ __forceinline__ __nv_bfloat16 load_scale(const Args& a,
                                                    const int* pids, int k0,
                                                    int slot_hi, int kvh) {
  const int key = threadIdx.x & (kKeys - 1);
  const int slot = k0 + key;
  if (slot >= slot_hi) return __float2bfloat16(0.f);
  const __nv_bfloat16* s = threadIdx.x < kKeys ? a.k_scale : a.v_scale;
  return s[pool_row(a, pids, k0, slot, kvh)];
}

template <int D>
__device__ __forceinline__ __nv_bfloat16* stage_scales(unsigned char* stage) {
  return reinterpret_cast<__nv_bfloat16*>(stage + 2 * kKeys * D);
}

// int8: the stage's K and V rows times their scales, rounded to bf16, into
// the dequantized tiles (row stride kLd).
template <int D>
__device__ __forceinline__ void dequant_tile(const unsigned char* stage,
                                             __nv_bfloat16* kv) {
  using C = Cfg<D, true>;
  constexpr int kChunks = D / 16;
  const __nv_bfloat16* sc =
      reinterpret_cast<const __nv_bfloat16*>(stage + 2 * kKeys * D);
#pragma unroll
  for (int it = 0; it < (2 * kKeys * kChunks + C::kThreads - 1) / C::kThreads;
       ++it) {
    const int i = threadIdx.x + it * C::kThreads;
    if (i >= 2 * kKeys * kChunks) break;
    const int row = i / kChunks, c = i - row * kChunks;  // row: K 0-63, V
    const uint4 raw =
        *reinterpret_cast<const uint4*>(stage + row * D + c * 16);
    const float s = __bfloat162float(sc[row]);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      h[j] = pack_bf16(static_cast<float>(e[2 * j]) * s,
                       static_cast<float>(e[2 * j + 1]) * s);
    uint4* dst = reinterpret_cast<uint4*>(kv + row * C::kLd + c * 16);
    dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
    dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// The online-softmax step of one row pair of a thread (rows g and g + 8 of
// its warp's 16) over a 64-key tile of scaled, masked scores s, and P as
// the bf16 A fragments of the PV product: score tiles 2kk and 2kk + 1 are
// the 16 keys of PV step kk.
template <int NT>
__device__ __forceinline__ void softmax_tile(const float (&s)[8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&o)[NT][4],
                                             uint32_t (&pf)[4][4]) {
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      x = fmaxf(x, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    mx[h] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  }
  // move the running max only when some row of the warp needs it
  if (__any_sync(0xffffffffu, mx[0] > m[0] + kRescaleAbove ||
                                  mx[1] > m[1] + kRescaleAbove)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], mx[h]);
      const float corr = ex2(m[h] - mn);
      m[h] = mn;
      l[h] *= corr;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ls = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = ex2(s[n][2 * h] - m[h]);
      const float p1 = ex2(s[n][2 * h + 1] - m[h]);
      ls += p0 + p1;
      pf[n / 2][(n & 1) * 2 + h] = pack_bf16(p0, p1);
    }
    l[h] += ls;
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(threads_of<D>())
    span_kernel(const Args a) {
  using C = Cfg<D, QUANT>;
  constexpr int kLd = C::kLd;
  constexpr int kS = C::kStages;
  constexpr int kRows = C::kRows;
  constexpr int kThreads = C::kThreads;
  constexpr int NT = D / 8;  // 8-column output tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + C::kQOff);
  int* pids = reinterpret_cast<int*>(smem + C::kPidOff);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // quad and lane in it
  const int split = blockIdx.x % a.splits;
  const int tile = a.row_tiles - 1 - (int)blockIdx.x / a.splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int groups = a.H / a.KV;
  const int n_rows = a.T * groups;  // packed rows of the span
  const int r0 = tile * kRows;
  const int t0 = r0 / groups;
  const Range rg = block_range(
      a, b, t0, (min(r0 + kRows, n_rows) - 1) / groups - t0 + 1, split);
  const int n_tiles = (rg.k_end - rg.k_begin) / kKeys;

  // page ids of the first kS tiles (stage s's ids in slot s)
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (s < n_tiles && tid < kPids)
      pids[s * kPidLd + tid] = load_pid(a, b, rg.k_begin + s * kKeys, tid);
  __syncthreads();

  // Q rows (zeros past the span) join the first tile's copy group
#pragma unroll
  for (int it = 0; it < (kRows * (D / 8) + kThreads - 1) / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (i >= kRows * (D / 8)) break;
    const int row = i / (D / 8), c = i - row * (D / 8);
    const int r = r0 + row;
    const bool ok = r < n_rows;
    const int tq = ok ? r / groups : 0, gq = ok ? r - tq * groups : 0;
    const __nv_bfloat16* src =
        a.q + (((size_t)b * a.T + tq) * a.H + kvh * groups + gq) * D + c * 8;
    cp_async16(qs + row * kLd + c * 8, src, ok ? 16 : 0);
  }
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < n_tiles) {
      const int k0 = rg.k_begin + s * kKeys;
      unsigned char* st = smem + s * C::kStage;
      const int* ids = pids + s * kPidLd;
      issue_tile<D, QUANT>(a, ids, k0, rg.slot_hi, kvh, st);
      if (QUANT && tid < 2 * kKeys)
        stage_scales<D>(st)[tid] = load_scale(a, ids, k0, rg.slot_hi, kvh);
    }
    cp_async_commit();
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int row_a = r0 + warp * 16 + g;  // packed rows g and g + 8
  const int qp[2] = {a.pos[b] + row_a / groups,
                     a.pos[b] + (row_a + 8) / groups};
  const bool live = r0 + warp * 16 < n_rows;  // a warp of padding rests
  const int qlo = rg.base, qhi = rg.base + rg.nt - 1;
  // ldmatrix lane offsets: Q (A fragments, 16 rows x 16 dims), K (two
  // 8-key tiles x 16 dims) and V (transposed, 16 keys x two 8-dim tiles)
  const __nv_bfloat16* qw =
      qs + (warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
  const int k_lane = ((lane >> 4) * 8 + (lane & 7)) * kLd +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = (((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                     (lane >> 4) * 8;

  uint32_t qf[C::kQRegs ? D / 16 : 1][4];
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kS - 2>();  // Q and tile j have landed
    __syncthreads();  // ... for every thread, and tile j - 1 is consumed
    if (C::kQRegs && j == 0) {
#pragma unroll
      for (int kk = 0; kk < (C::kQRegs ? D / 16 : 1); ++kk)
        ldsm_x4(qf[kk], qw + kk * 16);
    }
    const int jn = j + kS - 1;
    __nv_bfloat16 sc_next = __float2bfloat16(0.f);
    if (jn < n_tiles) {
      const int kn = rg.k_begin + jn * kKeys;
      const int* ids = pids + (jn % kS) * kPidLd;
      issue_tile<D, QUANT>(a, ids, kn, rg.slot_hi, kvh,
                           smem + (jn % kS) * C::kStage);
      if (QUANT && tid < 2 * kKeys)
        sc_next = load_scale(a, ids, kn, rg.slot_hi, kvh);
    }
    cp_async_commit();
    // the page ids of tile j + kS go where tile j's were (last read when
    // tile j was issued, before this tile's barrier); stored after the
    // products, read after the next barrier
    const int jp = j + kS;
    const bool fetch = jp < n_tiles && tid < kPids;
    const int pid_next =
        fetch ? load_pid(a, b, rg.k_begin + jp * kKeys, tid) : 0;

    unsigned char* st = smem + (j % kS) * C::kStage;
    const __nv_bfloat16* kt = reinterpret_cast<const __nv_bfloat16*>(st);
    if constexpr (QUANT) {
      __nv_bfloat16* dq = reinterpret_cast<__nv_bfloat16*>(smem + C::kRing);
      dequant_tile<D>(st, dq);
      __syncthreads();
      kt = dq;
    }
    const __nv_bfloat16* vt = kt + kKeys * kLd;
    const int k0 = rg.k_begin + j * kKeys;

    if (live) {
      // raw scores S = Q K^T of this warp's 16 rows x 64 keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[C::kQRegs ? kk : 0][e];
        } else {
          ldsm_x4(qa, qw + kk * 16);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t kb[4];
          ldsm_x4(kb, kt + p * 16 * kLd + kk * 16 + k_lane);
          mma_bf16(s[2 * p], qa, kb);
          mma_bf16(s[2 * p + 1], qa, kb + 2);
        }
      }

      // scale; only a tile that straddles the diagonal, the window's edge
      // or the end of the streamed range pays for the mask
      const bool interior = k0 + kKeys - 1 <= qlo &&
                            (a.window <= 0 || k0 > qhi - a.window) &&
                            k0 + kKeys <= rg.slot_hi;
      if (interior) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= a.scale_log2;
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int slot = k0 + n * 8 + t * 2 + (e & 1);
            float x = -INFINITY;  // past the streamed range: no weight
            if (slot < rg.slot_hi)
              x = key_ok(a, slot, qp[e >> 1]) ? s[n][e] * a.scale_log2
                                              : kNegInf;
            s[n][e] = x;
          }
      }
      uint32_t pf[4][4];
      softmax_tile(s, m_r, l_r, o, pf);

      // O += P V
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vt + kk * 16 * kLd + dp * 16 + v_lane);
          mma_bf16(o[2 * dp], pf[kk], vb);
          mma_bf16(o[2 * dp + 1], pf[kk], vb + 2);
        }
      }
    }
    if (QUANT && jn < n_tiles && tid < 2 * kKeys)
      stage_scales<D>(smem + (jn % kS) * C::kStage)[tid] = sc_next;
    if (fetch) pids[(jp % kS) * kPidLd + tid] = pid_next;
  }
  cp_async_wait<0>();  // no copy in flight when the block ends

  // the quad's shares of l; then out = acc / max(l, 1e-30), or the split's
  // partial state for the merge
  const size_t n_out = (size_t)a.B * a.T * a.H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = row_a + 8 * h;
    if (r >= n_rows) continue;
    const int tq = r / groups, gq = r - tq * groups;
    const size_t row = ((size_t)b * a.T + tq) * a.H + kvh * groups + gq;
    if (a.splits == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      __nv_bfloat16* dst = a.out + row * D + t * 2;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    } else {
      float* dst = a.part + ((size_t)split * n_out + row) * D + t * 2;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + n * 8) =
            make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (t == 0) {
        float* ml = a.part + (size_t)a.splits * n_out * D;
        ml[((size_t)split * n_out + row) * 2] = m_r[h];
        ml[((size_t)split * n_out + row) * 2 + 1] = l;
      }
    }
  }
}

// Merge the splits' partial softmax states (exp2 domain) of one query row
// per block: paged_attention.cu's combine_kernel.
__global__ void combine_kernel(const float* part, __nv_bfloat16* out,
                               int n_rows, int D, int splits) {
  const int row = blockIdx.x;
  const float* ml = part + (size_t)splits * n_rows * D;
  float mg = -INFINITY;
  for (int s = 0; s < splits; ++s)
    mg = fmaxf(mg, ml[((size_t)s * n_rows + row) * 2]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t i = ((size_t)s * n_rows + row) * 2;
    l += ex2(ml[i] - mg) * ml[i + 1];
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float x = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t i = (size_t)s * n_rows + row;
      x += ex2(ml[i * 2] - mg) * part[i * D + d];
    }
    out[(size_t)row * D + d] = __float2bfloat16(x / fmaxf(l, 1e-30f));
  }
}

// Opt an instantiation in to its dynamic shared memory, and to the largest
// shared-memory carveout, so two blocks share an SM where they fit.
template <int D, bool QUANT>
cudaError_t prepare() {
  static bool opted_in = false;  // per instantiation
  if (opted_in) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      span_kernel<D, QUANT>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(span_kernel<D, QUANT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<D, QUANT>::kSmem);
  if (e == cudaSuccess) opted_in = true;
  return e;
}

// Key-range splits for `blocks` blocks on `slots` block slots: with fewer
// blocks than slots, as many splits as fit in one wave; with more, the
// split count up to 4 whose last wave is fullest (the fewest on a tie).
inline int choose_splits(int blocks, int slots, int max_tiles) {
  int splits = 1;
  if (blocks <= slots) {
    splits = slots / blocks;
  } else {
    double best = 0.0;
    for (int s = 1; s <= 4; ++s) {
      const int waves = (blocks * s + slots - 1) / slots;
      const double full = (double)blocks * s / ((double)waves * slots);
      if (full > best + 1e-9) {
        best = full;
        splits = s;
      }
    }
  }
  return std::max(1, std::min(std::min(splits, max_tiles), kMaxSplits));
}

template <int D, bool QUANT>
int plan(int B, int T, int H, int KV, int P, int M, int num_sms, int* out) {
  using C = Cfg<D, QUANT>;
  cudaError_t e = prepare<D, QUANT>();
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, span_kernel<D, QUANT>, C::kThreads, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidValue;
  const int row_tiles = (T * (H / KV) + C::kRows - 1) / C::kRows;
  out[0] = choose_splits(B * KV * row_tiles, num_sms * per_sm,
                         (M * P + kKeys - 1) / kKeys);
  out[1] = C::kSmem;
  out[2] = per_sm;
  return 0;
}

template <int D, bool QUANT>
int launch(Args a, cudaStream_t stream) {
  using C = Cfg<D, QUANT>;
  const cudaError_t prep = prepare<D, QUANT>();
  if (prep != cudaSuccess) return (int)prep;
  a.row_tiles = (a.T * (a.H / a.KV) + C::kRows - 1) / C::kRows;
  const dim3 grid(a.row_tiles * a.splits, a.KV, a.B);
  span_kernel<D, QUANT><<<grid, C::kThreads, C::kSmem, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const int n_rows = a.B * a.T * a.H;
  combine_kernel<<<n_rows, 64, 0, stream>>>(a.part, a.out, n_rows, D,
                                            a.splits);
  return (int)cudaGetLastError();
}

template <bool QUANT>
int plan_d(int D, int B, int T, int H, int KV, int P, int M, int num_sms,
           int* out) {
  switch (D) {
    case 16: return plan<16, QUANT>(B, T, H, KV, P, M, num_sms, out);
    case 64: return plan<64, QUANT>(B, T, H, KV, P, M, num_sms, out);
    case 112: return plan<112, QUANT>(B, T, H, KV, P, M, num_sms, out);
    case 128: return plan<128, QUANT>(B, T, H, KV, P, M, num_sms, out);
    case 256: return plan<256, QUANT>(B, T, H, KV, P, M, num_sms, out);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool QUANT>
int launch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, QUANT>(a, s);
    case 64: return launch<64, QUANT>(a, s);
    case 112: return launch<112, QUANT>(a, s);
    case 128: return launch<128, QUANT>(a, s);
    case 256: return launch<256, QUANT>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch plan for a shape: plan[0] = splits (blocks per key range; the
// caller provides a workspace of splits * B * T * H * (D + 2) floats when
// > 1), plan[1] = dynamic shared memory of a block in bytes, plan[2] =
// blocks an SM holds at once. Returns 0, cudaErrorInvalidValue for a head
// dim or page dtype the kernel does not take, or the error of the
// occupancy query. Any table width M is taken.
extern "C" int paged_span_plan(int page_dtype, int B, int T, int H, int KV,
                               int D, int P, int M, int num_sms, int* plan) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || P <= 0 || M <= 0 ||
      num_sms <= 0 || (page_dtype != kBF16 && page_dtype != kI8))
    return (int)cudaErrorInvalidValue;
  return page_dtype == kI8
             ? plan_d<true>(D, B, T, H, KV, P, M, num_sms, plan)
             : plan_d<false>(D, B, T, H, KV, P, M, num_sms, plan);
}

// Returns 0 or the cudaError_t of the launch. Pointers are device pointers
// to contiguous tensors, 16-byte aligned: q and out (B, T, H, D) bf16; pages
// (N, P, KV, D) of page_dtype (1 bf16, 2 int8); scales (N, P, KV) bf16 for
// int8 pages (else null); table (B, M) and pos (B,) int32 (query t of row b
// sits at pos[b] + t); workspace as paged_span_plan says (null when splits
// == 1). Asynchronous on `stream`.
extern "C" int paged_span_attention(int page_dtype, const void* q,
                                    const void* k_pages, const void* v_pages,
                                    const void* k_scale, const void* v_scale,
                                    const void* table, const void* pos,
                                    void* out, void* workspace, int B, int T,
                                    int H, int KV, int D, int N, int P, int M,
                                    int window, float scale, int splits,
                                    void* stream) {
  if (B == 0 || T == 0) return 0;
  if (B < 0 || T < 0 || KV <= 0 || H % KV != 0 || P <= 0 || M <= 0 ||
      N <= 0 || splits <= 0 || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool quant = page_dtype == kI8;
  if (!quant && page_dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (quant != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k_pages, v_pages, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;

  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(workspace);
  a.B = B; a.T = T; a.H = H; a.KV = KV; a.N = N; a.P = P; a.M = M;
  a.p_shift = (P & (P - 1)) == 0 ? __builtin_ctz((unsigned)P) : -1;
  a.window = window;
  a.scale_log2 = scale * kLog2e;
  a.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quant ? launch_d<true>(D, a, s) : launch_d<false>(D, a, s);
}
