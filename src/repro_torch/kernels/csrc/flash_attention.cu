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
// bf16 design (warpgroup MMA over a TMA key/value ring):
//   * persistent blocks, one an SM (288 threads: two consumer warpgroups
//     of 64 query rows and one producer warp), walk work items of 128
//     query rows of one head (and one key-range split). Items are ordered
//     heaviest first and dealt to the blocks in a snake (round k forwards
//     when k is even, backwards when odd), so that the blocks' sums of
//     causal work come out even;
//   * the producer's one thread loads each item's Q tile (two in flight
//     at tile width 64 and 128), then keeps K and V tiles in flight
//     through a ring of 2-4 stages in shared memory (separate full and
//     free mbarriers for K and V, so a stage's K is released as soon as
//     its scores are done); the ring runs on across items. Loads are TMA
//     copies over a 3D tensor map of (D, S, BH): a box never crosses into
//     the next head, rows past S and columns past D arrive as zeros, and
//     every tile lands in 64-column panels in the 128-byte swizzle that
//     wgmma reads;
//   * S = Q K^T is wgmma m64nKTk16 with both operands in shared memory;
//     O += P V is wgmma m64nDPk16 with P in registers (the score
//     accumulator converted to bf16 words: a thread's score pairs are
//     exactly its A fragment, FlashAttention-3's layout) and V through a
//     transposed (MN-major) descriptor. S, P, O and the softmax state stay
//     in registers; a row's max and sum are quad shuffles;
//   * the two products overlap: tile j's scores are issued, then tile
//     j - 1's PV product, and tile j's softmax runs while the PV product is
//     in flight. P is converted only once no product is in flight (plain
//     writes to a running wgmma's input registers make ptxas serialize
//     it). The two warpgroups take turns to issue (named barriers), so one's
//     softmax runs beside the other's tensor-core work;
//   * one fixed order of every sum: a call is bit-reproducible;
//   * only tiles that cross the causal diagonal, a window's edge or the
//     last key (kv_len) are masked; a warpgroup skips a tile wholly masked
//     for its 64 rows. Skipping is exact: before a row's first valid key
//     the correction exp(-1e30 - m) is 0 in fp32 and wipes what masked keys
//     added, and after its last one their probabilities are 0;
//   * the softmax runs in the exp2 domain, the scale times log2(e) folded
//     into one FMA per score; O is rescaled only when a row of the warp
//     moved its max;
//   * key-range splits for short query blocks: when the items leave most
//     SMs idle, the wrapper's plan (flash_plan) splits each item's key
//     tiles into contiguous ranges; each split writes its partial (acc, m,
//     l) to a workspace and a merge kernel combines the splits in a fixed
//     order;
//   * D from 1 to 256: the wrapper pads D to a multiple of 8 (TMA's 16-byte
//     strides) and the tile width DP is 64, 128 or 256 columns (zeros past
//     D); keys a tile: 128, 64, 64; stages: 4, 4, 2;
//   * registers: a block of 9 warps puts 3 on one of the SM's four
//     schedulers, so ptxas caps every thread at 168 (setmaxnreg does not
//     raise what ptxas allocates); 64-key tiles keep DP 128 within it, DP
//     256 (no model has it) spills.
//
// f32 design: 64 rows x 4 threads a block; each thread holds a quarter of
// its row's query and accumulator in registers, the fp32 dot over D is a
// quad shuffle reduction, and K and V tiles of 32 keys sit in fp32 shared
// memory (CUDA-core products, exact to fp32 rounding); no split of the key
// range: every output element is summed in one fixed order.
//
// Planted fault: the wrapper may pass kv_len = Sk - 1, so the kernel reads
// rows of Sk keys but weighs only the first Sk - 1.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kBlockQ = 64;        // query rows per block (f32)
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
// bf16: wgmma over a TMA key/value ring
// ---------------------------------------------------------------------------

constexpr int kRows = 128;     // query rows of a work item: 2 warpgroups x 64
constexpr int kThreads = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int kPanel = 64;     // bf16 columns of a 128-byte swizzled panel

// Tile shape of the bf16 body at tile width DP; flash_plan in
// flash_attention.py mirrors it, and flash_bf16_tile reports it so that a
// test holds the two together.
template <int DP>
struct Tile {
  static constexpr int kKeys = DP > 64 ? 64 : 128;
  static constexpr int kStages = DP > 128 ? 2 : 4;
  static constexpr int kQBufs = DP > 128 ? 1 : 2;  // Q tiles in flight
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kQBytes = kRows * DP * 2;
  static constexpr int kKVBytes = kKeys * DP * 2;  // one K or V tile
  static constexpr int kBars = 4 * kStages + 2 * kQBufs;
  // 1024: the swizzled tiles need a 1024-byte-aligned base
  static constexpr int kSmem =
      1024 + kQBufs * kQBytes + 2 * kStages * kKVBytes + kBars * 8;
};

struct BArgs {
  __nv_bfloat16* out;
  float* work;  // partial (acc, m, l) of the key-range splits, or null
  int BH, Sq, Sk;
  int kv_len;  // keys that carry weight: Sk, or less for a planted fault
  int D;       // row width of q, k, v and out (a multiple of 8)
  int causal, window, splits;
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
// A wait that never ends is a fault of the ring's bookkeeping: it traps
// (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 3D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma descriptor of an operand in 128-byte-swizzled shared memory: lbo
// and sbo in bytes (K-major: sbo = 1024, the next 8 rows; MN-major: lbo =
// the next 64-column panel, sbo = 1024, the next 8 rows of K).
__device__ __forceinline__ uint64_t desc128(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes, so the
// compiler neither moves their uses across a wait nor reuses them early.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d (64 x N, f32) = (scale_d ? d : 0) + A . B^T, A (64 x 16) and B (N x 16)
// K-major in shared memory. Accumulator layout: thread t of the warpgroup
// holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and, in each 8-column chunk
// c, columns 8 c + 2 (t % 4) (+ 1): d[4 c + {0, 1, 2, 3}] = (row, col),
// (row, col + 1), (row + 8, col), (row + 8, col + 1).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

// d (64 x N, f32) += A . B, A (64 x 16) in registers (4 words a thread: the
// pairs of two adjacent 8-column chunks of the accumulator layout) and B
// (16 x N) MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// S (64 x KT) = Q . K^T over DP columns: qs is this warpgroup's first row
// in Q's panel 0 (panels kRows * 128 bytes apart), ks a K tile's panel 0
// (panels KT * 128 bytes apart). Advancing 32 bytes within a swizzled
// 128-byte row is the next 16 columns.
template <int DP, int KT>
__device__ __forceinline__ void qk_product(float (&s)[KT / 2],
                                           const uint8_t* qs,
                                           const uint8_t* ks) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int p = kk / 4, c = (kk % 4) * 32;
    wgmma_ss<KT>(s, desc128(qs + p * kRows * 128 + c, 16, 1024),
                 desc128(ks + p * KT * 128 + c, 16, 1024), kk > 0);
  }
}

// O (64 x DP) += P (64 x KT, bf16 words in registers) . V (KT x DP): key
// step kk reads P's words 4 kk .. 4 kk + 3 and V's rows 16 kk .. 16 kk + 15.
template <int DP, int KT>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2],
                                           const uint32_t (&p)[KT / 4],
                                           const uint8_t* vs) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_rs<DP>(o, &p[4 * kk], desc128(vs + kk * 16 * 128, KT * 128, 1024));
}

// A row's state: m in log2-scaled units (scores times scale * log2(e)).
struct RowState {
  float m_a, m_b, l_a, l_b;
};

// The online softmax of one key tile, in place: s holds raw scores on
// entry and the probabilities on exit; returns the rescale factors of the
// accumulator rows (1 where a row's max did not move). MASK: the tile
// crosses the causal diagonal, a window's edge or kv_len.
template <int KT, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[KT / 2],
                                             RowState& st, float& corr_a,
                                             float& corr_b, const BArgs& a,
                                             int k0, int row_a, int col) {
  const float c = a.scale_log2;
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    float x = s[i];
    if (MASK) {
      const int kp = k0 + 8 * (i / 4) + col + (i & 1);
      const int qp = row_a + ((i & 2) ? 8 : 0);
      const bool ok = (!a.causal || kp <= qp) &&
                      (a.window <= 0 || qp - kp < a.window);
      x = kp >= a.kv_len ? -INFINITY : (ok ? x * c : kNegInf);
      s[i] = x;
    }
    if (i & 2) mx_b = fmaxf(mx_b, x);
    else mx_a = fmaxf(mx_a, x);
  }
  if (!MASK) {  // c > 0: the max of the scaled scores is the scaled max
    mx_a *= c;
    mx_b *= c;
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
  }
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
  corr_a = mn_a == st.m_a ? 1.f : ex2(st.m_a - mn_a);
  corr_b = mn_b == st.m_b ? 1.f : ex2(st.m_b - mn_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const float mn = (i & 2) ? mn_b : mn_a;
    const float e = MASK ? ex2(s[i] - mn) : ex2(fmaf(s[i], c, -mn));
    s[i] = e;
    if (i & 2) ls_b += e;
    else ls_a += e;
  }
  st.l_a = st.l_a * corr_a + ls_a;
  st.l_b = st.l_b * corr_b + ls_b;
}

// The probabilities as the PV product's A operand: a thread's pairs of
// score columns are its bf16 words. Runs only when no product is in
// flight (plain writes to a wgmma's input registers would serialize it).
template <int KT>
__device__ __forceinline__ void to_bf16_words(const float (&s)[KT / 2],
                                              uint32_t (&p)[KT / 4]) {
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Rescales this thread's accumulator rows; lazily, by warp: skipped when
// no row of the warp moved its max (a factor of 1 is exact either way).
template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], float corr_a,
                                        float corr_b) {
  if (!__any_sync(0xffffffffu, corr_a != 1.f || corr_b != 1.f)) return;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;
}

// The block's shared memory: Q tiles, ST stages of K, ST of V, then the
// mbarriers of the ring and of the Q tiles.
template <int DP>
struct Smem {
  using T = Tile<DP>;
  uint8_t *qs, *ks, *vs;
  uint64_t *full_k, *full_v, *free_k, *free_v, *full_q, *free_q;
  __device__ explicit Smem(uint8_t* raw) {
    qs = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    ks = qs + T::kQBufs * T::kQBytes;
    vs = ks + T::kStages * T::kKVBytes;
    full_k = reinterpret_cast<uint64_t*>(vs + T::kStages * T::kKVBytes);
    full_v = full_k + T::kStages;
    free_k = full_v + T::kStages;
    free_v = free_k + T::kStages;
    full_q = free_v + T::kStages;
    free_q = full_q + T::kQBufs;
  }
};

// A work item of the persistent grid: 128 query rows of one head, one
// key-range split. Items are ordered heaviest first (every head's last
// query tile, then the one before), and each block takes one item from
// every round of gridDim.x, the rounds walked forwards and backwards in
// turn (a snake), so that the blocks' sums of work come out even when the
// items shrink, as causal ones do (see item_of_block).
struct Item {
  int q0, bh, split, tb, te;  // key tiles [tb, te)
};

template <int KT>
__device__ __forceinline__ Item item_at(const BArgs& a, int w) {
  const int n_qt = (a.Sq + kRows - 1) / kRows;
  const int per_row = a.BH * a.splits;
  Item it;
  it.q0 = (n_qt - 1 - w / per_row) * kRows;
  it.bh = w % per_row % a.BH;
  it.split = w % per_row / a.BH;
  // the key tiles some row of the item may see, then its split's share
  const int hi =
      a.causal ? min(min(it.q0 + kRows, a.Sq), a.kv_len) : a.kv_len;
  const int lo = a.window > 0 ? max(0, it.q0 - a.window + 1) : 0;
  const int t_lo = lo / KT, t_hi = max(t_lo, (hi + KT - 1) / KT);
  const int per = (t_hi - t_lo + a.splits - 1) / a.splits;
  it.tb = min(t_hi, t_lo + it.split * per);
  it.te = min(t_hi, it.tb + per);
  return it;
}

__device__ __forceinline__ int n_items(const BArgs& a) {
  return (a.Sq + kRows - 1) / kRows * a.BH * a.splits;
}

// This block's k-th work item, or -1 past the last.
__device__ __forceinline__ int item_of_block(const BArgs& a, int k) {
  const int g = gridDim.x, b = blockIdx.x;
  const long long w = (long long)k * g + ((k & 1) ? g - 1 - b : b);
  return w < n_items(a) ? (int)w : -1;
}

// The producer: one thread loads each item's Q tile, then its K and V
// tiles into the ring, each slot once both warpgroups have released it.
// The ring's position g runs on across items.
template <int DP>
__device__ __forceinline__ void produce(const Smem<DP>& sm, const BArgs& a,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv) {
  using T = Tile<DP>;
  constexpr int KT = T::kKeys, ST = T::kStages, QB = T::kQBufs;
  int g = 0;
  for (int k = 0, w; (w = item_of_block(a, k)) >= 0; ++k) {
    const Item it = item_at<KT>(a, w);
    const int qb = k % QB;
    if (k >= QB) mbar_wait(sm.free_q + qb, ((k / QB) & 1) ^ 1);
    mbar_expect_tx(sm.full_q + qb, T::kQBytes);
#pragma unroll
    for (int p = 0; p < T::kPanels; ++p)
      tma_load(sm.qs + qb * T::kQBytes + p * kRows * 128, tq, sm.full_q + qb,
               p * kPanel, it.q0, it.bh);
    for (int j = it.tb; j < it.te; ++j, ++g) {
      const int s = g % ST, ph = (g / ST) & 1;
      if (g >= ST) mbar_wait(sm.free_k + s, ph ^ 1);
      mbar_expect_tx(sm.full_k + s, T::kKVBytes);
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(sm.ks + s * T::kKVBytes + p * KT * 128, tk, sm.full_k + s,
                 p * kPanel, j * KT, it.bh);
      if (g >= ST) mbar_wait(sm.free_v + s, ph ^ 1);
      mbar_expect_tx(sm.full_v + s, T::kKVBytes);
#pragma unroll
      for (int p = 0; p < T::kPanels; ++p)
        tma_load(sm.vs + s * T::kKVBytes + p * KT * 128, tv, sm.full_v + s,
                 p * kPanel, j * KT, it.bh);
    }
  }
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A consumer warpgroup (wg 0 or 1): 64 query rows of each item. The two
// warpgroups take turns to issue their products (named barriers), so one's
// softmax runs beside the other's tensor-core work: n + 1 turns an item
// each, warpgroup 0 first.
template <int DP>
__device__ __forceinline__ void consume(const Smem<DP>& sm, const BArgs& a,
                                        int wg) {
  using T = Tile<DP>;
  constexpr int KT = T::kKeys, ST = T::kStages, QB = T::kQBufs;
  const int t = threadIdx.x & 127, lane = t & 31;
  const int col = 2 * (lane & 3);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto begin_turn = [&]() { named_sync(1 + wg); };
  auto end_turn = [&]() { named_arrive(2 - wg); };
  if (wg == 1) named_arrive(1);

  int g = 0;  // the ring's position
  for (int k = 0, w; (w = item_of_block(a, k)) >= 0; ++k) {
    const Item it = item_at<KT>(a, w);
    const int n = it.te - it.tb;
    const int wq0 = it.q0 + wg * 64;
    const int row_a = wq0 + (t >> 5) * 16 + (lane >> 2);
    // [wb, we): the tiles of [tb, te) not wholly masked for these 64 rows
    int wb = it.tb, we = it.te;
    if (wq0 >= a.Sq) {
      we = wb;
    } else {
      if (a.causal) we = min(we, min(wq0 + 63, a.Sq - 1) / KT + 1);
      if (a.window > 0) wb = max(wb, max(0, wq0 - a.window + 1) / KT);
      we = max(we, wb);
    }
    // a tile needs the mask if it holds a key past some row's causal or
    // window range, or past kv_len
    auto masked = [&](int j) {
      const int k0 = j * KT;
      return k0 + KT > a.kv_len || (a.causal && k0 + KT - 1 > wq0) ||
             (a.window > 0 && wq0 + 63 - k0 >= a.window);
    };
    auto skip = [&](int i) {
      const int s = (g + i) % ST, ph = ((g + i) / ST) & 1;
      mbar_wait(sm.full_k + s, ph);
      mbar_wait(sm.full_v + s, ph);
      release(sm.free_k + s);
      release(sm.free_v + s);
      begin_turn();
      end_turn();
    };

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float s[KT / 2];
    uint32_t p[KT / 4];
    RowState st{kNegInf, kNegInf, 0.f, 0.f};
    float corr_a, corr_b;  // the last softmax's rescale factors
    const int qb = k % QB;
    const uint8_t* qw = sm.qs + qb * T::kQBytes + wg * 64 * 128;
    auto softmax = [&](int j) {
      if (masked(j))
        softmax_tile<KT, true>(s, st, corr_a, corr_b, a, j * KT, row_a, col);
      else
        softmax_tile<KT, false>(s, st, corr_a, corr_b, a, j * KT, row_a,
                                col);
    };

    mbar_wait(sm.full_q + qb, (k / QB) & 1);
    for (int i = 0; i < wb - it.tb; ++i) skip(i);
    if (we > wb) {
      const int i0 = wb - it.tb, i1 = we - it.tb;
      {  // the first tile: scores, softmax
        const int s0 = (g + i0) % ST, ph = ((g + i0) / ST) & 1;
        mbar_wait(sm.full_k + s0, ph);
        begin_turn();
        wg_fence();
        qk_product<DP, KT>(s, qw, sm.ks + s0 * T::kKVBytes);
        wg_commit();
        end_turn();
        wg_wait<0>();
        keep(s);
        release(sm.free_k + s0);
        softmax(wb);
        to_bf16_words<KT>(s, p);
      }
      // tile i's scores and tile i - 1's PV product in flight together
      // (one turn; the accumulator is rescaled for the PV product while the
      // scores run); tile i's softmax runs while the PV product does
      for (int i = i0 + 1; i < i1; ++i) {
        const int si = (g + i) % ST, ph = ((g + i) / ST) & 1;
        const int sp = (g + i - 1) % ST, php = ((g + i - 1) / ST) & 1;
        mbar_wait(sm.full_k + si, ph);
        mbar_wait(sm.full_v + sp, php);
        keep(s);
        begin_turn();
        wg_fence();
        qk_product<DP, KT>(s, qw, sm.ks + si * T::kKVBytes);
        wg_commit();
        rescale<DP>(o, corr_a, corr_b);
        keep(o);
        keep(p);
        wg_fence();
        pv_product<DP, KT>(o, p, sm.vs + sp * T::kKVBytes);
        wg_commit();
        end_turn();
        wg_wait<1>();
        keep(s);
        release(sm.free_k + si);
        softmax(it.tb + i);
        wg_wait<0>();
        keep(o);
        keep(p);
        release(sm.free_v + sp);
        to_bf16_words<KT>(s, p);
      }
      {  // the last tile's PV product
        const int sl = (g + i1 - 1) % ST, ph = ((g + i1 - 1) / ST) & 1;
        mbar_wait(sm.full_v + sl, ph);
        rescale<DP>(o, corr_a, corr_b);
        keep(o);
        keep(p);
        begin_turn();
        wg_fence();
        pv_product<DP, KT>(o, p, sm.vs + sl * T::kKVBytes);
        wg_commit();
        end_turn();
        wg_wait<0>();
        keep(o);
        keep(p);
        release(sm.free_v + sl);
      }
    } else {
      begin_turn();  // the turn the first tile would have taken
      end_turn();
    }
    for (int i = we - it.tb; i < n; ++i) skip(i);
    release(sm.free_q + qb);  // every product that read this Q is done
    g += n;

    // the quad's shares of l; then out = acc / max(l, 1e-30), or this
    // split's partial state
    float l_a = st.l_a, l_b = st.l_b;
#pragma unroll
    for (int w2 = 1; w2 <= 2; w2 <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, w2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, w2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      if (row >= a.Sq) continue;
      const size_t r = (size_t)it.bh * a.Sq + row;
      if (a.splits == 1) {
        const float inv = 1.f / fmaxf(h ? l_b : l_a, 1e-30f);
        __nv_bfloat16* og = a.out + r * a.D;
#pragma unroll
        for (int cc = 0; cc < DP / 8; ++cc) {
          const int c = 8 * cc + col;
          if (c < a.D)
            *reinterpret_cast<__nv_bfloat162*>(og + c) =
                __floats2bfloat162_rn(o[4 * cc + 2 * h] * inv,
                                      o[4 * cc + 2 * h + 1] * inv);
        }
      } else {
        float* wp =
            a.work + ((size_t)it.split * a.BH * a.Sq + r) * (a.D + 2);
#pragma unroll
        for (int cc = 0; cc < DP / 8; ++cc) {
          const int c = 8 * cc + col;
          if (c < a.D)
            *reinterpret_cast<float2*>(wp + c) =
                make_float2(o[4 * cc + 2 * h], o[4 * cc + 2 * h + 1]);
        }
        if ((lane & 3) == 0) {
          wp[a.D] = h ? st.m_b : st.m_a;
          wp[a.D + 1] = h ? l_b : l_a;
        }
      }
    }
  }
}

// Persistent: one block an SM walks the work items (see Item).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const BArgs a) {
  using T = Tile<DP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Smem<DP> sm(smem_raw);
  if (threadIdx.x == 256) {  // the producer: fetch the maps early
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(sm.full_k + s, 1);
      mbar_init(sm.full_v + s, 1);
      mbar_init(sm.free_k + s, 8);  // one arrival per consumer warp
      mbar_init(sm.free_v + s, 8);
    }
    for (int q = 0; q < T::kQBufs; ++q) {
      mbar_init(sm.full_q + q, 1);
      mbar_init(sm.free_q + q, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == 256) produce<DP>(sm, a, &tq, &tk, &tv);
  } else {
    consume<DP>(sm, a, wg);
  }
}

// Combines the key-range splits of every row in split order: one warp a
// row, out = sum_s 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30).
__global__ void __launch_bounds__(256) flash_merge_kernel(const BArgs a) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= a.Sq) return;
  const size_t r = (size_t)blockIdx.y * a.Sq + row;
  const size_t split = (size_t)a.BH * a.Sq * (a.D + 2);
  const float* w = a.work + r * (a.D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, w[s * split + a.D]);
  float l = 0.f;
  for (int s = 0; s < a.splits; ++s)
    l += ex2(w[s * split + a.D] - mx) * w[s * split + a.D + 1];
  const float den = fmaxf(l, 1e-30f);
  for (int c = lane; c < a.D; c += 32) {
    float acc = 0.f;
    for (int s = 0; s < a.splits; ++s)
      acc += ex2(w[s * split + a.D] - mx) * w[s * split + c];
    a.out[r * a.D + c] = __float2bfloat16(acc / den);
  }
}

// Build-order probes of the two products, one warpgroup: mode 0: out (64 x
// 64, f32) = x (64 x K) . y (64 x K)^T, both through TMA into swizzled
// shared memory, K / 16 wgmma m64n64k16 steps (qk_product's path); mode 1:
// out = x (64 x K) . y (K x 64): x read into the score accumulator layout,
// converted by to_bf16_words, y through the transposed
// descriptor (pv_product's path). K a multiple of 16, at most 64.
__global__ void __launch_bounds__(128) flash_probe_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap ty, const __nv_bfloat16* x,
    float* out, int mode, int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* xs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ys = xs + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ys + 64 * 128);
  const int t = threadIdx.x, lane = t & 31;
  const int row_a = (t >> 5) * 16 + (lane >> 2), col = 2 * (lane & 3);
  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, (mode == 0 ? 2 : 1) * 64 * 128);
    if (mode == 0) tma_load(xs, &tx, bar, 0, 0, 0);
    tma_load(ys, &ty, bar, 0, 0, 0);
  }
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  keep(d);
  mbar_wait(bar, 0);
  if (mode == 0) {
    wg_fence();
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_ss<64>(d, desc128(xs + kk * 32, 16, 1024),
                   desc128(ys + kk * 32, 16, 1024), 1);
    wg_commit();
    wg_wait<0>();
    keep(d);
  } else {
    float sx[32];
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + col + (i & 1);
      const int r = row_a + ((i & 2) ? 8 : 0);
      sx[i] = c < K ? __bfloat162float(x[r * K + c]) : 0.f;
    }
    to_bf16_words<64>(sx, p);
    wg_fence();
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_rs<64>(d, &p[4 * kk], desc128(ys + kk * 16 * 128, 64 * 128, 1024));
    wg_commit();
    wg_wait<0>();
    keep(d);
    keep(p);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i / 4) + col + (i & 1);
    const int r = row_a + ((i & 2) ? 8 : 0);
    out[r * 64 + c] = d[i];
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
int launch_f32(const Args& a, cudaStream_t s) {
  constexpr int KT = DP > 128 ? 16 : 32;
  static size_t opted_in = 48 * 1024;
  const size_t smem = (size_t)2 * KT * DP * 4;
  return launch_kernel(flash_f32_kernel<DP, KT>, opted_in, a, 256, smem, s);
}

int launch_f32_dp(const Args& a, cudaStream_t s) {
  const int d = a.D;
  if (d <= 16) return launch_f32<16>(a, s);
  if (d <= 32) return launch_f32<32>(a, s);
  if (d <= 64) return launch_f32<64>(a, s);
  if (d <= 128) return launch_f32<128>(a, s);
  return launch_f32<256>(a, s);
}

// The driver's cuTensorMapEncodeTiled, found through the runtime, so that
// nothing links libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3D map over a contiguous bf16 (depth, rows, cols) tensor, boxes of
// (64 columns, box_rows rows, 1), 128-byte swizzle, zeros out of range.
bool tensor_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                int depth, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_bf16(const BArgs& a, const void* q, const void* k, const void* v,
                cudaStream_t s) {
  using T = Tile<DP>;
  static_assert((size_t)T::kSmem <= kSmemMax, "tile above shared memory");
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, a.D, a.Sq, a.BH, kRows) ||
      !tensor_map(&tk, k, a.D, a.Sk, a.BH, T::kKeys) ||
      !tensor_map(&tv, v, a.D, a.Sk, a.BH, T::kKeys))
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long items = (long long)((a.Sq + kRows - 1) / kRows) * a.BH *
                          a.splits;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  flash_wgmma_kernel<DP><<<grid, kThreads, T::kSmem, s>>>(tq, tk, tv, a);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && a.splits > 1) {
    flash_merge_kernel<<<dim3((a.Sq + 7) / 8, a.BH), 256, 0, s>>>(a);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. q and out are device pointers
// to contiguous (BH, Sq, D) tensors of `dtype` (0 f32, 1 bf16), k and v to
// contiguous (BH, Sk, D) ones; Sk != Sq only when causal == 0 and
// window <= 0. The first kv_len (<= Sk) keys of a row carry weight.
// window <= 0 means none. bf16 only: D a multiple of 8 and 16-byte-aligned
// rows; `splits` key-range splits with a (splits, BH, Sq, D + 2) f32
// workspace `work` when splits > 1. Asynchronous on `stream`.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, void* work, int BH,
                               int Sq, int Sk, int kv_len, int D, int causal,
                               int window, float scale, int splits,
                               void* stream) {
  if (BH == 0 || Sq == 0) return 0;
  if (BH < 0 || Sq < 0 || Sk < 1 || kv_len < 0 || kv_len > Sk || D <= 0 ||
      D > 256 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (Sk != Sq && (causal || window > 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
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
    a.vec = (D * 4) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(v) % 16 == 0;
    return launch_f32_dp(a, s);
  }
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  const uintptr_t misaligned = reinterpret_cast<uintptr_t>(q) |
                               reinterpret_cast<uintptr_t>(k) |
                               reinterpret_cast<uintptr_t>(v) |
                               reinterpret_cast<uintptr_t>(out);
  if (D % 8 != 0 || misaligned % 16 != 0 || splits < 1 || splits > 64 ||
      (splits > 1) != (work != nullptr))
    return (int)cudaErrorInvalidValue;
  BArgs a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.work = static_cast<float*>(work);
  a.BH = BH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.kv_len = kv_len;
  a.D = D;
  a.causal = causal;
  a.window = window;
  a.splits = splits;
  a.scale_log2 = scale * 1.4426950408889634f;
  if (D <= 64) return launch_bf16<64>(a, q, k, v, s);
  if (D <= 128) return launch_bf16<128>(a, q, k, v, s);
  return launch_bf16<256>(a, q, k, v, s);
}

// The bf16 tile shape at tile width dp (64, 128 or 256): out = {query rows,
// keys, stages, shared-memory bytes} of a block. Returns 0, or
// cudaErrorInvalidValue for another dp.
extern "C" int flash_bf16_tile(int dp, int* out) {
  switch (dp) {
    case 64:
      out[0] = kRows, out[1] = Tile<64>::kKeys, out[2] = Tile<64>::kStages,
      out[3] = Tile<64>::kSmem;
      return 0;
    case 128:
      out[0] = kRows, out[1] = Tile<128>::kKeys, out[2] = Tile<128>::kStages,
      out[3] = Tile<128>::kSmem;
      return 0;
    case 256:
      out[0] = kRows, out[1] = Tile<256>::kKeys, out[2] = Tile<256>::kStages,
      out[3] = Tile<256>::kSmem;
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// The probes of flash_probe_kernel (mode 0: x (64, K) . y (64, K)^T; mode
// 1: x (64, K) . y (K, 64)), bf16 inputs, f32 out (64, 64), K a multiple
// of 16 up to 64. Returns 0 or the cudaError_t of the launch.
extern "C" int flash_wgmma_probe(int mode, const void* x, const void* y,
                                 float* out, int K, void* stream) {
  if ((mode != 0 && mode != 1) || K < 16 || K > 64 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, ty;
  if (!tensor_map(&tx, x, K, 64, 1, 64) ||
      !(mode == 0 ? tensor_map(&ty, y, K, 64, 1, 64)
                  : tensor_map(&ty, y, 64, K, 1, 64)))
    return (int)cudaErrorInvalidValue;
  const int smem = 1024 + 2 * 64 * 128 + 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_probe_kernel<<<1, 128, smem, s>>>(
      tx, ty, static_cast<const __nv_bfloat16*>(x), out, mode, K);
  return (int)cudaGetLastError();
}
