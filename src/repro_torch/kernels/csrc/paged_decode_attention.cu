// Paged one-token decode attention for Hopper (sm_90a), bf16 route, plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:330
// paged_decode_attention (_paged_decode_kernel) for bf16 queries over bf16 or
// int8 pages, D a multiple of 8 up to 256 and at most 16 query heads a KV
// head; f32 queries or pages, and other shapes, keep paged_attention.cu's
// bodies. For each row b of a (B, M) page table, the query of row b sits at
// position pos[b] - 1 and out[b, h] = softmax(q . k^T / sqrt(D)) v over the
// M * P slots of the row's pages in an (N, P, KV, D) pool; query head h reads
// KV head h / (H / KV). Slot s is valid iff s < pos[b] and, with a window,
// s >= pos[b] - window; invalid slots score the finite -1e30, so a row with
// no valid key gets the uniform mean of every slot of its table row. int8
// pages carry bf16 (N, P, KV) scales and dequantize as the reference's gather
// does: int8 x scale in fp32, rounded to bf16. Table entries are clamped to
// [0, N - 1].
//
// Bound on an H100: memory. Each valid key and value is read once and meets
// only the H / KV query heads of its group, 4 * D flops a head per 4 * D bytes
// (bf16), far below the ~295 flop/byte ridge: the least time is (valid K/V
// bytes + q + out) / 3.35 TB/s. At the serves' shapes (chip_smoke.py's
// cases): Mixtral (B 4, 48/8 heads, D 128, window 4096, contexts 1000-4608)
// 0.0163 ms; qwen2-0.5B (B 8, 14/2, D 64, contexts 256-2048) 0.0014 ms;
// Qwen2-VL-7B (B 4, 28/4, D 128, contexts 132-632) 0.0010 ms. Both small
// ones are below a launch's own latency.
//
// Design (one launch, no workspace; kernels/decode_attention.py's
// paged_decode_plan sizes the splits, paged_split_slots mirrors them):
//   * a block owns one (row b, KV head, split of the row's valid keys); its
//     query rows are the g = H / KV heads that share the KV head (the TPU
//     kernel's GQA fold), so each gathered key is read once a block. The
//     splits of one (b, KV head) are the blocks of one thread-block cluster
//     (at most 8), launched with cudaLaunchKernelEx; after a cluster barrier
//     every rank reads all ranks' (m, l, acc) through distributed shared
//     memory, merges them in rank order for its share of the row's outputs
//     and writes them normalized. One fixed order of every sum: a call is
//     bit-reproducible;
//   * a row streams only its valid slots: [max(0, pos - window), min(pos,
//     M * P)) (paged_attention.cu's block_range / key_ok rules, which make
//     every slot of that range valid), cut into 64-key stages, ceil(stages /
//     splits) consecutive stages a rank; a rank with none joins the merge
//     with l = 0. Pages wholly behind the window are never read. A row with
//     no valid key streams every slot of its table row at -1e30;
//   * K and V gather into a ring of 3 (bf16, D > 64) or 4 stages in shared
//     memory by cp.async copies (16 bytes; 8 for int8 rows of D % 16 != 0)
//     addressed through the stage's page ids; four threads share a key row,
//     so a thread computes the row's pool address once and each copy
//     instruction of a warp reads 64 contiguous bytes of each of its rows.
//     The page ids come from the table by 4-byte cp.async copies into a
//     ring of 2 x stages slots, issued ST - 1 or more steps before the stage
//     that needs them, so no load of an id (or, for int8, of a scale) is
//     ever waited on in the loop and shared memory does not grow with M.
//     Stages j + 1 .. j + 2 (or j + 3) are in flight while stage j is used,
//     one __syncthreads a stage. bf16 key rows are padded by 16 bytes, so
//     ldmatrix is free of bank conflicts; slots past the range are
//     zero-filled (src-size 0);
//   * int8 pages: cp.async brings the int8 bytes, and for each of the
//     stage's K and V scales the aligned 4 bytes that hold it. Each warp
//     dequantizes its own 16 keys' K and V rows into a bf16 tile of its own
//     (int8 x scale in fp32, rounded to bf16: the int8 widens through the
//     mantissa of 2^23, not the quarter-rate conversion), so only a
//     __syncwarp guards it; the plan gives int8 twice the blocks, since
//     this pass, not the bytes, holds it;
//   * the g <= 16 query heads are the rows of mma.sync m16n8k16 (rows past g
//     are zero), bf16 in, fp32 accumulation; each of the 4 warps takes 16
//     keys of a stage: S = Q K^T (K fragments by ldmatrix), scale, mask and
//     the online softmax in the accumulator registers in the exp2 domain
//     (a row's max and sum are quad shuffles; the max moves, and the sums
//     are rescaled, only when a stage raises it by more than 2^8), then the
//     probabilities as the bf16 A operand of O += P V (V fragments by
//     ldmatrix.trans). Q, O and (m, l) stay in registers; the scores never
//     go to shared memory. Each warp's state goes to shared memory in the
//     ring's place, and every rank merges the row's 4 x splits warp states
//     in rank then warp order, reading the other ranks' through
//     distributed shared memory;
//   * D up to 256, a multiple of 8: the tiles are DP = 16, 32, 64, 128 or 256
//     columns wide, zeros past D.
// What it does about the five faults of paged_attention.cu's wmma body for
// this call: (1) one launch, no f32 workspace and no combine kernel; (2) each
// split streams only its own row's stages, so a short row's extra ranks read
// nothing; (3) cp.async keeps two or three stages in flight behind the one
// in use; (4) one __syncthreads a stage, the softmax in registers; (5) the
// page ids come ahead through a ring of 2 x kStages x 65 ids, not the whole
// table row.
//
// Planted faults for the checks: drop_stage has each rank skip its last
// stage; merge_short has the merge leave out the last rank that holds keys
// (a no-op where a row's keys lie in one rank).
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at a 700.00 W power limit
// (device ms from torch.profiler over 20 L2-flushed launches; in brackets
// the wmma body of paged_attention.cu, which took these calls before, on
// the same card): Mixtral bf16 0.0406 (0.0863), int8 0.0402 (0.0820);
// qwen2-0.5B bf16 0.0099 (0.0219), int8 0.0122 (0.0217); Qwen2-VL-7B bf16
// 0.0099 (0.0218); one 131,072-token row bf16 0.3133 (0.9495), int8 0.5961
// (0.9403); rows of 16 tokens 0.0055 (0.0100). PERF.md section 6 has the
// rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeys = 64;  // keys of a ring stage: 16 for each warp
// page ids of a stage: its 64 keys lie on at most 63 / P + 2 <= 65 pages
constexpr int kPids = kKeys + 1;
constexpr int kPidLd = 68;  // ints a stage's ids take, 16-byte aligned
// int8: a stage's 128 scale words (4 bytes) and their halves (a byte each)
constexpr int kScaleBytes = 2 * kKeys * 5;
constexpr int kClusterMax = 8;  // splits of a row: blocks of one cluster
constexpr int kThreads = 128;
constexpr int kRows = 16;  // query heads of a block: mma's 16 rows
constexpr size_t kSmemMax = 232448;  // an H100 block's opt-in maximum
// a row's running max is moved (and its sums rescaled) only when a stage
// raises it by more than this (log2 units): exp2(s - m) stays <= 256
constexpr float kRescaleAbove = 8.f;

enum DType { kBF16 = 1, kI8 = 2 };

struct Args {
  const __nv_bfloat16* q;       // (B, H, D)
  const unsigned char* k_pages;  // (N, P, KV, D) bf16 or int8
  const unsigned char* v_pages;
  const __nv_bfloat16* k_scale;  // (N, P, KV) for int8 pages
  const __nv_bfloat16* v_scale;
  const int* table;  // (B, M)
  const int* pos;    // (B,) valid token count
  __nv_bfloat16* out;  // (B, H, D)
  int B, H, KV, D, N, P, M;
  int p_shift;       // log2(P) when P is a power of two, else -1
  int window;        // <= 0: no window
  float scale_log2;  // D^-0.5 * log2(e): scores in the exp2 domain
  int splits;        // blocks of a cluster sharing one row's keys
  int drop_stage;    // planted fault: each rank skips its last stage
  int merge_short;   // planted fault: the merge leaves out the last rank
};

// Shared memory of a block at tile width DP, in bytes: the ring, the
// warps' dequantized tiles (int8), the page-id ring; after the key walk,
// in their place, the merge's partial states.
template <int DP, bool QUANT>
struct Cfg {
  static constexpr int kLd = DP + 8;  // bf16 a key row (16 bytes of pad)
  static constexpr int kTile = kKeys * kLd;  // elements of a bf16 K or V tile
  // a stage: bf16 K then V tiles; int8 K then V rows (DP bytes apart), then
  // for each of its 128 K and V scales the aligned 4 bytes that hold it and
  // which half it is (kScaleBytes)
  static constexpr int kStage =
      QUANT ? 2 * kKeys * DP + kScaleBytes : 2 * kTile * 2;
  static constexpr int kStages = QUANT || DP <= 64 ? 4 : 3;
  static constexpr int kRing = kStages * kStage;
  // slots of the page-id ring: the ids of stage j are copied when stage
  // j - kIdSlots is used, kIdSlots - ST + 1 >= ST - 1 steps before stage j
  // is issued, so their copy has landed by then
  static constexpr int kIdSlots = 2 * kStages;
  // int8: each warp's 16 K rows then 16 V rows in bf16
  static constexpr int kWarpTile = 2 * 16 * kLd;
  static constexpr int kDequant = QUANT ? 4 * kWarpTile * 2 : 0;
  static constexpr int kPidOff = kRing + kDequant;
  static constexpr int kWalk = kPidOff + kIdSlots * kPidLd * 4;
  // floats: the 4 warps' acc (4 x 16 rows of kAccLd: 8 floats of pad keep
  // the stores of a warp's 8 row groups off each other's banks), m and l
  // (4 x 16 each)
  static constexpr int kAccLd = DP + 8;
  static constexpr int kWarpAcc = 0;
  static constexpr int kWarpM = kWarpAcc + 4 * kRows * kAccLd;
  static constexpr int kWarpL = kWarpM + 4 * kRows;
  static constexpr int kMerge = (kWarpL + 4 * kRows) * 4;
  static constexpr int kSmem = kWalk > kMerge ? kWalk : kMerge;
  static_assert(kStage % 16 == 0 && kRing % 16 == 0, "16-byte alignment");
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

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// The cluster barrier without a release: for a block's last arrival,
// once every read of the others' shared memory has been used.
__device__ __forceinline__ void cluster_arrive_wait() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
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

// The slots a row streams, [lo, hi): its valid keys, or every slot of its
// table row at -1e30 (masked) when it has none. paged_attention.cu's
// block_range for one query at pos - 1, whose range holds only valid keys.
struct RowRange {
  int lo, hi;
  bool masked;
};

__device__ __forceinline__ RowRange row_range(const Args& a, int pos) {
  const int S = a.M * a.P, qp = pos - 1;
  RowRange r;
  r.masked = qp < 0 || (a.window > 0 && qp - a.window + 1 > S - 1);
  r.lo = 0;
  r.hi = S;
  if (!r.masked) {
    r.hi = min(qp + 1, S);
    if (a.window > 0) r.lo = max(0, qp - a.window + 1);
  }
  return r;
}

__device__ __forceinline__ int page_of(const Args& a, int slot) {
  return a.p_shift >= 0 ? slot >> a.p_shift : slot / a.P;
}

// Copy the page ids of the stage whose keys start at slot k0 (entries
// page_of(k0) ... of table row b, as far as the stage's last key) into
// `ids`, one 4-byte copy a thread; the entries are clamped where used.
__device__ __forceinline__ void issue_ids(const Args& a, int b, int k0,
                                          int k_end, int* ids) {
  const int i = threadIdx.x;
  if (i >= kPids) return;
  const int pg = page_of(a, k0) + i;
  const bool ok = pg <= page_of(a, min(k0 + kKeys, k_end) - 1);
  cp_async4(ids + i, a.table + (size_t)b * a.M + (ok ? pg : 0), ok ? 4 : 0);
}

// Pool row (page row, KV head) of a slot of the stage whose keys start at
// k0 and whose page ids are pids.
__device__ __forceinline__ size_t pool_row(const Args& a, const int* pids,
                                           int k0, int slot, int kvh) {
  const int pg = page_of(a, slot);
  const int id = min(max(pids[pg - page_of(a, k0)], 0), a.N - 1);
  return ((size_t)id * a.P + (slot - pg * a.P)) * a.KV + kvh;
}

template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (CB == 16) {
    cp_async16(dst, src, ok ? 16 : 0);
  } else {
    cp_async8(dst, src, ok ? 8 : 0);
  }
}

// Gather the K and V rows of keys [k0, k0 + kKeys) into a ring stage in
// CB-byte copies (rows of kChunks chunks, kDst bytes apart, V kVOff bytes
// after K); slots at or past k_end are zero-filled, chunks past the row's
// row_bytes left alone. kTpr threads share a row, thread q taking chunks
// q, q + kTpr, ..., so each copy instruction of a warp reads kTpr * CB
// contiguous bytes of each of its rows, and a thread computes a row's pool
// address once.
template <int CB, int kChunks, int kDst, int kVOff>
__device__ __forceinline__ void gather_rows(const Args& a, const int* pids,
                                            int k0, int k_end, int kvh,
                                            int row_bytes,
                                            unsigned char* stage) {
  constexpr int kTpr = kChunks < 4 ? kChunks : 4;  // threads a row
  constexpr int kRowsPass = kThreads / kTpr;
  const int q = threadIdx.x % kTpr;
#pragma unroll
  for (int key = threadIdx.x / kTpr; key < kKeys; key += kRowsPass) {
    const int slot = k0 + key;
    const bool ok = slot < k_end;
    const size_t src = ok ? pool_row(a, pids, k0, slot, kvh) * row_bytes : 0;
    const unsigned char* kp = a.k_pages + src;
    const unsigned char* vp = a.v_pages + src;
    unsigned char* kd = stage + key * kDst;
#pragma unroll
    for (int j = 0; j < kChunks / kTpr; ++j) {
      const int c = (q + j * kTpr) * CB;
      if (c >= row_bytes) continue;
      cp_async<CB>(kd + c, kp + c, ok);
      cp_async<CB>(kd + kVOff + c, vp + c, ok);
    }
  }
}

// Issue the gather of keys [k0, k0 + kKeys) into a ring stage, K then V:
// bf16 rows land padded (kLd), int8 rows DP bytes apart, in 16-byte copies
// (8 for int8 rows of D % 16 != 0).
template <int DP, bool QUANT>
__device__ __forceinline__ void issue_stage(const Args& a, const int* pids,
                                            int k0, int k_end, int kvh,
                                            unsigned char* stage) {
  using C = Cfg<DP, QUANT>;
  if constexpr (!QUANT) {
    gather_rows<16, DP / 8, C::kLd * 2, C::kTile * 2>(a, pids, k0, k_end,
                                                       kvh, 2 * a.D, stage);
  } else if (a.D % 16 == 0) {
    gather_rows<16, DP / 16, DP, kKeys * DP>(a, pids, k0, k_end, kvh, a.D,
                                             stage);
  } else {
    gather_rows<8, DP / 8, DP, kKeys * DP>(a, pids, k0, k_end, kvh, a.D,
                                           stage);
  }
}

// int8: copy the scale of thread tid (keys 0-63: K, 64-127: V) of the
// stage whose keys start at k0: the 4-byte-aligned word that holds it,
// and (a plain store) which half; zeros past k_end, where the zero-filled
// bytes make zeros anyway.
template <int DP>
__device__ __forceinline__ void issue_scale(const Args& a, const int* pids,
                                            int k0, int k_end, int kvh,
                                            unsigned char* stage) {
  const int tid = threadIdx.x;
  const int slot = k0 + (tid & (kKeys - 1));
  const bool ok = slot < k_end;
  const size_t row = ok ? pool_row(a, pids, k0, slot, kvh) : 0;
  const __nv_bfloat16* s = tid < kKeys ? a.k_scale : a.v_scale;
  unsigned char* words = stage + 2 * kKeys * DP;
  cp_async4(words + 4 * tid, s + (row & ~size_t(1)), ok ? 4 : 0);
  words[8 * kKeys + tid] = static_cast<unsigned char>(row & 1);
}

// Four int8 (a little-endian word) to their exact fp32 values without the
// quarter-rate integer conversion: byte ^ 0x80 = x + 128 goes into the
// mantissa of 2^23 (one byte permute), and 2^23 + 128 comes off.
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | j)) -
           8388736.f;
}

// int8: warp w's 16 keys of a stage (K rows, then V rows) times their
// scales, rounded to bf16, into the warp's tile (row stride kLd).
template <int DP>
__device__ __forceinline__ void dequant_warp(const unsigned char* stage,
                                             int D, int warp, int lane,
                                             __nv_bfloat16* tile) {
  constexpr int kLd = Cfg<DP, true>::kLd;
  constexpr int kChunks = DP / 8;  // 8 int8 values a chunk
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(stage + 2 * kKeys * DP);
  const unsigned char* half = stage + 2 * kKeys * DP + 8 * kKeys;
#pragma unroll 4
  for (int i = lane; i < 32 * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;  // r: K 0-15, V 16-31
    if (c * 8 >= D) continue;
    const int row = (r >> 4) * kKeys + warp * 16 + (r & 15);
    const uint2 raw =
        *reinterpret_cast<const uint2*>(stage + row * DP + c * 8);
    const float s =
        __uint_as_float(half[row] ? words[row] & 0xffff0000u
                                  : words[row] << 16);
    float f[8];
    int8x4_to_f32(raw.x, f);
    int8x4_to_f32(raw.y, f + 4);
    uint4 h;
    h.x = pack_bf16(f[0] * s, f[1] * s);
    h.y = pack_bf16(f[2] * s, f[3] * s);
    h.z = pack_bf16(f[4] * s, f[5] * s);
    h.w = pack_bf16(f[6] * s, f[7] * s);
    *reinterpret_cast<uint4*>(tile + r * kLd + c * 8) = h;
  }
}

template <int DP, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Args a) {
  using C = Cfg<DP, QUANT>;
  constexpr int ST = C::kStages, LD = C::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  int* pids = reinterpret_cast<int*>(smem + C::kPidOff);
  const unsigned rank = cluster_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int groups = a.H / a.KV, D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row

  // Q as the A fragments of its DP / 16 column steps (rows past g zero);
  // its loads overlap the range's
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

  // this rank's stages of the row: [sb, sb + nt), keys [k_first, j_end)
  const RowRange rr = row_range(a, a.pos[b]);
  const int n_st = (rr.hi - rr.lo + kKeys - 1) / kKeys;
  const int per = (n_st + a.splits - 1) / a.splits;
  const int sb = min(n_st, (int)rank * per);
  int nt = min(n_st, sb + per) - sb;
  if (a.drop_stage) nt = max(0, nt - 1);
  const int k_first = rr.lo + sb * kKeys;
  const int j_end = min(k_first + nt * kKeys, rr.hi);

  // columns D .. DP of every bf16 tile stay zero (nothing copies there)
  if (D < DP) {
    __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(
        smem + (QUANT ? C::kRing : 0));
    const int rows = QUANT ? 4 * 32 : ST * 2 * kKeys;
    for (int i = tid; i < rows * (DP - D); i += kThreads) {
      const int row = i / (DP - D), c = D + i % (DP - D);
      tiles[row * LD + c] = __float2bfloat16(0.f);
    }
  }

  // the page ids of the first IDS stages (stage s's in slot s), then the
  // first ST - 1 stages, a copy group each
  constexpr int IDS = C::kIdSlots;
#pragma unroll
  for (int s = 0; s < IDS; ++s)
    if (s < nt) issue_ids(a, b, k_first + s * kKeys, j_end, pids + s * kPidLd);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nt) {
      const int k0 = k_first + s * kKeys;
      unsigned char* st = smem + s * C::kStage;
      const int* ids = pids + s * kPidLd;
      issue_stage<DP, QUANT>(a, ids, k0, j_end, kvh, st);
      if (QUANT) issue_scale<DP>(a, ids, k0, j_end, kvh, st);
    }
    cp_async_commit();
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // rows gq (a) and gq + 8 (b): running max (log2 units) and this lane's
  // share of the running sum
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  __nv_bfloat16* dq = reinterpret_cast<__nv_bfloat16*>(smem + C::kRing) +
                      warp * C::kWarpTile;

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<ST - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();          // everyone's; stage i - 1 is free
    const int in = i + ST - 1;
    if (in < nt) {
      const int kn = k_first + in * kKeys;
      const int* ids = pids + (in % IDS) * kPidLd;
      unsigned char* st = smem + (in % ST) * C::kStage;
      issue_stage<DP, QUANT>(a, ids, kn, j_end, kvh, st);
      if (QUANT) issue_scale<DP>(a, ids, kn, j_end, kvh, st);
    }
    // the page ids of stage i + IDS go where stage i's were (read when
    // stage i was issued), in this step's copy group: landed by the time
    // stage i + IDS is issued
    if (i + IDS < nt)
      issue_ids(a, b, k_first + (i + IDS) * kKeys, j_end,
                pids + (i % IDS) * kPidLd);
    cp_async_commit();

    const int j0 = k_first + i * kKeys + warp * 16;  // this warp's keys
    if (j0 < j_end) {
      unsigned char* st = smem + (i % ST) * C::kStage;
      const __nv_bfloat16* ks;
      const __nv_bfloat16* vs;
      if constexpr (QUANT) {
        dequant_warp<DP>(st, D, warp, lane, dq);
        __syncwarp();
        ks = dq;
        vs = dq + 16 * LD;
      } else {
        ks = reinterpret_cast<const __nv_bfloat16*>(st) + warp * 16 * LD;
        vs = ks + C::kTile;
      }

      // S (16 rows x 16 keys) = Q K^T, the even and odd column steps in
      // two sums (half the chain of dependent products)
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float so[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + ((mi >> 1) * 8 + r8) * LD + kk * 16 + (mi & 1) * 8);
        float (&sk)[2][4] = kk & 1 ? so : s;
        mma_bf16(sk[0], qa[kk], kb);
        mma_bf16(sk[1], qa[kk], kb + 2);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] += so[c][e];
      // scale and mask: keys past the range weigh nothing; a row with no
      // valid key scores -1e30 everywhere (the uniform mean)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + c * 8 + 2 * tq + (e & 1);
          const float x = rr.masked ? kNegInf : s[c][e] * a.scale_log2;
          s[c][e] = j < j_end ? x : -INFINITY;
        }
      const float mx_a =
          quad_max(fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
      const float mx_b =
          quad_max(fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
      // the running max moves, and the sums and accumulator are rescaled,
      // only when a stage raises it by more than kRescaleAbove for some
      // row of the warp: most stages skip the rescale
      if (__any_sync(0xffffffffu, mx_a > m_a + kRescaleAbove ||
                                      mx_b > m_b + kRescaleAbove)) {
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float c_a = ex2(m_a - mn_a), c_b = ex2(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        l_a *= c_a;
        l_b *= c_b;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[n][0] *= c_a;
          acc[n][1] *= c_a;
          acc[n][2] *= c_b;
          acc[n][3] *= c_b;
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[c][0] = ex2(s[c][0] - m_a);
        s[c][1] = ex2(s[c][1] - m_a);
        s[c][2] = ex2(s[c][2] - m_b);
        s[c][3] = ex2(s[c][3] - m_b);
      }
      l_a += (s[0][0] + s[0][1]) + (s[1][0] + s[1][1]);
      l_b += (s[0][2] + s[0][3]) + (s[1][2] + s[1][3]);
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
  }
  cp_async_wait<0>();
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  __syncthreads();  // the ring is free: the merge's states take its place

  float* f = reinterpret_cast<float*>(smem);
  float* wacc = f + C::kWarpAcc + warp * kRows * C::kAccLd;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<float2*>(wacc + gq * C::kAccLd + c) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(wacc + (gq + 8) * C::kAccLd + c) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (tq == 0) {
    f[C::kWarpM + warp * kRows + gq] = m_a;
    f[C::kWarpM + warp * kRows + gq + 8] = m_b;
    f[C::kWarpL + warp * kRows + gq] = l_a;
    f[C::kWarpL + warp * kRows + gq + 8] = l_b;
  }
  // every rank merges the 4 S partial states of the row (its own and the
  // other ranks' warps, in rank then warp order; a warp that saw no key has
  // l = 0 and weighs nothing) for its share of the (row, column pair)
  // outputs: a thread issues all its reads of the blocks' shared memory
  // (each warp's m, l and acc pair) before it uses one, so their latencies
  // overlap in one round. merge_short leaves out the last rank holding
  // keys, where a row's keys lie in two or more ranks. With one split the
  // block's own warps hold the row: no cluster barrier, plain loads.
  const int S = a.splits;
  if (S > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  const int live = (n_st + per - 1) / per;  // ranks holding keys
  const int skip = a.merge_short && live >= 2 ? live - 1 : -1;
  const int pairs = groups * D / 2;
  const int p_lo = (int)((long long)pairs * rank / S);
  const int p_hi = (int)((long long)pairs * (rank + 1) / S);
  __nv_bfloat16* orow = a.out + ((size_t)b * a.H + kvh * groups) * D;
  for (int i = p_lo + tid; i < p_hi; i += kThreads) {
    const int r = 2 * i / D, c = 2 * i % D;
    float m_s[kClusterMax][4], l_s[kClusterMax][4];
    float2 v[kClusterMax][4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* ms = f + C::kWarpM + w * kRows + r;
      const float* ls = f + C::kWarpL + w * kRows + r;
      const float* vs = f + C::kWarpAcc + (w * kRows + r) * C::kAccLd + c;
      if (S == 1) {
        m_s[0][w] = *ms;
        l_s[0][w] = *ls;
        v[0][w] = *reinterpret_cast<const float2*>(vs);
      } else {
#pragma unroll
        for (int s = 0; s < kClusterMax; ++s)
          if (s < S) {
            m_s[s][w] = peer_ld(peer_addr(ms, s));
            l_s[s][w] = peer_ld(peer_addr(ls, s));
            v[s][w] = peer_ld2(peer_addr(vs, s));
          }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (s < S && s != skip) mx = fmaxf(mx, m_s[s][w]);
    float x0 = 0.f, x1 = 0.f, l = 0.f;
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (s < S) {
          const float wt = l_s[s][w] > 0.f && s != skip
                               ? ex2(m_s[s][w] - mx)
                               : 0.f;
          x0 += wt * v[s][w].x;
          x1 += wt * v[s][w].y;
          l += wt * l_s[s][w];
        }
    l = fmaxf(l, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(orow + r * D + c) =
        __floats2bfloat162_rn(x0 / l, x1 / l);
  }
  // no block leaves while another still reads its states (every read has
  // been used by then, so the arrival needs no release)
  if (S > 1) cluster_arrive_wait();
}

template <int DP, bool QUANT>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<DP, QUANT>;
  static bool opted_in = false;  // per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<DP, QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, paged_decode_kernel<DP, QUANT>, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

template <bool QUANT>
int launch_dp(const Args& a, cudaStream_t s) {
  if (a.D <= 16) return launch<16, QUANT>(a, s);
  if (a.D <= 32) return launch<32, QUANT>(a, s);
  if (a.D <= 64) return launch<64, QUANT>(a, s);
  if (a.D <= 128) return launch<128, QUANT>(a, s);
  return launch<256, QUANT>(a, s);
}

template <bool QUANT>
int ring_of(int dp, int* out) {
  switch (dp) {
    case 16: out[0] = Cfg<16, QUANT>::kStages; out[1] = Cfg<16, QUANT>::kSmem;
      return 0;
    case 32: out[0] = Cfg<32, QUANT>::kStages; out[1] = Cfg<32, QUANT>::kSmem;
      return 0;
    case 64: out[0] = Cfg<64, QUANT>::kStages; out[1] = Cfg<64, QUANT>::kSmem;
      return 0;
    case 128:
      out[0] = Cfg<128, QUANT>::kStages; out[1] = Cfg<128, QUANT>::kSmem;
      return 0;
    case 256:
      out[0] = Cfg<256, QUANT>::kStages; out[1] = Cfg<256, QUANT>::kSmem;
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. Pointers are device pointers
// to contiguous tensors, 16-byte aligned: q and out (B, H, D) bf16; pages
// (N, P, KV, D) of page_dtype (1 bf16, 2 int8); scales (N, P, KV) bf16 for
// int8 pages (else null); table (B, M) and pos (B,) int32 (the query of row
// b sits at pos[b] - 1). `splits` (1 to 8) blocks of one cluster a row; H /
// KV <= 16, D a multiple of 8 up to 256. drop_stage and merge_short plant
// the faults named in the note above. Asynchronous on `stream`.
extern "C" int paged_decode_attention(int page_dtype, const void* q,
                                      const void* k_pages,
                                      const void* v_pages,
                                      const void* k_scale,
                                      const void* v_scale, const void* table,
                                      const void* pos, void* out, int B,
                                      int H, int KV, int D, int N, int P,
                                      int M, int window, float scale,
                                      int splits, int drop_stage,
                                      int merge_short, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || KV <= 0 || H % KV != 0 || H / KV > kRows || D <= 0 ||
      D % 8 != 0 || D > 256 || P <= 0 || M <= 0 || N <= 0 || splits < 1 ||
      splits > kClusterMax || B > 65535 || KV > 65535 ||
      (long long)M * P > (1LL << 30))
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
  a.k_pages = static_cast<const unsigned char*>(k_pages);
  a.v_pages = static_cast<const unsigned char*>(v_pages);
  a.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B; a.H = H; a.KV = KV; a.D = D; a.N = N; a.P = P; a.M = M;
  a.p_shift = (P & (P - 1)) == 0 ? __builtin_ctz((unsigned)P) : -1;
  a.window = window;
  a.scale_log2 = scale * kLog2e;
  a.splits = splits;
  a.drop_stage = drop_stage;
  a.merge_short = merge_short;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quant ? launch_dp<true>(a, s) : launch_dp<false>(a, s);
}

// The built body at tile width dp (16, 32, 64, 128 or 256) and page dtype
// (1 bf16, 2 int8): out = {keys a stage, stages, most splits a row,
// shared-memory bytes a block} (decode_attention.py's paged_decode_plan
// computes the same). Returns 0, or cudaErrorInvalidValue otherwise.
extern "C" int paged_decode_ring(int page_dtype, int dp, int* out) {
  int ring[2];
  int rc = (int)cudaErrorInvalidValue;
  if (page_dtype == kBF16) rc = ring_of<false>(dp, ring);
  if (page_dtype == kI8) rc = ring_of<true>(dp, ring);
  if (rc != 0) return rc;
  out[0] = kKeys;
  out[1] = ring[0];
  out[2] = kClusterMax;
  out[3] = ring[1];
  return 0;
}
