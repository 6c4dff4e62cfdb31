// m-grouped MoE GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/moe_gemm.py:
//   grouped_matmul (bodies _grouped_kernel and _grouped_kernel_scaled)
// out[r, :] = x[r, :] @ w[g] (* w_scale[g]) for every row r of an m-tile
// whose expert id is g = group_ids[r / block_m]; a tile with id -1 writes
// zeros. x (M, D) holds the token rows sorted by expert and padded so that
// each m-tile belongs to one expert; w is (E, D, F); out is (M, F) in x's
// dtype. block_m = M / len(group_ids) may be anything the plan gives, and
// the ids may come in any order (ids past E clamp to E - 1, as a gather).
//
// Bound on an H100, by regime (Mixtral's 6144 x 16384 experts, top-2):
//   * decode and chunked prefill (a few to ~64 rows an expert): bytes. The
//     kernel must stream every touched expert's (D, F) matrix once (201 MB
//     in bf16, 0.060 ms at 3.35 TB/s) and does ~2 flops per weight byte,
//     far below the ~295 flop/byte ridge; int8 weights halve the bytes;
//   * whole-prompt prefill (~1000 rows an expert): operations. 9000 routed
//     rows do 2 * 9000 * 6144 * 16384 flops, 1.83 ms at 989 TFLOP/s, on
//     1.6 GB of weights (0.48 ms).
//
// Both bf16 bodies first run a one-block table kernel over the ids: the
// runs of equal ids, cut into chunks of at most CH rows (a run's last
// chunk may end mid-tile: chunks are rows, not tiles), listed as live
// chunks (expert >= 0) and zero chunks, into wrapper-allocated scratch.
// The bodies then walk those lists; no block scans the ids.
//
// Stream body (bf16 activations; bf16 or int8 weights; the decode regime):
//   * a unit is one live chunk of <= 64 rows, one F-tile (128 bf16 or 256
//     int8 columns: 256 bytes of each K row either way; int8 units of 128
//     columns read rows of 128 bytes, which streamed at about half the
//     rate) and one of S K-splits (S in 1, 2, 4, 8); the S splits of a
//     (chunk, F-tile) are the S blocks of one thread-block cluster,
//     launched with cudaLaunchKernelEx. Clusters are persistent (as many
//     as fit at once at one block an SM, cudaOccupancyMaxActiveClusters)
//     and walk the units, the chunks of one F-tile adjacent so that a long
//     run's later chunks find the expert's tile in L2;
//   * weights stream by TMA through a 3D tensor map over (E, D, F) (K past
//     D reads zeros, never the next expert's rows) into a ring of 8 (bf16)
//     or 6 (int8) stages of 64 K rows x 256 bytes in the 128-byte
//     swizzle, with the chunk's x rows for that K tile (8-row boxes, only
//     as many as the chunk has) in the same stage: up to 112 KB (bf16) or
//     80 KB (int8) of weights in flight an SM. Thread 0 issues the loads
//     ST - 1 stages ahead, across units, on full / empty mbarriers, from
//     chunk entries it holds in registers a unit ahead;
//   * products: mma.sync m16n8k16 with the weight tile as the M operand
//     (swap-AB: out^T = W^T x^T), so an 8-row decode chunk fills the n = 8
//     side; 8 warps of 16 (bf16) or 32 (int8) columns; bf16 W^T fragments
//     come from ldmatrix.trans, x fragments from ldmatrix; the count of
//     8-row tiles is a template, so each chunk height runs straight-line
//     code. int8 weights stay int8 in shared memory and widen to bf16 in
//     registers (exact for |q| <= 127: a float magic number, then the
//     upper halves); the per-expert scale multiplies the f32 sum;
//   * the S partial sums (f32, in each block's shared memory, outside the
//     ring) merge through distributed shared memory in rank order, each
//     rank storing its share of the chunk's outputs (scaled, cast once,
//     16-byte stores). No atomics: a call is bit-reproducible.
//
// wgmma body (bf16 activations and weights; from ~10 rows an expert, the
// chunk and whole-prompt regimes: moe_gemm.py::WGMMA_MIN_ROWS): the
// bf16 design of matmul.cu: persistent blocks, one an SM, walk items of
// (live chunk of <= 128 rows, 256-column F-tile) in groups of 8 chunks
// (kGroupM), so the blocks running at once share an expert's B panels in
// L2; two consumer warpgroups on wgmma m64n256k16 and one producer warp
// that issues TMA; a 4-stage ring of 64-deep K tiles in the 128-byte
// swizzle, every consumer thread releasing a slot; the weights through the
// same 3D map over (E, D, F); rows of a chunk's tile past the chunk belong
// to the next run or are padding, and the masked epilogue (16-byte stores
// from registers) never stores them.
//
// In both bodies zero chunks store zeros and load nothing, and TMA needs
// rows of whole 16-byte chunks: the wrapper pads zeroed copies of x and w
// where they are not (kernels/moe_gemm.py).
//
// f32 activations (f32 or int8 weights): f32 FMAs on CUDA cores, exact to
// f32 rounding, over segments of up to 32 rows (fma_path below; a block
// finds its segment with one parallel scan over group_ids).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr int kThreads = 256;
constexpr int kBN = 128;  // output columns per block

struct Args {
  const void* x;
  const void* w;
  const int* gids;
  const float* scale;  // (E,) or null
  void* out;
  int M, D, E, F, nb, bm;
  int vec_x, vec_w;  // rows 16-byte aligned: 16-byte loads allowed
};

// The block's rows: [r_lo, r_lo + nrows) of expert g (-1: zeros).
struct Segment {
  int g, r_lo, nrows;
};

// Whether this block owns a segment, and which. Every thread returns the
// same answer (the branch on it is block-uniform).
template <int MT>
__device__ bool find_segment(const Args& a, Segment& s) {
  __shared__ int s_hit;
  __shared__ int s_tiles;
  const int i = blockIdx.x;
  const int gi = a.gids[i];
  if (threadIdx.x == 0) s_hit = -1;
  __syncthreads();
  // run start: one past the last tile before i with another id
  for (int base = i - 1; base >= 0; base -= kThreads) {
    const int j = base - (int)threadIdx.x;
    const bool hit = j >= 0 && a.gids[j] != gi;
    if (hit) atomicMax(&s_hit, j);
    if (__syncthreads_or(hit)) break;
  }
  const int run_start = s_hit + 1;
  const int seg_tiles = MT >= a.bm ? MT / a.bm : 1;
  if ((i - run_start) % seg_tiles != 0) return false;
  if (threadIdx.x == 0) {
    int n = 1;
    while (n < seg_tiles && i + n < a.nb && a.gids[i + n] == gi) ++n;
    s_tiles = n;
  }
  __syncthreads();
  const int rows = s_tiles * a.bm;
  s.r_lo = i * a.bm + blockIdx.z * MT;
  s.nrows = min(MT, rows - (int)blockIdx.z * MT);
  s.g = gi < 0 ? -1 : min(gi, a.E - 1);  // ids past E clamp, as a gather
  return s.nrows > 0;
}

template <typename OT>
__device__ __forceinline__ OT from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename OT>
__device__ void zero_fill(const Args& a, const Segment& s, int f0) {
  OT* out = static_cast<OT*>(a.out);
  const int cols = min(kBN, a.F - f0);
  for (int idx = threadIdx.x; idx < s.nrows * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    if (c < cols) out[(size_t)(s.r_lo + r) * a.F + f0 + c] = from_f<OT>(0.f);
  }
}

// 16 bytes of row `row`, columns [col, col + 16 / sizeof(T)) of a row-major
// matrix with leading dimension ld; rows >= nrows and columns >= ncols read
// as zero.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* base, int ld, int row,
                                        int nrows, int col, int ncols,
                                        bool vec) {
  constexpr int V = 16 / sizeof(T);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row >= nrows) return r;
  const T* p = base + (size_t)row * ld + col;
  if (vec && col + V <= ncols) return __ldg(reinterpret_cast<const uint4*>(p));
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (col + k < ncols) e[k] = p[k];
  return r;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// ------------------------------------------------------- bf16: shared parts

constexpr size_t kSmemMax = 232448;  // an H100 block's opt-in maximum
constexpr int kBK = 64;              // K rows of a stage: one 128-byte bf16 row

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

// One box of a 2D / 3D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Eight outputs from f32 to bf16 as one 16-byte chunk.
__device__ __forceinline__ uint4 pack8(const float4& a, const float4& b) {
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// Stores 8 consecutive outputs of one row at column `col` of a row with
// `cols` valid columns: one 16-byte store when the row takes them.
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const uint4& v,
                                       int col, int cols, int vec) {
  if (col >= cols) return;
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (col + j < cols) dst[j] = e[j];
}

// The chunk lists that table_kernel writes: chunk = (first row, rows,
// expert or -1, 0).
struct Table {
  const int4* live;   // chunks of experts >= 0, in run order
  const int4* zero;   // chunks of runs with id < 0
  const int* counts;  // [live chunks, zero chunks]
};

// Zero chunks x column tiles of `cols` columns: blocks take them in turn
// (nthreads of each block store).
__device__ __forceinline__ void zero_chunks(const Table& t,
                                            __nv_bfloat16* out, int F,
                                            int cols, int tiles_f, int vec,
                                            int tid, int nthreads) {
  const int nz = t.counts[1];
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int u = blockIdx.x; u < nz * tiles_f; u += gridDim.x) {
    const int4 ch = t.zero[u % nz];
    const int f0 = (u / nz) * cols;
    for (int i = tid; i < ch.y * (cols / 8); i += nthreads) {
      const int r = i / (cols / 8), c = f0 + (i % (cols / 8)) * 8;
      store8(out + (size_t)(ch.x + r) * F + c, z, c, F, vec);
    }
  }
}

// ------------------------------------------------------- the table kernel

constexpr int kTableThreads = 1024;

// Exclusive prefix sum of v over the block; `total` gets the block's sum.
__device__ int block_scan(int v, int& total) {
  __shared__ int sums[kTableThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : sums[warp - 1];
  total = sums[kTableThreads / 32 - 1];
  __syncthreads();  // sums is read before the next call writes it
  return before + x - v;
}

struct TArgs {
  const int* gids;
  int nb, bm, E, ch;  // ch: rows of a chunk
  int* run_start;     // (nb + 1,): first tile of each run, then nb
  int* run_g;         // (nb,): each run's id
  int4* live;
  int4* zero;
  int* counts;
};

// One block: the runs of equal ids (a parallel scan of run starts, 1024
// tiles a pass), then each run cut into chunks of at most ch rows, the
// live and the zero chunks each in run order.
__global__ void __launch_bounds__(kTableThreads) table_kernel(const TArgs t) {
  int runs = 0;
  for (int base = 0; base < t.nb; base += kTableThreads) {
    const int i = base + (int)threadIdx.x;
    int g = 0;
    bool start = false;
    if (i < t.nb) {
      g = t.gids[i];
      start = i == 0 || t.gids[i - 1] != g;
    }
    int total;
    const int r = runs + block_scan(start ? 1 : 0, total);
    if (start) {
      t.run_start[r] = i;
      t.run_g[r] = g;
    }
    runs += total;
  }
  if (threadIdx.x == 0) t.run_start[runs] = t.nb;
  __syncthreads();
  int n_live = 0, n_zero = 0;
  for (int base = 0; base < runs; base += kTableThreads) {
    const int r = base + (int)threadIdx.x;
    int row0 = 0, rows = 0, g = -1, nch = 0;
    if (r < runs) {
      row0 = t.run_start[r] * t.bm;
      rows = (t.run_start[r + 1] - t.run_start[r]) * t.bm;
      g = t.run_g[r];
      nch = (rows + t.ch - 1) / t.ch;
    }
    const bool live = g >= 0;
    int tl, tz;
    const int ol = n_live + block_scan(live ? nch : 0, tl);
    const int oz = n_zero + block_scan(live ? 0 : nch, tz);
    const int ge = live ? min(g, t.E - 1) : -1;
    for (int c = 0; c < nch; ++c) {
      const int4 e = make_int4(row0 + c * t.ch, min(t.ch, rows - c * t.ch),
                               ge, 0);
      if (live)
        t.live[ol + c] = e;
      else
        t.zero[oz + c] = e;
    }
    n_live += tl;
    n_zero += tz;
  }
  if (threadIdx.x == 0) {
    t.counts[0] = n_live;
    t.counts[1] = n_zero;
  }
}

// ---------------------------------------------------------- the stream body
//
// 8 warps (4 warps, each with more columns, left the loads waiting on the
// int8 widening and on the products of a 64-row chunk); thread 0 also
// issues the loads. A stage:
// the weight tile (64 K rows x 256 bytes: two panels of 128-byte rows in
// the 128-byte swizzle) and 8 x boxes of 8 rows x 64 K (one swizzle atom
// each), only ceil(rows / 8) of them loaded. After its K range, a block
// keeps its f32 partial (rows x columns) in a region of its own, outside the
// ring, so the next unit's loads run on under the merge.

namespace stream_path {

constexpr int kRows = 64;      // rows of a chunk: the mma's n side, 8 tiles
constexpr int kClusterMax = 8;
constexpr int kXBox = 8;                  // rows of an x box
constexpr int kXBytes = kRows * kBK * 2;  // 8 KB: 8 boxes of 1 KB

// A unit's columns (the mma's m side): 128 of bf16, 256 of int8, so that a
// stage reads 256 contiguous bytes of each K row either way (int8 units
// of 128 columns read rows of 128 bytes and streamed at half the rate).
// 8 warps share them: 16 bf16 or 32 int8 columns a warp (16 warps of 16
// int8 columns were slower: twice the loads of 16 bits).
template <typename WT>
struct Ring {
  static constexpr int kCols = 256 / (int)sizeof(WT);
  static constexpr int kMT = kCols / 128;  // m-tiles of 16 columns a warp
  static constexpr int kThreads = 256;
  static constexpr int kPanels = 2;  // 128-byte-wide boxes a stage
  static constexpr int kWBytes = kBK * 256;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kStages = sizeof(WT) == 2 ? 8 : 6;
  static constexpr int kLdP = kCols + 4;  // floats a partial row
  static constexpr int kPartBytes = kRows * kLdP * 4;
  // 1024: the swizzled tiles need a 1024-byte-aligned base
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kPartBytes + 2 * kStages * 8;
  static_assert((size_t)kSmem <= kSmemMax, "ring above shared memory");
};

struct SArgs {
  Table t;
  const float* scale;  // (E,) or null
  __nv_bfloat16* out;
  int F, nk, tiles_f, splits, vec;
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The two halves of a cluster barrier: every thread of every block of the
// cluster arrives (release) before any passes the wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of `p` (this block's shared memory) in block `rank`'s.
__device__ __forceinline__ uint32_t peer_addr(const void* p, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 peer_ld4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
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

// Four 8x8 bf16 matrices, transposed or not; lanes 8i .. 8i + 7 address
// the rows of matrix i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Byte j of 128-byte row `row` of a swizzled tile: 16-byte chunk c sits at
// chunk c ^ (row % 8).
__device__ __forceinline__ int swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// The bf16 pair (byte j of lo, byte j of hi), each an int8 widened exactly:
// 0x4B000000 | (q ^ 0x80) is the float 2^23 + 128 + q; less 2^23 + 128 it
// is q, whose upper 16 bits are its bf16 (|q| <= 128 fits 8 bits). (Two
// bit masks and a bf16x2 add a pair instead took longer on the H100.)
__device__ __forceinline__ uint32_t widen_pair(uint32_t lo, uint32_t hi,
                                               int j) {
  const uint32_t sel = (uint32_t)j | 0x7540u;  // byte j, 0, 0, 0x4B
  const float a =
      __uint_as_float(__byte_perm(lo ^ 0x80808080u, 0x4B000000u, sel)) -
      8388736.0f;
  const float b =
      __uint_as_float(__byte_perm(hi ^ 0x80808080u, 0x4B000000u, sel)) -
      8388736.0f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
}

// The column of the unit that accumulator row g (+ 8 * half) of this
// warp's m-tile mt holds. bf16: ldmatrix.trans gives the warp 16
// consecutive columns. int8: a lane reads 4 consecutive columns of a K
// row as one 32-bit word and takes columns 4g, 4g + 1 (rows g, g + 8) for
// m-tile 0 and 4g + 2, 4g + 3 for m-tile 1 of the warp's 32, so the rows
// of the products are a permutation of the columns.
template <typename WT>
__device__ __forceinline__ int acc_col(int warp, int mt, int g, int half) {
  if (sizeof(WT) == 2) return warp * 16 + g + 8 * half;
  return warp * 32 + 4 * g + 2 * mt + half;
}

// The products of one stage: acc[mt][n] (16 columns x 8 rows) += W^T x^T
// over the stage's 64 K rows, for the chunk's first NT 8-row tiles (a
// template, so each count is straight-line code whose loads the compiler
// can hoist). A stage's weight tile is two panels of 64 K rows x 128
// bytes; column c of the unit is byte c * sizeof(WT) % 128 of panel
// c * sizeof(WT) / 128.
template <typename WT, int NT>
__device__ __forceinline__ void stage_mma(
    float (&acc)[Ring<WT>::kMT][kRows / 8][4], const uint8_t* w,
    const uint8_t* x, int warp, int lane) {
  constexpr int MT = Ring<WT>::kMT;
  const int mi = lane >> 3, r = lane & 7;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16 * MT * (int)sizeof(WT);  // the warp's first byte
  const uint8_t* pw = w + (m0 >> 7) * (kBK * 128);
#pragma unroll
  for (int k2 = 0; k2 < kBK / 32; ++k2) {
    uint32_t a[2][MT][4];  // the W^T fragments of k steps 2 k2, 2 k2 + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 2 * k2 + h;
      if (sizeof(WT) == 2) {
        // matrix mi: K rows 16 kk + 8 (mi / 2) .. + 7 of the warp's
        // columns 8 (mi % 2) .. + 7, transposed
        const int k = kk * 16 + (mi >> 1) * 8 + r;
        ldsm_x4_trans(a[h][0], pw + swz(k, (m0 & 127) + (mi & 1) * 16));
      } else {
        // int8 columns 4 g .. 4 g + 3 of the warp's 32, of K rows 2t,
        // 2t + 1, 2t + 8, 2t + 9 of this k step
        const int k = kk * 16 + 2 * t, b = (m0 & 127) + 4 * g;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(pw + swz(k, b));
        const uint32_t r1 =
            *reinterpret_cast<const uint32_t*>(pw + swz(k + 1, b));
        const uint32_t r2 =
            *reinterpret_cast<const uint32_t*>(pw + swz(k + 8, b));
        const uint32_t r3 =
            *reinterpret_cast<const uint32_t*>(pw + swz(k + 9, b));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[h][mt][0] = widen_pair(r0, r1, 2 * mt);
          a[h][mt][1] = widen_pair(r0, r1, 2 * mt + 1);
          a[h][mt][2] = widen_pair(r2, r3, 2 * mt);
          a[h][mt][3] = widen_pair(r2, r3, 2 * mt + 1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // x fragments: rows 8 n + r of box n, K 32 k2 + 8 mi .. + 7
      uint32_t bx[4];
      ldsm_x4(bx, x + n * 1024 + swz(r, (k2 * 32 + mi * 8) * 2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][n], a[0][mt], bx);
        mma_bf16(acc[mt][n], a[1][mt], bx + 2);
      }
    }
  }
}

template <typename WT>
__device__ __forceinline__ void stage_mma(
    float (&acc)[Ring<WT>::kMT][kRows / 8][4], const uint8_t* w,
    const uint8_t* x, int nt, int warp, int lane) {
  switch (nt) {
    case 1: stage_mma<WT, 1>(acc, w, x, warp, lane); break;
    case 2: stage_mma<WT, 2>(acc, w, x, warp, lane); break;
    case 3: stage_mma<WT, 3>(acc, w, x, warp, lane); break;
    case 4: stage_mma<WT, 4>(acc, w, x, warp, lane); break;
    case 5: stage_mma<WT, 5>(acc, w, x, warp, lane); break;
    case 6: stage_mma<WT, 6>(acc, w, x, warp, lane); break;
    case 7: stage_mma<WT, 7>(acc, w, x, warp, lane); break;
    default: stage_mma<WT, 8>(acc, w, x, warp, lane); break;
  }
}

template <typename WT>
__global__ void __launch_bounds__(Ring<WT>::kThreads, 1)
    stream_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, const SArgs a) {
  using R = Ring<WT>;
  constexpr int ST = R::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kCols = R::kCols, kLdP = R::kLdP, kThreads = R::kThreads;
  float* part = reinterpret_cast<float*>(ring + ST * R::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kRows * kLdP);
  uint64_t* empty = full + ST;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.splits;
  const unsigned rank = cluster_rank();
  const int cid = (int)blockIdx.x / S, ncl = (int)gridDim.x / S;
  if (tid == 0) {
    prefetch_map(&tx);
    prefetch_map(&tw);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kThreads);  // every thread releases a slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_live = a.t.counts[0];
  const int units = n_live * a.tiles_f;
  // this rank's K tiles of every unit: [kb, kb + nkr)
  const int per = (a.nk + S - 1) / S;
  const int kb = min(a.nk, (int)rank * per);
  const int nkr = min(a.nk, kb + per) - kb;
  const int mine = cid < units ? (units - 1 - cid) / ncl + 1 : 0;
  const long long total = (long long)mine * nkr;
  // unit i of this cluster: chunk u % n_live, F-tile u / n_live
  auto unit = [&](long long i, int4& ch, int& f0) {
    const int u = cid + (int)i * ncl;
    ch = a.t.live[u % n_live];
    f0 = (u / n_live) * kCols;
  };

  // thread 0: load j of this block's walk goes to slot j % ST once every
  // thread released the slot's use j - ST. It keeps the unit of its next
  // load in registers and fetches the one after a unit ahead, so no load
  // waits on a read of the chunk list.
  long long issued = 0;
  int p_i = 0, p_kt = 0, p_f0 = 0, n_f0 = 0;
  int4 p_ch = make_int4(0, 0, 0, 0), n_ch = p_ch;
  if (tid == 0 && total > 0) {
    unit(0, p_ch, p_f0);
    if (mine > 1) unit(1, n_ch, n_f0);
  }
  auto issue = [&]() {
    const int s = (int)(issued % ST);
    if (issued >= ST) mbar_wait(empty + s, (int)((issued / ST - 1) & 1));
    const int k0 = (kb + p_kt) * kBK;
    const int boxes = (p_ch.y + kXBox - 1) / kXBox;
    uint8_t* st = ring + s * R::kStageBytes;
    mbar_expect_tx(full + s, R::kWBytes + boxes * kXBox * kBK * 2);
#pragma unroll
    for (int pn = 0; pn < R::kPanels; ++pn)
      tma_load(st + pn * (kBK * 128), &tw, full + s,
               p_f0 + pn * (128 / (int)sizeof(WT)), k0, p_ch.z);
    for (int b = 0; b < boxes; ++b)
      tma_load(st + R::kWBytes + b * 1024, &tx, full + s, k0,
               p_ch.x + b * kXBox);
    ++issued;
    if (++p_kt == nkr) {
      p_kt = 0;
      p_ch = n_ch;
      p_f0 = n_f0;
      if (++p_i + 1 < mine) unit(p_i + 1, n_ch, n_f0);
    }
  };
  if (tid == 0)
    while (issued < total && issued < ST - 1) issue();

  long long q = 0;  // K tiles consumed
  int4 c_next = make_int4(0, 0, 0, 0);
  int f_next = 0;
  if (mine > 0) unit(0, c_next, f_next);
  for (int i = 0; i < mine; ++i) {
    const int4 ch = c_next;
    const int f0 = f_next;
    if (i + 1 < mine) unit(i + 1, c_next, f_next);
    const int nt = (ch.y + 7) / 8;  // 8-row tiles of the chunk
    float acc[R::kMT][kRows / 8][4];
#pragma unroll
    for (int mt = 0; mt < R::kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    for (int kt = 0; kt < nkr; ++kt, ++q) {
      if (tid == 0 && issued < total) issue();
      const int s = (int)(q % ST);
      mbar_wait(full + s, (int)((q / ST) & 1));
      const uint8_t* st = ring + s * R::kStageBytes;
      stage_mma<WT>(acc, st, st + R::kWBytes, nt, warp, lane);
      mbar_arrive(empty + s);
    }

    // the partial: rows 8 n + 2 t (+ 1), this lane's columns
    if (i > 0) cluster_wait();  // every rank has merged the last unit
#pragma unroll
    for (int mt = 0; mt < R::kMT; ++mt)
#pragma unroll
      for (int n = 0; n < kRows / 8; ++n) {
        if (n >= nt) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = acc_col<WT>(warp, mt, g, h);
          part[(8 * n + 2 * t) * kLdP + c] = acc[mt][n][2 * h];
          part[(8 * n + 2 * t + 1) * kLdP + c] = acc[mt][n][2 * h + 1];
        }
      }
    cluster_arrive();
    cluster_wait();
    // this rank's share of the chunk's (row, 8 columns) groups: the S
    // partials summed in rank order, scaled, cast once
    const float sc = a.scale ? a.scale[ch.z] : 1.f;
    const int groups = ch.y * (kCols / 8);
    const int lo = (int)((long long)groups * rank / S);
    const int hi = (int)((long long)groups * (rank + 1) / S);
    for (int idx = lo + tid; idx < hi; idx += kThreads) {
      const int r = idx / (kCols / 8), c = (idx % (kCols / 8)) * 8;
      const uint32_t p0 = peer_addr(part + r * kLdP + c, 0);
      float4 x0 = peer_ld4(p0), x1 = peer_ld4(p0 + 16);
#pragma unroll
      for (int s = 1; s < kClusterMax; ++s)
        if (s < S) {
          const uint32_t p = peer_addr(part + r * kLdP + c, s);
          const float4 v0 = peer_ld4(p), v1 = peer_ld4(p + 16);
          x0.x += v0.x; x0.y += v0.y; x0.z += v0.z; x0.w += v0.w;
          x1.x += v1.x; x1.y += v1.y; x1.z += v1.z; x1.w += v1.w;
        }
      x0.x *= sc; x0.y *= sc; x0.z *= sc; x0.w *= sc;
      x1.x *= sc; x1.y *= sc; x1.z *= sc; x1.w *= sc;
      store8(a.out + (size_t)(ch.x + r) * a.F + f0 + c, pack8(x0, x1),
             f0 + c, a.F, a.vec);
    }
    cluster_arrive();  // this rank is done reading the others' partials
  }
  if (mine > 0) cluster_wait();  // no block leaves while another reads it
  zero_chunks(a.t, a.out, a.F, kCols, a.tiles_f, a.vec, tid, kThreads);
}

}  // namespace stream_path

// ----------------------------------------------------------- the wgmma body
//
// matmul.cu's bf16 design over the live chunks of <= 128 rows: 288
// threads, two consumer warpgroups of 64 rows each and one producer warp.

namespace wgmma_path {

constexpr int kBM = 128, kBN = 256;  // chunk rows; columns of an item
constexpr int kStages = 4;
constexpr int kGroupM = 8;     // chunks of a raster group
constexpr int kThreads = 288;  // two consumer warpgroups + a producer warp
constexpr int kPanel = 64;     // bf16 columns of a 128-byte swizzled panel
constexpr int kABytes = kBM * kBK * 2;  // 16 KB
constexpr int kBBytes = kBK * kBN * 2;  // 32 KB: kBN / kPanel panels
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
static_assert((size_t)kSmem <= kSmemMax, "ring above shared memory");

struct WArgs {
  Table t;
  const float* scale;  // (E,) or null
  __nv_bfloat16* out;
  int F, tiles_n, n_k, vec;
};

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

// Pins registers that an asynchronous wgmma writes, so the compiler moves
// no use of them above the wait that completes it.
__device__ __forceinline__ void keep(float (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 256, f32) += A . B, A (64 x 16) K-major and B (16 x 256)
// MN-major, both in shared memory. Accumulator layout: thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and, in each
// 8-column chunk c, columns 8 c + 2 (t % 4) (+ 1): d[4 c + {0, 1, 2, 3}] =
// (row, col), (row, col + 1), (row + 8, col), (row + 8, col + 1).
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// The item at position i of the walk: chunks in groups of kGroupM, each
// group walked column by column (moe_gemm.py::wgmma_walk mirrors it).
__device__ __forceinline__ void item_coords(int chunks, int tiles_n, int i,
                                            int& c, int& n) {
  const int per_group = kGroupM * tiles_n;
  const int first = i / per_group * kGroupM;
  const int rows = min(chunks - first, kGroupM);
  const int r = i % per_group;
  c = first + r % rows;
  n = r / rows;
}

// Four consecutive columns [col, col + 4) of one row of this lane: lane
// pairs (t, t ^ 1) of a quad trade halves, so an even lane holds row `row`
// and an odd one row + 8, each at column 8 c + 4 ((t % 4) / 2).
__device__ __forceinline__ float4 quad_row4(const float (&acc)[128], int c,
                                            bool odd) {
  const float s0 = odd ? acc[4 * c] : acc[4 * c + 2];
  const float s1 = odd ? acc[4 * c + 1] : acc[4 * c + 3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  return odd ? make_float4(r0, r1, acc[4 * c + 2], acc[4 * c + 3])
             : make_float4(acc[4 * c], acc[4 * c + 1], r0, r1);
}

// The tile's rows [row0, row0 + 16) of this warp, scaled by sc: after
// quad_row4, lanes t and t ^ 2 trade the halves of chunks c and c + 1, so
// a lane with t % 4 < 2 holds 8 columns of chunk c and one with t % 4 >= 2
// those of chunk c + 1. Rows at or past `rows` (of the chunk) are not
// stored.
__device__ __forceinline__ void store_tile(const WArgs& p,
                                           const float (&acc)[128],
                                           int first_row, int local_row,
                                           int rows, int col0, int lane,
                                           float sc) {
  const bool odd = lane & 1, hi = lane & 2;
  const int lr = local_row + (odd ? 8 : 0);
  const bool live = lr < rows;
#pragma unroll
  for (int c = 0; c < kBN / 8; c += 2) {
    float4 a = quad_row4(acc, c, odd);
    float4 b = quad_row4(acc, c + 1, odd);
    a.x *= sc; a.y *= sc; a.z *= sc; a.w *= sc;
    b.x *= sc; b.y *= sc; b.z *= sc; b.w *= sc;
    const uint32_t a0 = pack_bf16(a.x, a.y), a1 = pack_bf16(a.z, a.w);
    const uint32_t b0 = pack_bf16(b.x, b.y), b1 = pack_bf16(b.z, b.w);
    const uint32_t s0 = __shfl_xor_sync(0xffffffffu, hi ? a0 : b0, 2);
    const uint32_t s1 = __shfl_xor_sync(0xffffffffu, hi ? a1 : b1, 2);
    const uint4 v = hi ? make_uint4(s0, s1, b0, b1) : make_uint4(a0, a1, s0, s1);
    const int col = col0 + 8 * (c + (hi ? 1 : 0));
    if (live)
      store8(p.out + (size_t)(first_row + lr) * p.F + col, v, col, p.F,
             p.vec);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw, const WArgs p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int warp = (threadIdx.x & 127) >> 5;
  if (threadIdx.x == 0) {
    prefetch_map(&tx);
    prefetch_map(&tw);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = p.t.counts[0];
  const int items = chunks * p.tiles_n;
  const int mine = (int)blockIdx.x < items
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  if (wg == 2) {
    // the producer: K tile j of this block's walk goes to slot j % kStages
    // once all 256 consumer threads released the slot's use j - kStages
    if (threadIdx.x != 256) return;
    const long long total = (long long)mine * p.n_k;
    int4 ch = make_int4(0, 0, 0, 0);
    int n = 0, kt = 0;
    for (long long j = 0; j < total; ++j, ++kt) {
      const int s = (int)(j % kStages);
      if (j == 0 || kt == p.n_k) {  // the next item: its chunk, once
        int c;
        item_coords(chunks, p.tiles_n,
                    (int)blockIdx.x + (int)(j / p.n_k) * (int)gridDim.x, c,
                    n);
        ch = p.t.live[c];
        kt = 0;
      }
      if (j >= kStages) mbar_wait(empty + s, (int)((j / kStages - 1) & 1));
      const int k0 = kt * kBK;
      uint8_t* st = ring + s * kStageBytes;
      mbar_expect_tx(full + s, kStageBytes);
      tma_load(st, &tx, full + s, k0, ch.x);
#pragma unroll
      for (int q = 0; q < kBN / kPanel; ++q)
        tma_load(st + kABytes + q * kBK * 128, &tw, full + s,
                 n * kBN + q * kPanel, k0, ch.z);
    }
    return;
  }

  // a consumer warpgroup: 64 rows of each item; every thread releases a
  // slot, so no path between two products diverges (ptxas serializes
  // wgmma around a divergent one)
  long long g = 0;  // K tiles consumed
  for (int i = 0; i < mine; ++i) {
    int c, n;
    item_coords(chunks, p.tiles_n, (int)blockIdx.x + i * (int)gridDim.x, c,
                n);
    const int4 ch = p.t.live[c];  // read now, used by the epilogue
    float acc[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < p.n_k; ++kt, ++g) {
      const int s = (int)(g % kStages);
      mbar_wait(full + s, (int)((g / kStages) & 1));
      const uint8_t* st = ring + s * kStageBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_256(acc, desc128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                  desc128(st + kABytes + kk * 16 * 128, kBK * 128, 1024));
      wg_commit();
      wg_wait<1>();  // the products of K tile g - 1 are done
      if (kt > 0) mbar_arrive(empty + (int)((g - 1) % kStages));
    }
    wg_wait<0>();
    keep(acc);
    if (p.n_k > 0) mbar_arrive(empty + (int)((g - 1) % kStages));
    store_tile(p, acc, ch.x, wg * 64 + warp * 16 + (lane >> 2), ch.y,
               n * kBN, lane, p.scale ? p.scale[ch.z] : 1.f);
  }
  zero_chunks(p.t, p.out, p.F, kBN, p.tiles_n, p.vec, threadIdx.x, 256);
}

}  // namespace wgmma_path

// ----------------------------------------------------------------- f32 path
//
// Block tile 32 rows x 128 columns, K-tile 32; thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3 and columns tx + 32 j (j < 4): a warp shares its rows
// (broadcast reads of x) and reads 32 consecutive weight columns.

namespace fma_path {

constexpr int MT = 32, BK = 32;
constexpr int X_STAGE = BK * MT;  // x transposed: [k][row]
constexpr int W_STAGE = BK * kBN;
constexpr int STAGE = X_STAGE + W_STAGE;
constexpr size_t SMEM = 2 * STAGE * sizeof(float);

template <typename WT>
struct WLoad {
  static constexpr int V = 16 / sizeof(WT);
  static constexpr int PER_ROW = kBN / V;
  static constexpr int CHUNKS = BK * kBN / V / kThreads;
};

template <typename WT>
__global__ void __launch_bounds__(kThreads) kernel(Args a) {
  using L = WLoad<WT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);

  Segment s;
  if (!find_segment<MT>(a, s)) return;
  const int f0 = blockIdx.y * kBN;
  if (s.g < 0) {
    zero_fill<float>(a, s, f0);
    return;
  }
  const float* X = static_cast<const float*>(a.x) + (size_t)s.r_lo * a.D;
  const WT* W = static_cast<const WT*>(a.w) + (size_t)s.g * a.D * a.F + f0;
  const int fcols = a.F - f0;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  static_assert(MT * BK / 4 == kThreads, "one x chunk per thread");

  uint4 xr, wr[L::CHUNKS];
  auto load = [&](int k0) {
    xr = load16(X + k0, a.D, tid / (BK / 4), s.nrows, (tid % (BK / 4)) * 4,
                a.D - k0, a.vec_x);
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      wr[c] = load16(W + (size_t)k0 * a.F, a.F, q / L::PER_ROW, a.D - k0,
                     (q % L::PER_ROW) * L::V, fcols, a.vec_w);
    }
  };
  auto store = [&](int stage) {
    float* xs = sm + stage * STAGE;
    float* ws = xs + X_STAGE;
    const float* xv = reinterpret_cast<const float*>(&xr);
    const int row = tid / (BK / 4), col = (tid % (BK / 4)) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[(col + e) * MT + row] = xv[e];
#pragma unroll
    for (int c = 0; c < L::CHUNKS; ++c) {
      const int q = tid + c * kThreads;
      float* dst = ws + (q / L::PER_ROW) * kBN + (q % L::PER_ROW) * L::V;
      const WT* e = reinterpret_cast<const WT*>(&wr[c]);
#pragma unroll
      for (int k = 0; k < L::V; ++k) dst[k] = to_f(e[k]);
    }
  };

  float acc[4][4] = {};
  const bool live = ty * 4 < s.nrows;  // warp-uniform
  const int nk = (a.D + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * BK);
    if (live) {
      const float* xs = sm + (kt & 1) * STAGE;
      const float* ws = xs + X_STAGE;
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + k * MT + ty * 4);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wv = ws[k * kBN + tx + 32 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(xa[r], wv, acc[r][j]);
        }
      }
    }
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  const float sc = a.scale ? a.scale[s.g] : 1.f;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= s.nrows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 32 * j;
      if (c < fcols)
        out[(size_t)(s.r_lo + row) * a.F + f0 + c] = acc[r][j] * sc;
    }
  }
}

}  // namespace fma_path

template <typename K>
int launch(K kernel, size_t smem, int mt, const Args& a, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(a.nb, (a.F + kBN - 1) / kBN,
                  a.bm > mt ? (a.bm + mt - 1) / mt : 1);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Chunks of at most ch rows that the runs of nb tiles of M / nb rows can
// make, the live and the zero ones each: a run of L tiles makes
// ceil(L bm / ch) chunks, at most L ceil(bm / ch) and at most
// floor(L bm / ch) + 1 (moe_gemm.py::chunk_cap mirrors it).
long long grouped_chunk_cap(long long M, long long nb, long long ch) {
  const long long bm = M / nb;
  const long long a = nb * ((bm + ch - 1) / ch), b = M / ch + nb;
  return a < b ? a : b;
}

// int32 scratch of a call: the counts (one int4), the live and the zero
// chunk lists (int4 each), the run table (2 x (nb + 1))
// (moe_gemm.py::scratch_ints mirrors it).
long long grouped_scratch_ints(long long M, long long nb, long long ch) {
  return 4 * (1 + 2 * grouped_chunk_cap(M, nb, ch)) + 2 * (nb + 1);
}

// ---------------------------------------------------------------- bf16 host

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

// x (M, D) bf16, row stride ldx: boxes of 64 K x box_rows rows.
bool x_map(CUtensorMap* map, const void* x, int M, int D, int ldx,
           int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)ldx * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w (E, D, F) of `es`-byte elements (bf16 or int8), row stride ldw: boxes
// of one 128-byte row of columns x 64 K rows x one expert; K past D and
// columns past F read as zeros.
bool w_map(CUtensorMap* map, const void* w, int E, int D, int F, int ldw,
           int es) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)ldw * es,
                                 (cuuint64_t)D * ldw * es};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), (cuuint32_t)kBK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            3, const_cast<void*>(w), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count(int& sms) {
  if (sms > 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// The stream body's launch shape at `splits` blocks a cluster: its
// dynamic shared memory opted in, then as many clusters as fit on the card
// at once (cudaOccupancyMaxActiveClusters, one block an SM), counted once.
template <typename WT>
int stream_config(int splits, cudaLaunchConfig_t& cfg,
                  cudaLaunchAttribute* attr) {
  using R = stream_path::Ring<WT>;
  static bool opted_in = false;
  static int clusters[stream_path::kClusterMax + 1] = {};
  static int sms = 0;
  if (splits < 1 || splits > stream_path::kClusterMax)
    return (int)cudaErrorInvalidValue;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_path::stream_kernel<WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  cfg = cudaLaunchConfig_t{};
  cfg.blockDim = dim3(R::kThreads);
  cfg.dynamicSmemBytes = R::kSmem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters[splits] == 0) {
    cfg.gridDim = dim3(splits * sms);
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n, stream_path::stream_kernel<WT>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n <= 0) return (int)cudaErrorInvalidConfiguration;
    clusters[splits] = n;
  }
  cfg.gridDim = dim3(splits * clusters[splits]);
  return 0;
}

template <typename WT>
int launch_stream(const CUtensorMap& tx, const CUtensorMap& tw,
                  const stream_path::SArgs& a, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int rc = stream_config<WT>(a.splits, cfg, attr);
  if (rc != 0) return rc;
  cfg.stream = st;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, stream_path::stream_kernel<WT>, tx, tw, a);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw,
                 const wgmma_path::WArgs& p, cudaStream_t st) {
  static bool opted_in = false;
  static int sms = 0;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgmma_path::wgmma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, wgmma_path::kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int rc = sm_count(sms);
  if (rc != 0) return rc;
  wgmma_path::wgmma_kernel<<<sms, wgmma_path::kThreads, wgmma_path::kSmem,
                             st>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 bodies' shape: out = {chunk rows, columns a unit or item, K
// tile, stages, threads a block, shared-memory bytes a block}; body 1 the
// stream body (w_dtype 1 bf16, 2 int8), body 2 the wgmma body (bf16).
// kernels/moe_gemm.py's STREAM and WGMMA mirror the first four. Returns 0,
// or cudaErrorInvalidValue for another body or weight dtype.
extern "C" int grouped_matmul_shape(int body, int w_dtype, int* out) {
  if (body == 1 && (w_dtype == kBF16 || w_dtype == kI8)) {
    const bool b16 = w_dtype == kBF16;
    out[0] = stream_path::kRows;
    out[1] = b16 ? stream_path::Ring<__nv_bfloat16>::kCols
                 : stream_path::Ring<int8_t>::kCols;
    out[2] = kBK;
    out[3] = b16 ? stream_path::Ring<__nv_bfloat16>::kStages
                 : stream_path::Ring<int8_t>::kStages;
    out[4] = b16 ? stream_path::Ring<__nv_bfloat16>::kThreads
                 : stream_path::Ring<int8_t>::kThreads;
    out[5] = b16 ? stream_path::Ring<__nv_bfloat16>::kSmem
                 : stream_path::Ring<int8_t>::kSmem;
    return 0;
  }
  if (body == 2 && w_dtype == kBF16) {
    out[0] = wgmma_path::kBM;
    out[1] = wgmma_path::kBN;
    out[2] = kBK;
    out[3] = wgmma_path::kStages;
    out[4] = wgmma_path::kThreads;
    out[5] = wgmma_path::kSmem;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// The blocks a launch of body 1 (the stream body, at `splits` blocks a
// cluster and w_dtype 1 bf16 or 2 int8) or body 2 (the wgmma body) puts
// on the card: its persistent grid. Returns 0 or a cudaError_t.
extern "C" int grouped_matmul_grid(int body, int w_dtype, int splits,
                                   int* blocks) {
  if (body == 1 && (w_dtype == kBF16 || w_dtype == kI8)) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    const int rc = w_dtype == kBF16
                       ? stream_config<__nv_bfloat16>(splits, cfg, attr)
                       : stream_config<int8_t>(splits, cfg, attr);
    if (rc == 0) *blocks = (int)cfg.gridDim.x;
    return rc;
  }
  if (body == 2 && w_dtype == kBF16) {
    static int sms = 0;
    const int rc = sm_count(sms);
    if (rc == 0) *blocks = sms;
    return rc;
  }
  return (int)cudaErrorInvalidValue;
}

// Returns 0 or the cudaError_t of the launch. Device pointers to
// contiguous tensors: x (M, D) of x_dtype (0 f32, 1 bf16) with row stride
// ldx; w (E, D, F) of w_dtype (x_dtype or 2 int8) with row stride ldw;
// group_ids (nb,) int32 with M % nb == 0; w_scale (E,) f32 or null; out
// (M, F) of x_dtype. `body` and its shape come from the host's plan
// (moe_gemm.py::grouped_plan) and are checked against the build: 0 the f32
// body (ldx == D, ldw == F, no scratch); 1 the stream body (f_tile 128,
// `splits` in 1, 2, 4, 8, the built stages); 2 the wgmma body (bf16
// weights, f_tile 256, one split, the built stages). The bf16 bodies take
// 16-byte rows (ldx * 2 and ldw * sizeof(w) multiples of 16, 16-byte-
// aligned x and w) and `scratch` of at least grouped_scratch_ints(M, nb,
// chunk rows) int32. Asynchronous on `stream`: a table kernel, then the
// body; allocates nothing.
extern "C" int grouped_matmul(int x_dtype, int w_dtype, const void* x,
                              const void* w, const void* group_ids,
                              const void* w_scale, void* out, void* scratch,
                              long long scratch_ints, int M, int D, int E,
                              int F, int nb, int ldx, int ldw, int body,
                              int f_tile, int splits, int stages,
                              void* stream) {
  if (M <= 0 || nb <= 0 || M % nb != 0 || D <= 0 || E <= 0 || F <= 0 ||
      ldx < D || ldw < F)
    return (int)cudaErrorInvalidValue;
  if (w_dtype != x_dtype && w_dtype != kI8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32) {
    if (body != 0 || ldx != D || ldw != F || (F + kBN - 1) / kBN > 65535)
      return (int)cudaErrorInvalidValue;
    const int we = w_dtype == kF32 ? 4 : 1;
    Args a;
    a.x = x;
    a.w = w;
    a.gids = static_cast<const int*>(group_ids);
    a.scale = static_cast<const float*>(w_scale);
    a.out = out;
    a.M = M; a.D = D; a.E = E; a.F = F; a.nb = nb; a.bm = M / nb;
    a.vec_x = (D * 4) % 16 == 0 && aligned16(x);
    a.vec_w = (F * we) % 16 == 0 && aligned16(w);
    if (w_dtype == kI8)
      return launch(fma_path::kernel<int8_t>, fma_path::SMEM, fma_path::MT,
                    a, st);
    return launch(fma_path::kernel<float>, fma_path::SMEM, fma_path::MT, a,
                  st);
  }
  if (x_dtype != kBF16) return (int)cudaErrorInvalidValue;
  int shape[6];
  if (grouped_matmul_shape(body, w_dtype, shape) != 0 || f_tile != shape[1] ||
      stages != shape[3] ||
      !(splits == 1 || (body == 1 && (splits == 2 || splits == 4 ||
                                      splits == 8))))
    return (int)cudaErrorInvalidValue;
  const int es = w_dtype == kBF16 ? 2 : 1;
  if ((ldx * 2) % 16 != 0 || (ldw * es) % 16 != 0 || !aligned16(x) ||
      !aligned16(w) || scratch == nullptr ||
      scratch_ints < grouped_scratch_ints(M, nb, shape[0]))
    return (int)cudaErrorInvalidValue;

  // the chunk lists: counts, then live and zero chunks (int4), then the
  // run table
  const long long cap = grouped_chunk_cap(M, nb, shape[0]);
  int4* t4 = static_cast<int4*>(scratch);
  TArgs ta;
  ta.gids = static_cast<const int*>(group_ids);
  ta.nb = nb; ta.bm = M / nb; ta.E = E; ta.ch = shape[0];
  ta.counts = reinterpret_cast<int*>(t4);
  ta.live = t4 + 1;
  ta.zero = t4 + 1 + cap;
  ta.run_start = reinterpret_cast<int*>(t4 + 1 + 2 * cap);
  ta.run_g = ta.run_start + nb + 1;
  table_kernel<<<1, kTableThreads, 0, st>>>(ta);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Table tab = {ta.live, ta.zero, ta.counts};

  CUtensorMap tx, tw;
  if (!x_map(&tx, x, M, D, ldx, body == 1 ? stream_path::kXBox
                                          : wgmma_path::kBM) ||
      !w_map(&tw, w, E, D, F, ldw, es))
    return (int)cudaErrorInvalidValue;
  const int vec = F % 8 == 0 && aligned16(out);
  const int nk = (D + kBK - 1) / kBK;
  if (body == 1) {
    stream_path::SArgs a;
    a.t = tab;
    a.scale = static_cast<const float*>(w_scale);
    a.out = static_cast<__nv_bfloat16*>(out);
    a.F = F; a.nk = nk; a.tiles_f = (F + f_tile - 1) / f_tile;
    a.splits = splits; a.vec = vec;
    if (w_dtype == kI8) return launch_stream<int8_t>(tx, tw, a, st);
    return launch_stream<__nv_bfloat16>(tx, tw, a, st);
  }
  wgmma_path::WArgs p;
  p.t = tab;
  p.scale = static_cast<const float*>(w_scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.F = F; p.tiles_n = (F + f_tile - 1) / f_tile; p.n_k = nk; p.vec = vec;
  return launch_wgmma(tx, tw, p, st);
}

// The int32 scratch a bf16 call needs at chunk rows ch (64: the stream
// body; 128: the wgmma body).
extern "C" long long grouped_matmul_scratch(int M, int nb, int ch) {
  if (M <= 0 || nb <= 0 || ch <= 0) return -1;
  return grouped_scratch_ints(M, nb, ch);
}
