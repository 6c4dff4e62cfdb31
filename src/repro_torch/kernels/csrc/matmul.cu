// Tiled matrix product for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py (matmul /
// _matmul_kernel): out = a @ b for a (M, K) and b (K, N), row-major, products
// and sums in fp32, the result cast to the output dtype (f32 or bf16) once,
// at the end. The contract is kernels/ref.py::matmul_ref, an fp32 dot of the
// inputs' values. The Pallas kernel needed its 256/256/512 blocks to divide
// the operands (a TPU tiling rule); this one takes any M, N, K: elements past
// an edge load as zeros, which add exactly nothing to a sum, and outputs past
// an edge are not written.
//
// Bound on an H100: operations for the shapes the port runs. The startup
// self-test's 128^3 f32 products do 2 * 128^3 flops on 192 KB (~3.2e-5 ms at
// 67 TFLOP/s, ~6e-5 ms at 3.35 TB/s: bytes); qwen2-0.5B's MLP up projection of
// a 4096-token prefill, (4096, 896) x (896, 4864) in bf16, does 3.6e10 flops
// on 53 MB, 0.036 ms at 989 TFLOP/s against 0.016 ms of bytes.
//
// bf16 design (warpgroup MMA over a TMA ring, persistent blocks):
//   * one block an SM (at most one a tile) walks 128 x 256 output tiles in a
//     fixed grouped order: tile t of the block is blockIdx.x + t * gridDim.x,
//     and tiles are numbered down groups of 8 tile rows (kGroupM), so that
//     the blocks running at once share A and B panels in L2
//     (matmul.py::tile_walk mirrors it);
//   * 288 threads: two consumer warpgroups of 64 output rows each and one
//     producer warp, whose one thread issues the TMA loads. Every consumer
//     thread releases a slot (an arrival on its empty barrier), so no path
//     between two products diverges (with the loads issued by thread 0 of
//     a consumer warpgroup, ptxas serialized every wgmma: C7518). A block
//     of 9 warps caps ptxas at 168 registers a thread, which the 128 fp32
//     accumulators fit without a spill;
//   * K is walked in tiles of 64 (one 128-byte panel of bf16) through a ring
//     of kStages = 4 stages with full (TMA bytes) and empty (256 consumer
//     arrivals) mbarriers. A stage is an A tile (128 x 64, K-major) and a B
//     tile (64 x 256) as four 64-column panels, both in the 128-byte swizzle
//     that wgmma reads. The ring runs on across tiles, so the next tile's
//     first loads are in flight under this tile's epilogue. TMA reads zeros
//     past M, N and K, so ragged edges need no masking in the main loop;
//   * products: wgmma.mma_async m64n256k16 with both operands in shared
//     memory; A through a K-major descriptor, B (K, N) row-major through an
//     MN-major (transposed) one. The accumulators are fp32 (bf16 products
//     are exact in fp32), never TF32;
//   * epilogue: the accumulators are cast once to the output dtype and
//     stored straight from registers as 16-byte stores: one shuffle between
//     neighbouring lanes gives each lane four consecutive f32 columns of one
//     row, a second one eight consecutive bf16 columns; outputs past an edge
//     (or rows of a width that is not a multiple of 4 or 8) take scalar
//     stores;
//   * TMA needs 16-byte row strides: the wrapper pads a zeroed copy of an
//     operand whose row is not a multiple of 8 elements (matmul.py);
//   * no split of K and no atomics: every output is summed over K in one
//     fixed order, so a call is bit-reproducible.
//
// f32 design: CUDA-core fmaf only, never TF32 (the reference's f32 dot keeps
// 24 mantissa bits; TF32 keeps 11 and fails its 1e-5 tolerance at K >= 512):
// a block of 256 threads owns a 64 x 64 tile and walks K in tiles of 16; each
// thread keeps a 4 x 4 register block of outputs; no split of K and no
// atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {  // the f32 body's
  const void* a;
  const void* b;
  void* out;
  int M, N, K;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// ---------------------------------------------------------------------------
// bf16: wgmma over a TMA ring
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 256, kBK = 64;  // block tile; K tile of a stage
constexpr int kStages = 4;
constexpr int kGroupM = 8;     // tile rows of a raster group
constexpr int kThreads = 288;  // two consumer warpgroups + a producer warp
constexpr int kPanel = 64;     // bf16 columns of a 128-byte swizzled panel
constexpr int kABytes = kBM * kBK * 2;  // 16 KB
constexpr int kBBytes = kBK * kBN * 2;  // 32 KB: kBN / kPanel panels
constexpr int kStageBytes = kABytes + kBBytes;
// 1024: the swizzled tiles need a 1024-byte-aligned base
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr size_t kSmemMax = 232448;  // an H100 block's opt-in maximum
static_assert((size_t)kSmem <= kSmemMax, "ring above shared memory");

struct MArgs {
  void* out;
  int M, N, K;
  int tiles_m, tiles_n, n_k;
  int vec;  // the output's rows take 16-byte stores (N % 8 == 0 for bf16,
            // N % 4 == 0 for f32, an aligned base)
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

// One box of a 2D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
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

// The tile at position t of the walk: tile rows in groups of kGroupM, each
// group walked column by column (matmul.py::tile_walk mirrors it).
__device__ __forceinline__ void tile_coords(const MArgs& p, int t, int& tm,
                                            int& tn) {
  const int per_group = kGroupM * p.tiles_n;
  const int first = t / per_group * kGroupM;
  const int rows = min(p.tiles_m - first, kGroupM);
  const int r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

__device__ __forceinline__ void store_tile(const MArgs& p, float* out,
                                           const float (&acc)[128], int row0,
                                           int col0, int lane) {
  const bool odd = lane & 1;
  const int row = row0 + (odd ? 8 : 0);
  const int cq = col0 + 4 * ((lane & 3) >> 1);
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c) {
    const float4 v = quad_row4(acc, c, odd);
    const int col = cq + 8 * c;
    if (row >= p.M || col >= p.N) continue;
    float* dst = out + (size_t)row * p.N + col;
    if (p.vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < p.N) dst[j] = e[j];
    }
  }
}

// bf16: after quad_row4, lanes t and t ^ 2 trade the halves of chunks c and
// c + 1, so a lane with t % 4 < 2 holds 8 columns of chunk c and one with
// t % 4 >= 2 those of chunk c + 1.
__device__ __forceinline__ void store_tile(const MArgs& p,
                                           __nv_bfloat16* out,
                                           const float (&acc)[128], int row0,
                                           int col0, int lane) {
  const bool odd = lane & 1, hi = lane & 2;
  const int row = row0 + (odd ? 8 : 0);
#pragma unroll
  for (int c = 0; c < kBN / 8; c += 2) {
    const float4 a = quad_row4(acc, c, odd);
    const float4 b = quad_row4(acc, c + 1, odd);
    const uint32_t a0 = pack_bf16(a.x, a.y), a1 = pack_bf16(a.z, a.w);
    const uint32_t b0 = pack_bf16(b.x, b.y), b1 = pack_bf16(b.z, b.w);
    const uint32_t s0 = __shfl_xor_sync(0xffffffffu, hi ? a0 : b0, 2);
    const uint32_t s1 = __shfl_xor_sync(0xffffffffu, hi ? a1 : b1, 2);
    const uint4 v = hi ? make_uint4(s0, s1, b0, b1) : make_uint4(a0, a1, s0, s1);
    const int col = col0 + 8 * (c + (hi ? 1 : 0));
    if (row >= p.M || col >= p.N) continue;
    __nv_bfloat16* dst = out + (size_t)row * p.N + col;
    if (p.vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col + j < p.N) dst[j] = e[j];
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const MArgs p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int warp = (threadIdx.x & 127) >> 5;
  if (threadIdx.x == 0) {
    prefetch_map(&ta);
    prefetch_map(&tb);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = p.tiles_m * p.tiles_n;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  if (wg == 2) {
    // the producer: K tile j of this block's walk goes to slot j % kStages
    // once all 256 consumer threads released the slot's use j - kStages
    if (threadIdx.x != 256) return;
    const long long total = (long long)mine * p.n_k;
    for (long long j = 0; j < total; ++j) {
      const int s = (int)(j % kStages);
      if (j >= kStages) mbar_wait(empty + s, (int)((j / kStages - 1) & 1));
      int tm, tn;
      tile_coords(p, (int)blockIdx.x + (int)(j / p.n_k) * (int)gridDim.x,
                  tm, tn);
      const int k0 = (int)(j % p.n_k) * kBK;
      uint8_t* st = ring + s * kStageBytes;
      mbar_expect_tx(full + s, kStageBytes);
      tma_load(st, &ta, full + s, k0, tm * kBM);
#pragma unroll
      for (int q = 0; q < kBN / kPanel; ++q)
        tma_load(st + kABytes + q * kBK * 128, &tb, full + s,
                 tn * kBN + q * kPanel, k0);
    }
    return;
  }

  // a consumer warpgroup: 64 rows of each tile; every thread releases a
  // slot, so no path between two products diverges (ptxas serializes
  // wgmma around a divergent one)
  long long g = 0;  // K tiles consumed
  for (int i = 0; i < mine; ++i) {
    int tm, tn;
    tile_coords(p, (int)blockIdx.x + i * (int)gridDim.x, tm, tn);
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
    store_tile(p, static_cast<OutT*>(p.out), acc,
               tm * kBM + wg * 64 + warp * 16 + (lane >> 2),
               tn * kBN, lane);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, a 4 x 4 register block per thread
// ---------------------------------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;

template <typename OutT>
__global__ void __launch_bounds__(256) matmul_f32_kernel(const Args p) {
  __shared__ float as[kFK][kFM + 1];  // A transposed: k-major
  __shared__ float bs[kFK][kFN];

  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // this thread's outputs: rows m0 + ty + 16 i, columns n0 + tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kFK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kFM * kFK; i += blockDim.x) {
      const int r = i / kFK, c = i % kFK;
      const int row = m0 + r, col = k0 + c;
      as[c][r] = (row < p.M && col < p.K) ? a[(size_t)row * p.K + col] : 0.f;
    }
    for (int i = tid; i < kFK * kFN; i += blockDim.x) {
      const int r = i / kFN, c = i % kFN;
      const int row = k0 + r, col = n0 + c;
      bs[r][c] = (row < p.K && col < p.N) ? b[(size_t)row * p.N + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < p.M && col < p.N)
        store(out + (size_t)row * p.N + col, acc[i][j]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kern, const Args& p, int bm, int bn, cudaStream_t s) {
  const dim3 grid((p.N + bn - 1) / bn, (p.M + bm - 1) / bm);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
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

// A 2D map over a bf16 (rows, cols) matrix with row stride ld elements,
// boxes of (kPanel columns, box_rows rows), 128-byte swizzle, zeros out of
// range.
bool tensor_map(CUtensorMap* map, const void* ptr, int cols, int rows, int ld,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
int launch_wgmma(MArgs p, const void* a, int lda, const void* b, int ldb,
                 cudaStream_t s) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_wgmma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  CUtensorMap ta, tb;
  if (p.K > 0) {
    if (!tensor_map(&ta, a, p.K, p.M, lda, kBM) ||
        !tensor_map(&tb, b, p.N, p.K, ldb, kBK))
      return (int)cudaErrorInvalidValue;
  } else {  // no K tile: the maps are never read
    ta = CUtensorMap{};
    tb = CUtensorMap{};
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  p.tiles_m = (p.M + kBM - 1) / kBM;
  p.tiles_n = (p.N + kBN - 1) / kBN;
  p.n_k = (p.K + kBK - 1) / kBK;
  const long long tiles = (long long)p.tiles_m * p.tiles_n;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  matmul_wgmma_kernel<OutT><<<grid, kThreads, kSmem, s>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or the cudaError_t of the launch. a (M, K) and b (K, N) are
// device pointers to row-major matrices of `in_dtype` with row strides lda
// and ldb elements, out (M, N) of `out_dtype` (0 f32, 1 bf16), contiguous.
// f32 inputs: lda == K and ldb == N. bf16 inputs: lda and ldb multiples of 8
// (16-byte rows, for TMA) and 16-byte-aligned bases. K may be 0 (out is
// zeros). Asynchronous on `stream`.
extern "C" int matmul(int in_dtype, int out_dtype, const void* a,
                      const void* b, void* out, int M, int N, int K, int lda,
                      int ldb, void* stream) {
  if (M < 0 || N < 0 || K < 0 || lda < K || ldb < N)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kBF16) {
    const uintptr_t misaligned = reinterpret_cast<uintptr_t>(a) |
                                 reinterpret_cast<uintptr_t>(b);
    if (lda % 8 != 0 || ldb % 8 != 0 || misaligned % 16 != 0)
      return (int)cudaErrorInvalidValue;
    MArgs p;
    p.out = out;
    p.M = M;
    p.N = N;
    p.K = K;
    p.vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
            N % (out_dtype == kF32 ? 4 : 8) == 0;
    if (out_dtype == kF32) return launch_wgmma<float>(p, a, lda, b, ldb, s);
    if (out_dtype == kBF16)
      return launch_wgmma<__nv_bfloat16>(p, a, lda, b, ldb, s);
    return (int)cudaErrorInvalidValue;
  }
  if (in_dtype != kF32 || lda != K || ldb != N)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  if (out_dtype == kF32)
    return launch(matmul_f32_kernel<float>, p, kFM, kFN, s);
  if (out_dtype == kBF16)
    return launch(matmul_f32_kernel<__nv_bfloat16>, p, kFM, kFN, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 body's shape: out = {tile rows, tile columns, K tile, stages,
// tile rows of a raster group, shared-memory bytes of a block}
// (matmul.py::BF16_TILE mirrors the first five).
extern "C" void matmul_bf16_tile(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kBK;
  out[3] = kStages;
  out[4] = kGroupM;
  out[5] = kSmem;
}
