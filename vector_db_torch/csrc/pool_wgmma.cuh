// The tensor-core scan + strided-bucket min pool of the port, for NVIDIA
// Hopper (sm_90a): one warp-specialised wgmma tile loop that serves six
// kernels through its element type, its producer and its pass epilogue:
//
//   bf16 m64n128k16 -> f32   B6 fused_raw_pool.cu (rows by TMA),
//                            B5 fused_adc_pool.cu (rows decoded from PQ codes);
//   s8 m64n128k32 -> s32     B2, B4, B7 fused_int8_pool.cu (rows by TMA, or by
//                            cp.async where not whole 16-byte vectors),
//                            B8 fused_ivf_pool.cu (the same two producers over
//                            one cluster's buckets; its own kernel around the
//                            loop's pieces: ring_init, load_query_tile, the
//                            producers and consume, with the winners of each
//                            bucket picked in the pass epilogue).
//
// One kernel template, `pool_kernel<Op>`, computes for queries q [Q, d] and
// the N corpus rows that `Op` produces into shared memory:
//
//   vals[q, c]  = min over passes j of Op::score(q . v_{c + j*W}, c0, c1, r_q)
//                 (strict <: the earliest pass wins a tie),
//   slots[q, c] = its slot; Op::init() / -1 where empty,
//
// c0, c1 the two per-slot values Op::col_values gives (B6: off, sc; B5: the
// masked norm; B2/B4: off, sc; B7: off_i as the bits of a float) and r_q
// the per-query value Op::row_value gives (B2/B4: the query scale sq).  The
// products are exact (bf16 x bf16 in f32, s8 x s8 in s32); the bf16 sums
// are f32 in the tensor cores' order, the s8 sums exact s32.  This is the
// TPU kernels' `_pool_accumulate` (pallas_kernels.py:375-397) and
// `_pool_accumulate_i32` (:674-694): the TPU grid's sequential pass axis is
// a loop inside each block, because Hopper runs blocks in parallel and in
// no order.
//
// The block (384 threads) is warp-specialised:
//   * warpgroup 0, the producer (setmaxnreg down to kProducerRegs), loads
//     the block's 128-query tile once by TMA and then fills a ring of
//     `stages` corpus k-chunks, each [128 columns x 128 bytes] (64 bf16 or
//     128 int8 dims, 16 KB), with full/empty mbarriers; its warp 0 also
//     stages each pass's 128 per-column values in a double buffer;
//   * warpgroups 1 and 2, the consumers (setmaxnreg up to kConsumerRegs),
//     own 64 query rows each and run wgmma.mma_async over the k-chunks of a
//     pass, four 32-byte k-steps a chunk, releasing each stage after its
//     wgmma.wait_group; after a pass's last k-chunk they apply the pool
//     compare to the accumulators in registers while the producer already
//     fills the next pass's stages.  Each thread keeps 64 accumulators and
//     the running (value, pass) minimum of its 64 entries; the slot,
//     p*W + column, is rebuilt at the end.  In the s8 pools, where the
//     ring holds a whole pass, the two consumers take turns at the tensor
//     cores, a pass each, so one's epilogue overlaps the other's products.
// Every tile is in the 128-byte swizzled layout that both TMA and the wgmma
// descriptors use (16-byte granule c of row r at granule c ^ (r % 8)); both
// operands are K-major, as the s8 wgmma requires; the ragged edges are
// zeros: TMA fills rows past Q or N and bytes past the row, the other
// producers write zeros there, and a slot past N never wins through its
// per-column values.  When the query x column tiles alone cannot fill the
// card, the passes are split over gridDim.z into partial pools that
// pool::merge_splits_kernel merges in pass order, which keeps the
// earliest-pass tie rule.
//
// Shared memory (232,448 bytes a block), in one of two layouts chosen by
// the caller (ops/kernels.wgmma_plan mirrors this arithmetic):
//   * resident: the whole query tile (ceil(row bytes / 128) k-chunks of 16
//     KB) stays for the block's life beside `stages` corpus stages of 16 KB:
//     while the tile and at least kMinStages stages fit (bf16 rows up to 640
//     dims, s8 rows up to 1280);
//   * streamed: past that, each ring stage of 32 KB carries its k-chunk's
//     query slab beside its corpus slab (the query slab by one TMA on the
//     stage's full barrier) and the consumers' A descriptor points into the
//     stage, so any row width fits; the query slabs are then read again for
//     every pass.
// Besides: 2 KB of per-column values, the barriers, and 1 KB to align the
// tiles to the 1024-byte swizzle atom.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace pool {

constexpr int kMaxSmem = 232448;  // dynamic shared memory of one H100 block

// Merge the per-split partial pools (blocks that split one tile's passes,
// gridDim.z) in split (= pass) order with strict <, so a tie keeps the
// earlier pass exactly as the single-block loop would (the TPU kernels'
// `_pool_accumulate`, pallas_kernels.py:375-397).
template <typename Val>
__global__ void merge_splits_kernel(const Val* __restrict__ part_vals,
                                    const int32_t* __restrict__ part_slots,
                                    Val* __restrict__ vals,
                                    int32_t* __restrict__ slots, long long qw,
                                    int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= qw) return;
  Val bv = part_vals[i];
  int32_t bs = part_slots[i];
  for (int z = 1; z < splits; ++z) {
    const Val v = part_vals[z * qw + i];
    if (v < bv) {
      bv = v;
      bs = part_slots[z * qw + i];
    }
  }
  vals[i] = bv;
  slots[i] = bs;
}

}  // namespace pool

namespace wg {

constexpr int kTQ = 128;        // query rows per block: two consumers x m64
constexpr int kTN = 128;        // pool columns per block (the wgmma n)
constexpr int kRowBytes = 128;  // bytes per k-chunk row: one swizzle row
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kChunkBytes = kTN * kRowBytes;  // one k-chunk of 128 rows
constexpr int kMaxStages = 12;
// B5's decode and the cp.async producer hand a stage over once the next
// one's copies started and the consumers release a stage once the next
// one's products started: with two stages each would wait for the other
constexpr int kMinStages = 3;
constexpr int kColBytes = 2 * 2 * kTN * 4;  // [2 buffers][c0, c1][128] f32
constexpr int kBarBytes = 256;              // the mbarriers
constexpr int kAlign = 1024;                // the 128-byte swizzle atom
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;          // 128 * 56 + 256 * 224 <= 65536
// a return code past every cudaError_t: the tensor map could not be made
constexpr int kTensorMapError = 20000;

// ------------------------------------------------------------ PTX wrappers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void arrive_expect_tx(uint32_t bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Raise the barrier's expected transaction bytes without an arrival.
__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed (a
// fresh barrier counts its phase of parity 1 as completed).  No exit path
// (a __trap watchdog) may sit in this loop: ptxas then ignores setmaxnreg
// (the consumers spill at the launch's 168 registers) and serializes the
// wgmmas.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of one [128 rows x 128 bytes] box at (x = element, y = row)
// into shared memory, completing its bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// Named barrier `id` over `n` threads: wait for it, or only arrive.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzled layout: start address >> 4, leading offset 16 B (unused when
// swizzled), stride 1024 B between 8-row groups, layout 1 = SWIZZLE_128B.
// A 32-byte k-step inside the 128-byte row adds 32 to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it cannot see that wgmma.wait_group writes them).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The two element types.  D (+)= A * B for A [64 x k] and B [k x 128] from
// shared memory (both K-major; one 32-byte k-step: k16 bf16 or k32 s8);
// scale_d == 0 overwrites D.  Thread l of warp w holds D[16 w + l/4 + 8 h]
// [8 j + 2 (l % 4) + e] in d[4 j + 2 h + e], for either type.
#define WG_D64(c)                                                           \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),   \
  c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),       \
  c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),     \
  c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),     \
  c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]), c(d[34]), c(d[35]),     \
  c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]), c(d[42]),     \
  c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),     \
  c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]),     \
  c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define WG_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                       \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                                \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                                \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                                \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                                \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                                \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "
#define WG_F(x) "+f"(x)
#define WG_R(x) "+r"(x)

struct Bf16Mma {
  using Acc = float;
  static constexpr int kDims = 64;  // dims of one k-chunk row
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kElemBytes = 2;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : WG_D64(WG_F)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

struct S8Mma {
  using Acc = int32_t;
  static constexpr int kDims = 128;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kElemBytes = 1;
  __device__ __forceinline__ static void mma(int32_t (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_REGS64
        "%64, %65, p;\n"
        "}\n"
        : WG_D64(WG_R)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

#undef WG_D64
#undef WG_REGS64
#undef WG_F
#undef WG_R

// ------------------------------------------------------------ the block
// Shared-space addresses of one block's tiles and barriers.
struct Ring {
  uint32_t q;         // [kc_n][128 rows][128 B] the resident query tile
  uint32_t stage;     // [stages][stage_bytes] the ring
  uint32_t full;      // [kMaxStages] mbarriers: a stage was filled
  uint32_t empty;     // [kMaxStages] mbarriers: a stage was consumed
  uint32_t colfull;   // [2] the per-column values of a pass were staged
  uint32_t colempty;  // [2] ... and read
  uint32_t qbar;      // the resident query tile arrived
  float* cols;        // [2][2][128] the per-column values (generic pointer)
  const CUtensorMap* qmap;  // the queries (streamed mode reads them per stage)
  int stages, kc_n, q0;
  uint32_t stage_bytes;  // kChunkBytes, or twice that when streamed
  bool streamed;
};

// The corpus slab of stage s; in streamed mode its query slab follows it.
__device__ __forceinline__ uint32_t slab(const Ring& r, int s) {
  return r.stage + s * r.stage_bytes;
}

// Streamed mode, one producer thread: the query slab of k-chunk kc into
// stage s by TMA, counted on the stage's full barrier (expected first).
template <int kDims>
__device__ __forceinline__ void stream_query(const Ring& r, int s, int kc) {
  if (!r.streamed) return;
  expect_tx(r.full + 8 * s, kChunkBytes);
  tma_load(slab(r, s) + kChunkBytes, r.qmap, r.full + 8 * s, kDims * kc,
           r.q0);
}

// A stage's generic-proxy copies (cp.async) are complete in this thread:
// make them visible to the async proxy (wgmma), then one arrival per warp.
__device__ __forceinline__ void hand_over(const Ring& r, int s, int lane) {
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) arrive(r.full + 8 * s);
}

// The per-column values of slots row0 + lane + 32 i (i < 4), loaded by the
// producer's warp 0 at a pass's first k-chunk ...
template <class Op>
__device__ __forceinline__ void col_load(const Op& op, long long row0, int N,
                                         int lane, float (&v0)[4],
                                         float (&v1)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) op.col_values(row0 + lane + 32 * i, N, v0[i],
                                            v1[i]);
}

// ... and stored at its last, once the consumers have read the buffer's
// previous pass (pass `pl` of the block uses buffer pl % 2).
__device__ __forceinline__ void col_store(const Ring& r, int pl, int lane,
                                          const float (&v0)[4],
                                          const float (&v1)[4]) {
  const int b = pl & 1;
  wait(r.colempty + 8 * b, ((pl >> 1) & 1) ^ 1);
  float* c = r.cols + 2 * kTN * b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[lane + 32 * i] = v0[i];
    c[kTN + lane + 32 * i] = v1[i];
  }
  __syncwarp();
  if (lane == 0) arrive(r.colfull + 8 * b);
}

// The TMA producer (B6, and the s8 pools over rows of whole 16-byte
// vectors): warp 0 starts one TMA per stage (two when streamed) and stages
// each pass's per-column values; the other three warps exit at once.
template <class Op>
__device__ __forceinline__ void produce_tma(const Op& op, const Ring& r,
                                            const CUtensorMap* rmap, int N,
                                            int W, int c0, int p_begin,
                                            int p_end) {
  constexpr int kDims = Op::Mma::kDims;
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) != 0) return;
  int s = 0;
  uint32_t ph = 0;
  for (int p = p_begin; p < p_end; ++p) {
    const long long row0 = (long long)p * W + c0;
    float v0[4], v1[4];
    col_load(op, row0, N, lane, v0, v1);
    for (int kc = 0; kc < r.kc_n; ++kc) {
      wait(r.empty + 8 * s, ph ^ 1);
      if (lane == 0) {
        const uint32_t full = r.full + 8 * s;
        arrive_expect_tx(full, r.stage_bytes);
        tma_load(slab(r, s), rmap, full, kDims * kc, (int)row0);
        if (r.streamed)
          tma_load(slab(r, s) + kChunkBytes, r.qmap, full, kDims * kc, r.q0);
      }
      if (kc == r.kc_n - 1) col_store(r, p - p_begin, lane, v0, v1);
      if (++s == r.stages) {
        s = 0;
        ph ^= 1;
      }
    }
  }
}

// Rows of whole, 16-byte aligned vectors: one TMA per stage.  `Epi` gives
// the element type (Mma) and the per-column values.
template <class Epi>
struct TmaRows : Epi {
  static constexpr int kFullArrivals = 1;  // the TMA thread's expect_tx
  __device__ __forceinline__ void produce(const Ring& r,
                                          const CUtensorMap* rmap, int N,
                                          int W, int c0, int p_begin,
                                          int p_end) const {
    produce_tma(*this, r, rmap, N, W, c0, p_begin, p_end);
  }
};

// Copy 4 bytes global -> shared, or write 4 zero bytes when bytes == 0.
__device__ __forceinline__ void copy4(uint32_t dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// s8 rows of d bytes (d % 4 == 0, 4-byte aligned): all four producer warps
// copy each stage by 4-byte cp.async, and a stage is handed over once the
// next one's copies started (two stages of copies in flight a thread).
template <class Epi>
struct CopyRows : Epi {
  static constexpr int kFullArrivals = 4;  // one per producer warp
  const uint8_t* rows;
  int d;

  // k-chunk kc of slots row0 .. row0 + 127 into the slab: warp u copies
  // rows u, u + 4, ..., lane l the row's bytes 4l .. 4l + 3 of the chunk,
  // at r*128 + ((l/4) ^ (r%8))*16 + (l%4)*4, the 128-byte swizzle of the
  // wgmma descriptors; zeros past d and past N.
  __device__ __forceinline__ void copy_chunk(uint32_t slab, long long row0,
                                             int kc, int N, int warp,
                                             int lane) const {
    const int byte = kRowBytes * kc + 4 * lane;
    const uint32_t col = (lane & 3) << 2;
#pragma unroll 4
    for (int r = warp; r < kTN; r += 4) {
      const bool ok = byte < d && row0 + r < N;
      const uint8_t* src = ok ? rows + (size_t)(row0 + r) * d + byte : rows;
      copy4(slab + r * kRowBytes + ((((lane >> 2) ^ (r & 7)) << 4) | col),
            src, ok ? 4 : 0);
    }
  }

  __device__ __forceinline__ void produce(const Ring& r, const CUtensorMap*,
                                          int N, int W, int c0, int p_begin,
                                          int p_end) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int total = (p_end - p_begin) * r.kc_n;
    if (total <= 0) return;
    float v0[4], v1[4];
    int kc = 0, pl = 0, s = 0;
    uint32_t ph = 0;
    long long row0 = (long long)p_begin * W + c0;
    for (int it = 0; it < total; ++it) {
      if (warp == 0 && kc == 0) col_load(*this, row0, N, lane, v0, v1);
      wait(r.empty + 8 * s, ph ^ 1);
      if (warp == 0 && lane == 0) stream_query<S8Mma::kDims>(r, s, kc);
      copy_chunk(slab(r, s), row0, kc, N, warp, lane);
      cp_async_commit();
      if (it > 0) {
        cp_async_wait<1>();
        hand_over(r, (it - 1) % r.stages, lane);
      }
      if (warp == 0 && kc == r.kc_n - 1) col_store(r, pl, lane, v0, v1);
      if (++s == r.stages) {
        s = 0;
        ph ^= 1;
      }
      if (++kc == r.kc_n) {
        kc = 0;
        row0 += W;
        ++pl;
      }
    }
    cp_async_wait<0>();
    hand_over(r, (total - 1) % r.stages, lane);
  }
};

// Carve the block's dynamic shared memory into the query tile (rows q0 ..
// q0 + 127 of the query map), the ring, the per-column buffers and the
// barriers (a stage's full barrier takes `full_arrivals` arrivals),
// initialise the barriers and synchronise the block.
__device__ __forceinline__ void ring_init(Ring& r, unsigned char* smem_raw,
                                          const CUtensorMap* qmap, int q0,
                                          int kc_n, int stages, int streamed,
                                          int full_arrivals) {
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  r.streamed = streamed != 0;
  r.stage_bytes = r.streamed ? 2 * kChunkBytes : kChunkBytes;
  r.q = base;
  r.stage = r.q + (r.streamed ? 0 : kc_n * kChunkBytes);
  const uint32_t cols = r.stage + stages * r.stage_bytes;
  r.cols = reinterpret_cast<float*>(smem_raw + (cols - raw));
  r.full = cols + kColBytes;
  r.empty = r.full + 8 * kMaxStages;
  r.colfull = r.empty + 8 * kMaxStages;
  r.colempty = r.colfull + 16;
  r.qbar = r.colempty + 16;
  r.qmap = qmap;
  r.stages = stages;
  r.kc_n = kc_n;
  r.q0 = q0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      bar_init(r.full + 8 * s, full_arrivals);
      bar_init(r.empty + 8 * s, 8);  // one per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      bar_init(r.colfull + 8 * b, 1);
      bar_init(r.colempty + 8 * b, 8);
    }
    bar_init(r.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's first thread: the resident query tile by TMA, counted on
// r.qbar (streamed: an arrival without bytes, so the consumers' wait
// passes).
template <class Mma>
__device__ __forceinline__ void load_query_tile(const Ring& r) {
  if (threadIdx.x != 0) return;
  arrive_expect_tx(r.qbar, r.streamed ? 0 : r.kc_n * kChunkBytes);
  if (!r.streamed)
    for (int kc = 0; kc < r.kc_n; ++kc)
      tma_load(r.q + kc * kChunkBytes, r.qmap, r.qbar, Mma::kDims * kc, r.q0);
}

// Consumer warpgroup cw (0 or 1: rows 64 cw .. 64 cw + 63 of the query
// tile) over the block's passes p_begin .. p_end - 1: a pass's products
// into `acc` (kMma) or, for a warpgroup whose rows are all dead, only the
// protocol; then, once the pass's per-column values are staged,
// `pass_end(p, cv)` on the accumulators in registers (kMma only; cv
// [2][128] the pass's two per-column values).  Two instances and no runtime
// branch around the wgmmas, so no path joins another while a wgmma group is
// in flight (ptxas would wait for the group there: advisory C7517).
//
// The s8 pools, where the ring holds a whole pass and one stage more: the
// two warpgroups take turns at the tensor cores, a pass each, so one's
// epilogue overlaps the other's products (6% at B2's main shape,
// chip_smoke.py's stage sweep on an H100): warpgroup cw waits for its turn
// (named barrier 1 + cw over both warpgroups' 256 threads) before a pass's
// products and hands the turn over after them; warpgroup 0 takes the
// first.  With a shallower ring warpgroup 0 could not finish a pass before
// warpgroup 1 freed its first stages (the producers hand a stage over up to
// one chunk late), so the two go in step; so do the bf16 pools, whose four
// stages hold a pass only below 256 dims (and whose consumers would spill
// with the turns).
template <class Mma, bool kMma, class PassEnd>
__device__ __forceinline__ void consume(const Ring& r, int cw, int p_begin,
                                        int p_end,
                                        typename Mma::Acc (&acc)[64],
                                        PassEnd&& pass_end) {
  const int lane = threadIdx.x & 31;
  const int stages = r.stages;
  const int kc_n = r.kc_n;
  // the warpgroup's 64 rows in a query k-chunk
  const uint32_t a_off = cw * (kChunkBytes / 2);
  auto release = [&](uint32_t bar) {  // one arrival per warp
    __syncwarp();
    if (lane == 0) arrive(bar);
  };
  const bool turns = std::is_same<Mma, S8Mma>::value && stages >= kc_n + 1;
  wait(r.qbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int p = p_begin; p < p_end; ++p) {
    if (turns && (cw == 1 || p > p_begin)) named_sync(1 + cw, 2 * kTQ);
    // one wgmma group stays in flight: stage k is released once stage
    // k+1's products started, the pass's last stage after all finish
    int prev = -1;
    for (int kc = 0; kc < kc_n; ++kc) {
      wait(r.full + 8 * s, ph);
      if constexpr (kMma) {
        const uint32_t b = slab(r, s);
        const uint32_t a =
            (r.streamed ? b + kChunkBytes : r.q + kc * kChunkBytes) + a_off;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRowBytes / 32; ++kk)
          Mma::mma(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                   (kc | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
      }
      if (prev >= 0) release(r.empty + 8 * prev);
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    if constexpr (kMma) {
      wgmma_wait<0>();
      fence_acc(acc);
    }
    if (prev >= 0) release(r.empty + 8 * prev);
    if (turns && (cw == 0 || p + 1 < p_end)) named_arrive(2 - cw, 2 * kTQ);
    const int pl = p - p_begin;
    const int b = pl & 1;
    wait(r.colfull + 8 * b, (pl >> 1) & 1);
    if constexpr (kMma) pass_end(p, r.cols + 2 * kTN * b);
    __syncwarp();
    if (lane == 0) arrive(r.colempty + 8 * b);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(int32_t* p, int32_t a, int32_t b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
pool_kernel(const __grid_constant__ CUtensorMap qmap,  // the queries
            const __grid_constant__ CUtensorMap rmap,  // Op's rows, if by TMA
            const Op op,
            typename Op::Val* __restrict__ vals,  // [splits, Q, W]
            int32_t* __restrict__ slots,          // [splits, Q, W]
            int Q, int N, int W, int kc_n, int stages, int streamed,
            int passes, int passes_per_split) {
  using Mma = typename Op::Mma;
  using Acc = typename Mma::Acc;
  using Val = typename Op::Val;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.x * kTN;
  const int split = blockIdx.z;
  const int p_begin = split * passes_per_split;
  const int p_end = min(passes, p_begin + passes_per_split);
  Ring r;
  ring_init(r, smem_raw, &qmap, blockIdx.y * kTQ, kc_n, stages, streamed,
            Op::kFullArrivals);

  // the warpgroup's role, provably warp-uniform (a shuffle from lane 0), so
  // ptxas allocates each branch with its own setmaxnreg count
  const int role = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  if (role == 0) {
    // ---- producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    load_query_tile<Mma>(r);
    op.produce(r, &rmap, N, W, c0, p_begin, p_end);
  } else {
    // ---- consumer warpgroups: query rows q0 + 64 cw .. + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = role - 1;
    const int ct = threadIdx.x & 127;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_base = r.q0 + 64 * cw + 16 * (ct >> 5) + g;
    // a warpgroup whose 64 rows all lie past Q only keeps the protocol (the
    // flag shuffled from lane 0, provably uniform like the role)
    const bool active = __shfl_sync(0xffffffffu, r.q0 + 64 * cw < Q, 0);
    float rq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rq[h] = op.row_value(row_base + 8 * h, Q);
    Acc acc[64];
    Val best_v[64];
    int best_p[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0;
      best_v[i] = Op::init();
      best_p[i] = 0;
    }
    // the pool compare of a pass: the running (value, pass) minimum
    auto pass_end = [&](int p, const float* cv) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float o = cv[col];
          const float c = cv[kTN + col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const Val score = Op::score(acc[i], o, c, rq[h]);
            if (score < best_v[i]) {
              best_v[i] = score;
              best_p[i] = p;
            }
          }
        }
      }
    };
    if (active)
      consume<Mma, true>(r, cw, p_begin, p_end, acc, pass_end);
    else
      consume<Mma, false>(r, cw, p_begin, p_end, acc, pass_end);
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + 8 * h;
        if (row >= Q) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          const int i = 4 * j + 2 * h;
          const size_t o = ((size_t)split * Q + row) * W + col;
          const int s0 = Op::live(best_v[i])
                             ? (int)((long long)best_p[i] * W + col) : -1;
          const int s1 = Op::live(best_v[i + 1])
                             ? (int)((long long)best_p[i + 1] * W + col + 1)
                             : -1;
          store2(vals + o, best_v[i], best_v[i + 1]);
          store2(slots + o, s0, s1);
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side
// Shared memory of one block for kc_n query k-chunks and `stages` stages.
inline int smem_bytes(int kc_n, int stages, bool streamed) {
  const int chunks = streamed ? 2 * stages : kc_n + stages;
  return kAlign + chunks * kChunkBytes + kColBytes + kBarBytes;
}

// A 2-D tensor map over rows [rows, cols] of Mma's element type (row bytes
// a multiple of 16, base 16-byte aligned): [128 rows x 128 bytes] boxes,
// 128-byte swizzle, zeros out of bounds.  The driver's
// cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint, so the library links only the runtime.
template <class Mma>
int encode_rows(CUtensorMap* map, const void* base, long long rows,
                long long cols) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return kTensorMapError;
    encode = reinterpret_cast<Encode>(fn);
  }
  const long long row_bytes = cols * Mma::kElemBytes;
  if (rows <= 0 || cols <= 0 || row_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {Mma::kDims, kTQ};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map, Mma::kMapType, 2, const_cast<void*>(base), dims, strides, box,
      step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + (int)res;
}

// Host side of every entry point: the tensor maps (queries q [qn, q_cols]
// and, when `rows` is given, the corpus rows [n, d]), the pool kernel over
// d dims in the caller's layout (`stages` ring stages, resident or
// streamed query tile), then the split merge.  With splits == 1 the kernel
// writes vals/slots [qn, w] directly; otherwise part_vals/part_slots
// [splits, qn, w], which the merge kernel reduces into vals/slots.  Returns
// 0, a cudaError_t, or kTensorMapError + the driver's CUresult.
template <class Op>
int launch(const void* q, int q_cols, const void* rows, const Op& op,
           void* part_vals, void* part_slots, void* vals, void* slots, int qn,
           int n, int d, int w, int splits, int stages, int streamed,
           void* stream) {
  using Mma = typename Op::Mma;
  using Val = typename Op::Val;
  if (qn <= 0 || w <= 0 || d <= 0 || n < 0 || w % kTN != 0 || splits < 1 ||
      stages < kMinStages || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const int kc_n = (d + Mma::kDims - 1) / Mma::kDims;
  const int smem = smem_bytes(kc_n, stages, streamed != 0);
  if (smem > pool::kMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, rmap;
  int rc = encode_rows<Mma>(&qmap, q, qn, q_cols);
  if (rc != 0) return rc;
  rmap = qmap;  // a placeholder for producers that read no rows by TMA
  if (rows != nullptr && n > 0) {
    rc = encode_rows<Mma>(&rmap, rows, n, d);
    if (rc != 0) return rc;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&pool_kernel<Op>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int passes = n > 0 ? (n + w - 1) / w : 0;
  const int pps = passes > 0 ? (passes + splits - 1) / splits : 0;
  Val* out_v = static_cast<Val*>(splits == 1 ? vals : part_vals);
  int32_t* out_s = static_cast<int32_t*>(splits == 1 ? slots : part_slots);
  dim3 grid(w / kTN, (qn + kTQ - 1) / kTQ, splits);
  pool_kernel<Op><<<grid, kThreads, smem, s>>>(
      qmap, rmap, op, out_v, out_s, qn, n, w, kc_n, stages, streamed, passes,
      pps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long qw = (long long)qn * w;
  const int threads = 256;
  pool::merge_splits_kernel<Val><<<(unsigned)((qw + threads - 1) / threads),
                                   threads, 0, s>>>(
      out_v, out_s, static_cast<Val*>(vals), static_cast<int32_t*>(slots), qw,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace wg
