// The bf16 tensor-core scan + strided-bucket min pool of the port, for
// NVIDIA Hopper (sm_90a): the tile loop of B6 fused_raw_pool.cu and B5
// fused_adc_pool.cu, which are its two producers.
//
// One kernel template, `bf16_pool_kernel<Op>`, computes for bf16 queries
// q [Q, d8] and the N bf16 corpus rows that `Op` produces into shared memory:
//
//   vals[q, c]  = min over passes j of Op::score(q . v_{c + j*W}, c0, c1)
//                 (f32 sums; strict <: the earliest pass wins a tie),
//   slots[q, c] = its slot; +inf / -1 where empty,
//
// c0, c1 the two per-slot values Op::col_values gives (B6: off, sc; B5: the
// masked norm).  This is the TPU kernels' `_pool_accumulate`
// (pallas_kernels.py:375-397): the TPU grid's sequential pass axis is a
// loop inside each block, because Hopper runs blocks in parallel and in no
// order.
//
// The block (384 threads) is warp-specialised:
//   * warpgroup 0, the producer (setmaxnreg down to kProducerRegs), loads
//     the block's 128 x d8 query tile once by TMA and then fills a ring of
//     `stages` corpus k-chunks, each [128 columns x 64 dims] bf16 (16 KB),
//     with full/empty mbarriers: B6 by TMA from a tensor map over its rows,
//     B5 by decoding PQ codes (cp.async gathers, then
//     fence.proxy.async.shared::cta, so wgmma sees the generic writes);
//     its warp 0 also stages each pass's 128 per-column values in a double
//     buffer of its own;
//   * warpgroups 1 and 2, the consumers (setmaxnreg up to kConsumerRegs),
//     own 64 query rows each and run wgmma.mma_async m64n128k16 (bf16 ->
//     f32) over the k-chunks of a pass, releasing each stage after its
//     wgmma.wait_group; after a pass's last k-chunk they apply the pool
//     compare to the accumulators in registers while the producer already
//     fills the next pass's stages.  Each thread keeps 64 accumulators and
//     the running (value, pass) minimum of its 64 entries; the slot,
//     p*W + column, is rebuilt at the end.
// Every tile is in the 128-byte swizzled layout that both TMA and the wgmma
// descriptors use (16-byte granule c of row r at granule c ^ (r % 8)); the
// ragged edges are zeros: TMA fills rows past Q or N and dims past d8, the
// decode writes zeros past d and past N, and a slot past N scores +inf
// through its per-column values, so it never wins.  When the query x
// column tiles alone cannot fill the card, the passes are split over
// gridDim.z into partial pools that pool::merge_splits_kernel merges in pass
// order, which keeps the earliest-pass tie rule.
//
// Shared memory: the query tile (ceil(d8 / 64) k-chunks of 16 KB), 3-4 ring
// stages of 16 KB, 2 KB of per-column values, the barriers, and 1 KB to
// align the tiles to the 1024-byte swizzle atom.  At d = 512 that is 128 +
// 64 KB; rows wider than 640 dims leave room for fewer than three stages and
// are refused (ops/kernels.MAX_BF16_POOL_DIM mirrors this layout).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pool_tile.cuh"  // pool::merge_splits_kernel, pool::kMaxSmem

namespace wg {

constexpr int kTQ = 128;        // query rows per block: two consumers x m64
constexpr int kTN = 128;        // pool columns per block (the wgmma n)
constexpr int kTK = 64;         // dims per k-chunk: one 128-byte swizzle row
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kChunkBytes = kTN * kTK * 2;  // one stage or query k-chunk
constexpr int kMaxStages = 4;
// B5's decode hands a stage over once the next one's copies started and
// the consumers release a stage once the next one's products started: with
// two stages each would wait for the other
constexpr int kMinStages = 3;
constexpr int kColBytes = 2 * 2 * kTN * 4;  // [2 buffers][c0, c1][128] f32
constexpr int kBarBytes = 128;              // the mbarriers
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

// 2-D TMA load of one [128 rows x 64 bf16] box at (x = dim, y = row) into
// shared memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
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
// A k16 step inside the 128-byte row adds 32 bytes to the start address.
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

// D (+)= A * B for A [64 x 16] and B [16 x 128] bf16 from shared memory
// (both K-major), f32 accumulators; scale_d == 0 overwrites D.  Thread l of
// warp w holds D[16 w + l/4 + 8 h][8 j + 2 (l % 4) + e] in d[4 j + 2 h + e].
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------------ the block
// Shared-space addresses of one block's tiles and barriers.
struct Ring {
  uint32_t q;         // [kc_n][128 rows][128 B] the query tile
  uint32_t stage;     // [stages][128 columns][128 B] the corpus ring
  uint32_t full;      // [kMaxStages] mbarriers: a stage was filled
  uint32_t empty;     // [kMaxStages] mbarriers: a stage was consumed
  uint32_t colfull;   // [2] the per-column values of a pass were staged
  uint32_t colempty;  // [2] ... and read
  uint32_t qbar;      // the query tile arrived
  float* cols;        // [2][2][128] the per-column values (generic pointer)
  int stages, kc_n;
};

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

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
bf16_pool_kernel(const __grid_constant__ CUtensorMap qmap,  // q [Q, d8]
                 const __grid_constant__ CUtensorMap rmap,  // Op's rows
                 const Op op,
                 float* __restrict__ vals,     // [splits, Q, W]
                 int32_t* __restrict__ slots,  // [splits, Q, W]
                 int Q, int N, int W, int kc_n, int stages, int passes,
                 int passes_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(kAlign - 1);
  Ring r;
  r.q = base;
  r.stage = r.q + kc_n * kChunkBytes;
  const uint32_t cols = r.stage + stages * kChunkBytes;
  r.cols = reinterpret_cast<float*>(smem_raw + (cols - raw));
  r.full = cols + kColBytes;
  r.empty = r.full + 8 * kMaxStages;
  r.colfull = r.empty + 8 * kMaxStages;
  r.colempty = r.colfull + 16;
  r.qbar = r.colempty + 16;
  r.stages = stages;
  r.kc_n = kc_n;

  const int c0 = blockIdx.x * kTN;
  const int q0 = blockIdx.y * kTQ;
  const int split = blockIdx.z;
  const int p_begin = split * passes_per_split;
  const int p_end = min(passes, p_begin + passes_per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      bar_init(r.full + 8 * s, Op::kFullArrivals);
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

  // the warpgroup's role, provably warp-uniform (a shuffle from lane 0), so
  // ptxas allocates each branch with its own setmaxnreg count
  const int role = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  if (role == 0) {
    // ---- producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      arrive_expect_tx(r.qbar, kc_n * kChunkBytes);
      for (int kc = 0; kc < kc_n; ++kc)
        tma_load(r.q + kc * kChunkBytes, &qmap, r.qbar, kTK * kc, q0);
    }
    op.produce(r, &rmap, N, W, c0, p_begin, p_end);
  } else {
    // ---- consumer warpgroups: query rows q0 + 64 cw .. + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = role - 1;
    const int ct = threadIdx.x & 127;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row_base = q0 + 64 * cw + 16 * (ct >> 5) + g;
    // a warpgroup whose 64 rows all lie past Q only keeps the protocol (the
    // flag shuffled from lane 0, provably uniform like the role)
    const bool active = __shfl_sync(0xffffffffu, q0 + 64 * cw < Q, 0);
    const uint32_t qa = r.q + cw * (kChunkBytes / 2);
    auto release = [&](uint32_t bar) {  // one arrival per warp
      __syncwarp();
      if (lane == 0) arrive(bar);
    };
    float acc[64];
    float best_v[64];
    int best_p[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      best_v[i] = INFINITY;
      best_p[i] = 0;
    }
    wait(r.qbar, 0);
    int s = 0;
    uint32_t ph = 0;
    for (int p = p_begin; p < p_end; ++p) {
      // one wgmma group stays in flight: stage k is released once stage
      // k+1's products started, the pass's last stage after all finish
      int prev = -1;
      for (int kc = 0; kc < kc_n; ++kc) {
        wait(r.full + 8 * s, ph);
        if (active) {
          const uint32_t a = qa + kc * kChunkBytes;
          const uint32_t b = r.stage + s * kChunkBytes;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kTK / 16; ++kk)
            wgmma_m64n128k16(acc, sw128_desc(a + 32 * kk),
                             sw128_desc(b + 32 * kk), (kc | kk) != 0);
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
      if (active) {
        wgmma_wait<0>();
        fence_acc(acc);
      }
      if (prev >= 0) release(r.empty + 8 * prev);
      const int pl = p - p_begin;
      const int b = pl & 1;
      wait(r.colfull + 8 * b, (pl >> 1) & 1);
      if (active) {
        const float* cv = r.cols + 2 * kTN * b;
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
              const float score = Op::score(acc[i], o, c);
              if (score < best_v[i]) {
                best_v[i] = score;
                best_p[i] = p;
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) arrive(r.colempty + 8 * b);
    }
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
          int2 sl;
          sl.x = isfinite(best_v[i])
                     ? (int)((long long)best_p[i] * W + col) : -1;
          sl.y = isfinite(best_v[i + 1])
                     ? (int)((long long)best_p[i + 1] * W + col + 1) : -1;
          *reinterpret_cast<float2*>(vals + o) =
              make_float2(best_v[i], best_v[i + 1]);
          *reinterpret_cast<int2*>(slots + o) = sl;
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side
// Shared memory of one block for kc_n query k-chunks and `stages` stages.
inline int smem_bytes(int kc_n, int stages) {
  return kAlign + (kc_n + stages) * kChunkBytes + kColBytes + kBarBytes;
}

// A 2-D tensor map over bf16 rows [rows, cols] (cols % 8 == 0, base 16-byte
// aligned): [128 x 64] boxes, 128-byte swizzle, zeros out of bounds.  The
// driver's cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint, so the library links only the runtime.
inline int encode_rows(CUtensorMap* map, const void* base, long long rows,
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
  if (rows <= 0 || cols <= 0 || cols % 8 != 0 ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {kTK, kTQ};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + (int)res;
}

// Host side of both entry points: the tensor maps (queries q16 [qn, d8]
// and, when `rows` is given, the corpus rows [n, d8]), the pool kernel,
// then the split merge.  With splits == 1 the kernel writes vals/slots
// [qn, w] directly; otherwise part_vals/part_slots [splits, qn, w], which
// the merge kernel reduces into vals/slots.  Returns 0, a cudaError_t, or
// kTensorMapError + the driver's CUresult.
template <class Op>
int launch(const void* q16, const void* rows, const Op& op, void* part_vals,
           void* part_slots, void* vals, void* slots, int qn, int n, int d8,
           int w, int splits, void* stream) {
  if (qn <= 0 || w <= 0 || d8 <= 0 || d8 % 8 != 0 || n < 0 || w % kTN != 0 ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  const int kc_n = (d8 + kTK - 1) / kTK;
  int stages = kMaxStages;
  while (stages >= kMinStages && smem_bytes(kc_n, stages) > pool::kMaxSmem)
    --stages;
  if (stages < kMinStages) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(kc_n, stages);
  CUtensorMap qmap, rmap;
  int rc = encode_rows(&qmap, q16, qn, d8);
  if (rc != 0) return rc;
  rmap = qmap;  // a placeholder for producers that read no rows by TMA
  if (rows != nullptr && n > 0) {
    rc = encode_rows(&rmap, rows, n, d8);
    if (rc != 0) return rc;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&bf16_pool_kernel<Op>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int passes = n > 0 ? (n + w - 1) / w : 0;
  const int pps = passes > 0 ? (passes + splits - 1) / splits : 0;
  float* out_v = static_cast<float*>(splits == 1 ? vals : part_vals);
  int32_t* out_s = static_cast<int32_t*>(splits == 1 ? slots : part_slots);
  dim3 grid(w / kTN, (qn + kTQ - 1) / kTQ, splits);
  bf16_pool_kernel<Op><<<grid, kThreads, smem, s>>>(
      qmap, rmap, op, out_v, out_s, qn, n, w, kc_n, stages, passes, pps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long qw = (long long)qn * w;
  const int threads = 256;
  pool::merge_splits_kernel<float><<<(unsigned)((qw + threads - 1) / threads),
                                     threads, 0, s>>>(
      out_v, out_s, static_cast<float*>(vals), static_cast<int32_t*>(slots),
      qw, splits);
  return (int)cudaGetLastError();
}

}  // namespace wg
