// Fused s8 x s8 -> s32 scan + strided-bucket min pool, for NVIDIA Hopper.
//
// Replaces the TPU kernel `fused_int8_pool` of
// vector_db_tpu/ops/pallas_kernels.py (pallas_call at :631; body
// `_make_int8_pool_kernel` :568-577 and `_pool_accumulate` :375-397), and,
// through the second entry point `vdb_fused_packed_pool`, the TPU kernel
// `fused_packed_pool` (:900, pallas_call at :949), which is the same scan
// over the compressed store's int32-packed rows: on this card those words
// are already the int8 rows in true dim order, so one kernel serves both.
//
// What it computes, for queries q8 [Q, D] int8 with per-row scales sq [Q]
// and a corpus shadow base8 [N, D] int8 with per-slot off [N], sc [N]:
//
//   score(q, n) = off[n] + (float(q8[q] . base8[n]) * sc[n]) * sq[q]
//   vals[q, c]  = min over passes j of score(q, c + j*W)   (strict <: the
//                 earliest pass wins a tie), slots[q, c] the slot of it,
//   starting from (+inf, -1); slots >= N score +inf; a non-finite result
//   has slot -1.
//
// The epilogue rounds each operation separately (__fmul_rn / __fadd_rn), in
// the order of the reference, so nvcc cannot contract it into an FMA and the
// result is bit-equal to the plain PyTorch version (ops/kernels.py).  The
// cross term is exact: |q8 . v8| <= 127^2 * D < 2^24 for D <= 1040.
//
// What bounds it on an H100: at the main path's shape (Q = 1024 queries,
// N ~ 1M slots, D = 512) the 5.4e11 int8 multiply-adds, unless they run on
// the tensor cores; the shadow itself is 0.5 GB.  Each block keeps a
// 64-query tile resident in shared memory and streams the 128 slots of each
// pass through shared memory; its 8 warps (2 x 4) each own a 32 x 32 output
// tile and run `mma.sync.m16n8k32` s8 x s8 -> s32 on fragments read straight
// from the shared rows (rows padded by 16 bytes: conflict-free).  The int32
// sums are exact, so the result does not depend on the summation order.
// The running (value, slot) minimum stays in registers across passes and is
// written once.  Blocks are independent (the TPU grid's sequential pass axis
// becomes the loop inside the block); when the query x column tiles alone
// cannot fill the card, the passes are split across blocks (gridDim.z) into
// partial pools that a second small kernel merges in pass order, which
// keeps the earliest-pass tie rule.  Loads are not yet overlapped with the
// products (no cp.async/TMA pipeline) and wgmma is not used: later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 64;        // query rows per block
constexpr int kTN = 128;       // pool columns per block (W % kTN == 0)
constexpr int kThreads = 256;  // 8 warps: 2 along queries x 4 along columns
constexpr int kWM = 32;        // query rows per warp
constexpr int kWN = 32;        // pool columns per warp
constexpr int kMT = kWM / 16;  // m16 tiles per warp
constexpr int kNT = kWN / 8;   // n8 tiles per warp
constexpr int kPadWords = 4;   // shared row padding: conflict-free fragments

// D += A * B for one m16n8k32 tile: A 16 x 32 s8 (row), B 32 x 8 s8 (col).
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` rows of dw words (row r from src_row(r), or zeros) into shared
// rows of `stride` words, zero-filling words dw..dw8.  16-byte loads when
// `vec16` (rows are whole, aligned 16-byte vectors), 4-byte loads otherwise.
template <typename RowPtr>
__device__ __forceinline__ void stage_rows(int32_t* dst, int rows, int dw,
                                           int dw8, int stride, bool vec16,
                                           RowPtr src_row) {
  if (vec16) {
    const int v8 = dw8 >> 2;  // 16-byte vectors per shared row
    for (int i = threadIdx.x; i < rows * v8; i += kThreads) {
      const int r = i / v8;
      const int v = i - r * v8;
      const int32_t* src = src_row(r);
      int4 x = make_int4(0, 0, 0, 0);
      if (src != nullptr && 4 * v < dw)
        x = __ldg(reinterpret_cast<const int4*>(src) + v);
      *reinterpret_cast<int4*>(&dst[r * stride + 4 * v]) = x;
    }
  } else {
    for (int i = threadIdx.x; i < rows * dw8; i += kThreads) {
      const int r = i / dw8;
      const int w = i - r * dw8;
      const int32_t* src = src_row(r);
      dst[r * stride + w] = (src != nullptr && w < dw) ? __ldg(src + w) : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
int8_pool_kernel(const int32_t* __restrict__ q8,     // [Q, dw] words
                 const float* __restrict__ sq,       // [Q]
                 const int32_t* __restrict__ base8,  // [N, dw] words
                 const float* __restrict__ off,      // [N]
                 const float* __restrict__ sc,       // [N]
                 float* __restrict__ vals,           // [splits, Q, W]
                 int32_t* __restrict__ slots,        // [splits, Q, W]
                 int Q, int N, int dw, int W, int passes,
                 int passes_per_split, bool vec16) {
  extern __shared__ __align__(16) int32_t smem[];
  const int dw8 = (dw + 7) & ~7;       // words per row, whole k32 steps
  const int stride = dw8 + kPadWords;  // shared words per row
  int32_t* s_q = smem;                 // [kTQ][stride]
  int32_t* s_b = s_q + kTQ * stride;   // [kTN][stride]
  float* s_off = reinterpret_cast<float*>(s_b + kTN * stride);  // [kTN]
  float* s_sc = s_off + kTN;                                    // [kTN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;             // fragment row group
  const int t = lane & 3;              // thread in group
  const int wm0 = (warp >> 2) * kWM;   // warp's first query row in the tile
  const int wn0 = (warp & 3) * kWN;    // warp's first column in the tile
  const int c0 = blockIdx.x * kTN;
  const int q0 = blockIdx.y * kTQ;
  const int split = blockIdx.z;
  const int p_begin = split * passes_per_split;
  const int p_end = min(passes, p_begin + passes_per_split);

  // the query tile stays resident; rows past Q and pad words are zero
  stage_rows(s_q, kTQ, dw, dw8, stride, vec16, [&](int r) -> const int32_t* {
    return q0 + r < Q ? q8 + (size_t)(q0 + r) * dw : nullptr;
  });

  // this thread's accumulator elements: query row q0 + wm0 + 16 mt + g + 8 h
  // and column wn0 + 8 nt + 2 t + e, at acc[mt][nt][2 h + e]
  float r_sq[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = q0 + wm0 + 16 * mt + g + 8 * h;
      r_sq[mt][h] = qr < Q ? sq[qr] : 0.f;
    }
  }
  float best_v[kMT][kNT][4];
  int best_s[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        best_v[mt][nt][i] = INFINITY;
        best_s[mt][nt][i] = -1;
      }

  for (int p = p_begin; p < p_end; ++p) {
    const long long row0 = (long long)p * W + c0;  // slot of local column 0
    __syncthreads();  // the previous pass has finished reading s_b
    stage_rows(s_b, kTN, dw, dw8, stride, vec16, [&](int r) -> const int32_t* {
      return row0 + r < N ? base8 + (size_t)(row0 + r) * dw : nullptr;
    });
    if (tid < kTN) {
      const long long slot = row0 + tid;
      s_off[tid] = slot < N ? off[slot] : INFINITY;
      s_sc[tid] = slot < N ? sc[slot] : 0.f;
    }
    __syncthreads();

    int acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

    for (int kw = 0; kw < dw8; kw += 8) {  // one k32 step = 8 words
      int a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int32_t* r = s_q + (wm0 + 16 * mt + g) * stride + kw + t;
        a[mt][0] = r[0];
        a[mt][1] = r[8 * stride];
        a[mt][2] = r[4];
        a[mt][3] = r[8 * stride + 4];
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int32_t* r = s_b + (wn0 + 8 * nt + g) * stride + kw + t;
        const int b0 = r[0];
        const int b1 = r[4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn0 + 8 * nt + 2 * t + e;
        const float o = s_off[col];
        const float c = s_sc[col];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * h + e;
            const float score = __fadd_rn(
                o, __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]), c),
                             r_sq[mt][h]));
            if (score < best_v[mt][nt][i]) {
              best_v[mt][nt][i] = score;
              best_s[mt][nt][i] = (int)(row0 + col);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = q0 + wm0 + 16 * mt + g + 8 * h;
      if (qr >= Q) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          const size_t o = ((size_t)split * Q + qr) * W + c0 + wn0 + 8 * nt +
                           2 * t + e;
          vals[o] = best_v[mt][nt][i];
          slots[o] = isfinite(best_v[mt][nt][i]) ? best_s[mt][nt][i] : -1;
        }
      }
    }
  }
}

// Merge the per-split partial pools in split (= pass) order with strict <,
// so a tie keeps the earlier pass exactly as the single-block loop would.
__global__ void merge_splits_kernel(const float* __restrict__ part_vals,
                                    const int32_t* __restrict__ part_slots,
                                    float* __restrict__ vals,
                                    int32_t* __restrict__ slots,
                                    long long qw, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= qw) return;
  float bv = part_vals[i];
  int32_t bs = part_slots[i];
  for (int z = 1; z < splits; ++z) {
    const float v = part_vals[z * qw + i];
    if (v < bv) {
      bv = v;
      bs = part_slots[z * qw + i];
    }
  }
  vals[i] = bv;
  slots[i] = bs;
}

// Host side of both entry points: the pool kernel over int32 words
// [n, d/4] (the int8 rows as 4-byte words), then the split merge.
int launch_int8_pool(const void* q8, const void* sq, const int32_t* base8,
                     const void* off, const void* sc, void* part_vals,
                     void* part_slots, void* vals, void* slots, int q, int n,
                     int d, int w, int splits, void* stream) {
  if (q <= 0 || w <= 0 || d <= 0 || d % 4 != 0 || w % kTN != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dw8 = ((d / 4) + 7) & ~7;  // shared: two tiles + off/sc columns
  const int smem = (kTQ + kTN) * (dw8 + kPadWords) * 4 + 2 * kTN * 4;
  cudaError_t err = cudaFuncSetAttribute(
      int8_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int passes = n > 0 ? (n + w - 1) / w : 0;
  const int pps = passes > 0 ? (passes + splits - 1) / splits : 0;
  float* out_v = static_cast<float*>(splits == 1 ? vals : part_vals);
  int32_t* out_s = static_cast<int32_t*>(splits == 1 ? slots : part_slots);
  const bool vec16 = d % 16 == 0 && reinterpret_cast<uintptr_t>(q8) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(base8) % 16 == 0;
  dim3 grid(w / kTN, (q + kTQ - 1) / kTQ, splits);
  int8_pool_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(q8), static_cast<const float*>(sq), base8,
      static_cast<const float*>(off), static_cast<const float*>(sc), out_v,
      out_s, q, n, d / 4, w, passes, pps, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long qw = (long long)q * w;
  const int threads = 256;
  merge_splits_kernel<<<(unsigned)((qw + threads - 1) / threads), threads, 0,
                        s>>>(out_v, out_s, static_cast<float*>(vals),
                             static_cast<int32_t*>(slots), qw, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the pool on `stream`.  All pointers are device pointers; d % 4 == 0,
// w % 128 == 0.  With splits == 1 the kernel writes vals/slots [q, w]
// directly; otherwise it writes part_vals/part_slots [splits, q, w] and the
// merge kernel reduces them into vals/slots.  Returns cudaGetLastError().
int vdb_fused_int8_pool(const void* q8, const void* sq, const void* base8,
                        const void* off, const void* sc, void* part_vals,
                        void* part_slots, void* vals, void* slots, int q,
                        int n, int d, int w, int splits, void* stream) {
  return launch_int8_pool(q8, sq, static_cast<const int32_t*>(base8), off, sc,
                          part_vals, part_slots, vals, slots, q, n, d, w,
                          splits, stream);
}

// fused_packed_pool: the same kernel over the compressed store's own rows,
// int32 words [n, d/4] holding four int8 dims each, byte j of word c = dim
// 4c + j (little-endian).  In memory that is byte for byte an int8 [n, d]
// matrix in true dim order, so the unpack and query permutation of the TPU
// kernel disappear.  The caller guarantees n % w == 0 (no tail pass).
int vdb_fused_packed_pool(const void* q8, const void* sq,
                          const int32_t* packed, const void* off,
                          const void* sc, void* part_vals, void* part_slots,
                          void* vals, void* slots, int q, int n, int d, int w,
                          int splits, void* stream) {
  if (w > 0 && n % w != 0) return (int)cudaErrorInvalidValue;
  return launch_int8_pool(q8, sq, packed, off, sc, part_vals, part_slots, vals,
                          slots, q, n, d, w, splits, stream);
}

const char* vdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
