// The s8 tensor-core scan + strided-bucket min pool shared by the int8 pool
// kernels of the port (fused_int8_pool.cu: B2, B4, B7; fused_ivf_pool.cu, B8,
// reuses its fragments and row staging).  The bf16 pools (B6
// fused_raw_pool.cu, B5 fused_adc_pool.cu) run on the wgmma tile loop of
// pool_wgmma.cuh, which reuses merge_splits_kernel below.
//
// One kernel template, `pool_kernel<Op>`, computes for queries q [Q, dw words]
// and the N corpus rows that `Op` stages into shared memory:
//
//   vals[q, c]  = min over passes j of Op::score(q, c + j*W)   (strict <: the
//                 earliest pass wins a tie), slots[q, c] = its slot,
//   starting from (Op::init(), -1); Op::final_slot masks empty entries.
//
// This is the TPU kernels' `_pool_accumulate` (pallas_kernels.py:375-397) and
// `_pool_accumulate_i32` (:674-694): the TPU grid's sequential pass axis is a
// loop inside each block, because Hopper runs blocks in parallel and in no
// order.  Each block keeps a 64-query tile resident in shared memory and
// streams the 128 slots of each pass through shared memory; its 8 warps (2 x 4)
// each own a 32 x 32 output tile of s8 `mma.sync` m16n8k32 products read
// straight from the shared rows (rows padded by 16 bytes: conflict-free
// fragments; A: row g word t, row g+8 word t, row g word t+4, row g+8 word
// t+4; B: row g words t and t+4), a row being `dw` 4-byte words of d int8
// dims.  The running (value, slot) minimum stays in registers across passes
// and is written once.  When the query x column tiles alone cannot fill the
// card, the passes are split over gridDim.z into partial pools that
// `merge_splits_kernel` merges in pass order, which keeps the earliest-pass
// tie rule.  Loads are not overlapped with the products (no cp.async/TMA
// ring) and wgmma is not used: later work.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pool {

constexpr int kTQ = 64;        // query rows per block
constexpr int kTN = 128;       // pool columns per block (W % kTN == 0)
constexpr int kThreads = 256;  // 8 warps: 2 along queries x 4 along columns
constexpr int kWM = 32;        // query rows per warp
constexpr int kWN = 32;        // pool columns per warp
constexpr int kMT = kWM / 16;  // m16 tiles per warp
constexpr int kNT = kWN / 8;   // n8 tiles per warp
constexpr int kPadWords = 4;   // shared row padding: conflict-free fragments
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one H100 block

// D += A * B for one m16n8k32 tile: A 16 x 32 s8 (row), B 32 x 8 s8 (col).
__device__ __forceinline__ void mma(int (&d)[4], const int (&a)[4], int b0,
                                    int b1) {
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

// The rows of a corpus matrix [N, dw] words, staged as they are (B2, B4,
// B7).  Slots past N stage as zeros.
struct MatrixRows {
  const int32_t* base;
  __device__ void stage(int32_t* s_b, long long row0, int N, int dw, int dw8,
                        int stride, bool vec16) const {
    stage_rows(s_b, kTN, dw, dw8, stride, vec16,
               [&](int r) -> const int32_t* {
                 return row0 + r < N ? base + (size_t)(row0 + r) * dw
                                     : nullptr;
               });
  }
};

// The shared-memory layout of one block: the resident query tile, the pass's
// corpus tile and two per-column values of the pass (Op::Col and f32).
template <class Op>
struct Tiles {
  int32_t* s_q;                 // [kTQ][stride]
  int32_t* s_b;                 // [kTN][stride]
  typename Op::Col* s_c0;       // [kTN]
  float* s_c1;                  // [kTN]
  __device__ Tiles(int32_t* smem, int stride) {
    s_q = smem;
    s_b = s_q + kTQ * stride;
    s_c0 = reinterpret_cast<typename Op::Col*>(s_b + kTN * stride);
    s_c1 = reinterpret_cast<float*>(s_c0 + kTN);
  }
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const int32_t* __restrict__ q,     // [Q, dw] words
            Op op,
            typename Op::Val* __restrict__ vals,  // [splits, Q, W]
            int32_t* __restrict__ slots,          // [splits, Q, W]
            int Q, int N, int dw, int W, int passes, int passes_per_split,
            bool vec16) {
  using Acc = typename Op::Acc;
  using Val = typename Op::Val;
  extern __shared__ __align__(16) int32_t smem[];
  const int dw8 = (dw + 7) & ~7;       // words per row, whole k steps
  const int stride = dw8 + kPadWords;  // shared words per row
  const Tiles<Op> t_(smem, stride);

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
  stage_rows(t_.s_q, kTQ, dw, dw8, stride, vec16,
             [&](int r) -> const int32_t* {
               return q0 + r < Q ? q + (size_t)(q0 + r) * dw : nullptr;
             });
  op.prepare(t_.s_b, dw, dw8, stride);

  // this thread's accumulator elements: query row q0 + wm0 + 16 mt + g + 8 h
  // and column wn0 + 8 nt + 2 t + e, at acc[mt][nt][2 h + e]
  float r_q[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      r_q[mt][h] = op.row_value(q0 + wm0 + 16 * mt + g + 8 * h, Q);
  Val best_v[kMT][kNT][4];
  int best_s[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        best_v[mt][nt][i] = Op::init();
        best_s[mt][nt][i] = -1;
      }

  for (int p = p_begin; p < p_end; ++p) {
    const long long row0 = (long long)p * W + c0;  // slot of local column 0
    __syncthreads();  // the previous pass has finished reading s_b
    op.stage(t_.s_b, row0, N, dw, dw8, stride, vec16);
    if (tid < kTN) op.stage_cols(t_.s_c0, t_.s_c1, tid, row0 + tid, N);
    __syncthreads();

    Acc acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

    for (int kw = 0; kw < dw8; kw += 8) {  // one k step = 8 words
      int a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int32_t* r = t_.s_q + (wm0 + 16 * mt + g) * stride + kw + t;
        a[mt][0] = r[0];
        a[mt][1] = r[8 * stride];
        a[mt][2] = r[4];
        a[mt][3] = r[8 * stride + 4];
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int32_t* r = t_.s_b + (wn0 + 8 * nt + g) * stride + kw + t;
        const int b0 = r[0];
        const int b1 = r[4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
      }
    }

#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn0 + 8 * nt + 2 * t + e;
        const typename Op::Col o = t_.s_c0[col];
        const float c = t_.s_c1[col];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * h + e;
            const Val score = Op::score(acc[mt][nt][i], o, c, r_q[mt][h]);
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
          slots[o] = Op::final_slot(best_v[mt][nt][i], best_s[mt][nt][i]);
        }
      }
    }
  }
}

// Merge the per-split partial pools in split (= pass) order with strict <,
// so a tie keeps the earlier pass exactly as the single-block loop would.
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

// Shared memory of one block for rows of dw words.
inline int smem_bytes(int dw) {
  const int dw8 = (dw + 7) & ~7;
  return (kTQ + kTN) * (dw8 + kPadWords) * 4 + 2 * kTN * 4;
}

// Host side of every entry point: the pool kernel over rows of dw words, then
// the split merge.  With splits == 1 the kernel writes vals/slots [q, w]
// directly; otherwise part_vals/part_slots [splits, q, w], which the merge
// kernel reduces into vals/slots.  Returns cudaGetLastError().
template <class Op>
int launch(const void* q, const Op& op, void* part_vals, void* part_slots,
           void* vals, void* slots, int qn, int n, int dw, int w, int splits,
           bool vec16, void* stream) {
  using Val = typename Op::Val;
  if (qn <= 0 || w <= 0 || dw <= 0 || n < 0 || w % kTN != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(dw);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
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
      static_cast<const int32_t*>(q), op, out_v, out_s, qn, n, dw, w, passes,
      pps, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long qw = (long long)qn * w;
  const int threads = 256;
  merge_splits_kernel<Val><<<(unsigned)((qw + threads - 1) / threads),
                             threads, 0, s>>>(
      out_v, out_s, static_cast<Val*>(vals), static_cast<int32_t*>(slots), qw,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace pool
