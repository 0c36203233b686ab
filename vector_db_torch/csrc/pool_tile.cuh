// What the pool kernels of the port share besides the wgmma tile loop
// (pool_wgmma.cuh, which runs B2, B4, B7, B6 and B5):
//
//   * the s8 `mma.sync` m16n8k32 fragments and the row staging of B8
//     (fused_ivf_pool.cu): a 64-row x 128-column block of 8 warps (2 x 4),
//     each owning a 32 x 32 output tile read straight from shared rows
//     padded by 16 bytes (conflict-free fragments; A: row g word t, row g+8
//     word t, row g word t+4, row g+8 word t+4; B: row g words t and t+4),
//     a row being `dw` 4-byte words of int8 dims;
//   * merge_splits_kernel, which merges the partial pools of blocks that
//     split one tile's passes (gridDim.z) in pass order, keeping the
//     earliest-pass tie rule of the TPU kernels' `_pool_accumulate`
//     (pallas_kernels.py:375-397);
//   * the shared memory one H100 block may use.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pool {

constexpr int kTQ = 64;        // query rows per block
constexpr int kTN = 128;       // columns per block
constexpr int kThreads = 256;  // 8 warps: 2 along queries x 4 along columns
constexpr int kWM = 32;        // query rows per warp
constexpr int kWN = 32;        // columns per warp
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

}  // namespace pool
