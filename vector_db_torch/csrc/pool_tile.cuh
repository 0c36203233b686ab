// What the pool kernels of the port share besides the wgmma tile loop
// (pool_wgmma.cuh, which runs B2, B4, B7, B6, B5 and B8):
//
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

constexpr int kMaxSmem = 232448;  // dynamic shared memory of one H100 block

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
