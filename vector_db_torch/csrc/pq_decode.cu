// PQ decode to a transposed bf16 reconstruction, for NVIDIA Hopper.
//
// Replaces the TPU kernel `pq_decode_recon_t` of
// vector_db_tpu/ops/pallas_kernels.py (:174, pallas_call at :207; body
// `_make_decode_kernel` :130-170).
//
// What it computes, for codes_t [S, N] uint8 (row s at codes_t + s * ld) and
// the codebooks in the gather layout cbt [S * sd, K] f32 (cbt[s*sd + j, c] =
// codebooks[s, c, j]):
//
//   out[s*sd + j, n] = bf16_rn(cbt[s*sd + j, codes_t[s, n]])   for j < sd
//
// out is [S * sd, N] bf16, row-major.  __float2bfloat16_rn rounds to nearest
// even, as PyTorch's .to(torch.bfloat16) and XLA's astype(bfloat16) do, so
// the result is bit-equal to the plain version (ops/kernels.py).
//
// What bounds it on an H100: memory.  It reads N * S code bytes and writes
// N * S * sd * 2 bytes (512 MB for one 524,288-column chunk at d = 512);
// there is no arithmetic.  Each block owns one subspace s and a slab of up
// to kSlab of its sd dims (blockIdx.y, blockIdx.z), stages that slab of the
// codebook ([kSlab, K] f32, <= 16 KB) in shared memory, and gives each thread
// kCols consecutive columns: it reads their codes as one 4-byte load and
// writes each dim's kCols bf16 as one 8-byte store, so a warp's loads and
// stores are contiguous along n.  The lookups are random shared-memory reads
// (bank conflicts of a few ways); they cost less than the writes.  The TPU
// kernel's lane tricks (lo/hi 128-lane halves, K padded to 128/256) have no
// counterpart here: any K <= 256 indexes the slab directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDecThreads = 256;
constexpr int kCols = 4;    // consecutive columns per thread
constexpr int kSlab = 16;   // subspace dims per block

__global__ void __launch_bounds__(kDecThreads)
pq_decode_kernel(const uint8_t* __restrict__ codes_t, long long ld,
                 const float* __restrict__ cbt, __nv_bfloat16* __restrict__ out,
                 int N, int sd, int K, bool vec) {
  extern __shared__ float s_cb[];  // [slab][K]
  const int s = blockIdx.y;
  const int j0 = blockIdx.z * kSlab;
  const int slab = min(kSlab, sd - j0);
  const float* src = cbt + ((size_t)s * sd + j0) * K;
  for (int i = threadIdx.x; i < slab * K; i += kDecThreads) s_cb[i] = src[i];
  __syncthreads();

  const long long n0 =
      ((long long)blockIdx.x * kDecThreads + threadIdx.x) * kCols;
  if (n0 >= N) return;
  const uint8_t* crow = codes_t + (size_t)s * ld + n0;
  int code[kCols];
  if (vec) {
    const uchar4 c4 = *reinterpret_cast<const uchar4*>(crow);
    code[0] = c4.x;
    code[1] = c4.y;
    code[2] = c4.z;
    code[3] = c4.w;
  } else {
#pragma unroll
    for (int i = 0; i < kCols; ++i) code[i] = n0 + i < N ? crow[i] : 0;
  }
  for (int jj = 0; jj < slab; ++jj) {
    const float* row = s_cb + jj * K;
    __nv_bfloat16* o = out + ((size_t)s * sd + j0 + jj) * N + n0;
    if (vec) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(row[code[0]], row[code[1]]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(row[code[2]], row[code[3]]);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = v;
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (n0 + i < N) o[i] = __float2bfloat16_rn(row[code[i]]);
    }
  }
}

}  // namespace

extern "C" {

// Decode on `stream`.  codes_t: S rows of N uint8 codes, row stride ld bytes
// (a column slice of a wider [S, cap] matrix needs no copy); cbt [S*sd, K]
// f32 contiguous; out [S*sd, N] bf16 contiguous.  Codes are < K <= 256.
// Returns cudaGetLastError().
int vdb_pq_decode_recon_t(const void* codes_t, long long ld, const void* cbt,
                          void* out, int S, int N, int sd, int K,
                          void* stream) {
  if (S <= 0 || N <= 0 || sd <= 0 || K <= 0 || K > 256 || ld < N || S > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = N % kCols == 0 && ld % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(codes_t) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const long long per_block = (long long)kDecThreads * kCols;
  dim3 grid((unsigned)((N + per_block - 1) / per_block), S,
            (sd + kSlab - 1) / kSlab);
  const size_t smem = (size_t)kSlab * K * sizeof(float);
  pq_decode_kernel<<<grid, kDecThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes_t), ld, static_cast<const float*>(cbt),
      static_cast<__nv_bfloat16*>(out), N, sd, K, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
