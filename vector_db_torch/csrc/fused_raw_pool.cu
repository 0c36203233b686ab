// Fused bf16 scan + strided-bucket min pool over a bf16 corpus shadow, for
// NVIDIA Hopper: the bf16 instance of the wgmma tile loop (pool_wgmma.cuh)
// with its TMA producer.
//
// Replaces the TPU kernel `fused_raw_pool` of
// vector_db_tpu/ops/pallas_kernels.py (:460, pallas_call at :519; body
// :444-452).
//
// What it computes, for queries q16 [Q, d8] bf16 and corpus rows base16
// [N, d8] bf16 with the per-slot columns off [N] (+inf at dead slots) and
// sc [N] f32:
//
//   score(q, n) = __fadd_rn(off[n], __fmul_rn(q16 . v16_n, sc[n])), the
//                 products of bf16 values summed in f32;
//   vals[q, c]  = min over passes j of score(q, c + j*W), slots[q, c] its
//                 slot; +inf / -1 where empty.
//
// The epilogue rounds each operation in the reference's order, so nvcc
// cannot contract it into an FMA.  The f32 sums run in the tensor cores'
// order, not the plain matmul's: the scores agree with the plain version
// within the f32 summation-order bound 2 d 2^-24 (|q|.|v|) |sc|
// (ops/kernels.check_float_pool).
//
// What bounds it on an H100: at the main path's shape (Q = 1024 queries,
// N ~ 1M slots, d = 512) the 5.4e11 bf16 multiply-adds; the 1 GB corpus
// crosses L2 -> SM once per 128-query tile (8 times at Q = 1024).  Warp 0 of
// the producer warpgroup starts one TMA per [128 x 64] stage (rows past N
// arrive as zeros) and stages each pass's off/sc; its other three warps
// exit at once.  Rows past 640 dims stream the query tile through the ring
// (pool_wgmma.cuh's streamed layout: a second TMA a stage).

#include <cstdio>

#include "pool_wgmma.cuh"

namespace {

struct RawRows {
  using Mma = wg::Bf16Mma;
  using Val = float;
  static constexpr int kFullArrivals = 1;  // the TMA thread's expect_tx
  const float* off;
  const float* sc;

  __device__ __forceinline__ static float init() { return INFINITY; }
  __device__ __forceinline__ static bool live(float v) { return isfinite(v); }
  __device__ __forceinline__ float row_value(int, int) const { return 0.f; }
  __device__ __forceinline__ static float score(float acc, float o, float c,
                                               float) {
    return __fadd_rn(o, __fmul_rn(acc, c));
  }
  __device__ __forceinline__ void col_values(long long slot, int N,
                                             float& v0, float& v1) const {
    v0 = slot < N ? __ldg(off + slot) : INFINITY;
    v1 = slot < N ? __ldg(sc + slot) : 0.f;
  }
  __device__ __forceinline__ void produce(const wg::Ring& r,
                                          const CUtensorMap* rmap, int N,
                                          int W, int c0, int p_begin,
                                          int p_end) const {
    wg::produce_tma(*this, r, rmap, N, W, c0, p_begin, p_end);
  }
};

}  // namespace

extern "C" {

// Launch on `stream`.  q16 [q, d] and base16 [n, d] bf16 contiguous with
// d % 8 == 0 and 16-byte aligned rows; off/sc [n] f32; w % 128 == 0;
// `stages` ring stages and the resident (streamed == 0) or streamed query
// tile, as ops/kernels.wgmma_plan chooses them.  With splits == 1 the
// kernel writes vals/slots [q, w] directly; otherwise part_vals/part_slots
// [splits, q, w], merged into vals/slots.  Returns 0, a cudaError_t, or
// wg::kTensorMapError + a CUresult.
int vdb_fused_raw_pool(const void* q16, const void* base16, const void* off,
                       const void* sc, void* part_vals, void* part_slots,
                       void* vals, void* slots, int q, int n, int d, int w,
                       int splits, int stages, int streamed, void* stream) {
  const RawRows op{static_cast<const float*>(off),
                   static_cast<const float*>(sc)};
  return wg::launch(q16, d, base16, op, part_vals, part_slots, vals, slots, q,
                    n, d, w, splits, stages, streamed, stream);
}

// The message of a return code of any entry point of the library.
const char* vdb_cuda_error_string(int code) {
  static char buf[96];
  if (code >= wg::kTensorMapError) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - wg::kTensorMapError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
