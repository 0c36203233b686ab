// Fused s8 scan + strided-bucket min pool over a corpus matrix, for NVIDIA
// Hopper: three TPU kernels of vector_db_tpu/ops/pallas_kernels.py on the s8
// instance of the wgmma tile loop (pool_wgmma.cuh), with two epilogues and
// two producers.
//
//   entry                   TPU kernel (pallas_call)   operands, epilogue
//   vdb_fused_int8_pool     fused_int8_pool :585 (:631)  s8 x s8 -> s32,
//                           body :568-577                f32 off + (x*sc)*sq
//   vdb_fused_packed_pool   fused_packed_pool :900 (:949) the same over the
//                           compressed store's int32-packed rows
//   vdb_fused_int8g_pool    fused_int8g_pool :726 (:797)  s8 x s8 -> s32,
//                           body :712-718                i32 off_i - x
//
// What each computes, for queries q [Q, d] and corpus rows v [N, d] with the
// per-slot columns off [N] (and sc [N]):
//
//   * per-row s8 (B2, B4): score = off[n] + (float(q8 . v8_n) * sc[n]) * sq[q],
//     sq the per-query scale (kept in the consumer's registers); +inf/-1
//     where empty.
//   * global s8 (B7): score = off_i[n] - (q8 . v8_n), all int32, init
//     INT32_MAX; slots past N score 2^29 (a dead slot).  The per-column
//     buffer carries off_i as the bits of a float.  The wrapper scales the
//     [Q, W] result back to f32 and masks scores >= 2^28, as the reference
//     does outside its kernel (:826-828).
//
// The cross terms are exact s32 sums of wgmma m64n128k32 products at any
// width below the s32 range (127^2 d < 2^31), converted to f32 once
// (__int2float_rn) as the reference does (cross.astype(jnp.float32)); the
// f32 epilogue rounds each operation separately (__fmul_rn / __fadd_rn) in
// the reference's order, so nvcc cannot contract it into an FMA.  So B2, B4
// and B7 are bit-equal to their plain PyTorch versions (ops/kernels.py).
//
// The producer is chosen by shape: rows of whole, 16-byte aligned vectors
// (d % 16 == 0) come by TMA from a uint8 tensor map; other rows (d % 4 ==
// 0: the int8 shadows pad rows only to 4 bytes, and B4 reads the compressed
// store's own rows, which cannot be re-padded; TMA's global stride must be
// a multiple of 16 bytes) by 4-byte cp.async copies from all four producer
// warps, handed over with fence.proxy.async as B5's decode does
// (wg::TmaRows and wg::CopyRows in pool_wgmma.cuh, which B8 shares).
//
// What bounds them on an H100: at the main path's shape (Q = 1024 queries,
// N ~ 1M slots, d = 512) the 5.4e11 s8 multiply-adds (0.53 ms of the int8
// tensor cores); the 0.5 GB corpus crosses L2 -> SM once per 128-query tile
// (8 times at Q = 1024).
//
// On the TPU, B4 unpacks its int32 words by shifts into a lane-permuted order;
// on this card the little-endian words are the int8 rows in true dim order,
// so B4 is B2's kernel over the same bytes.

#include "pool_wgmma.cuh"

namespace {

// B2, B4: f32 score = off + (float(cross) * sc) * sq.
struct Scaled {
  using Mma = wg::S8Mma;
  using Val = float;
  const float* off;
  const float* sc;
  const float* sq;
  __device__ __forceinline__ static float init() { return INFINITY; }
  __device__ __forceinline__ static bool live(float v) { return isfinite(v); }
  __device__ __forceinline__ float row_value(int row, int Q) const {
    return row < Q ? __ldg(sq + row) : 0.f;
  }
  __device__ __forceinline__ void col_values(long long slot, int N,
                                             float& v0, float& v1) const {
    v0 = slot < N ? __ldg(off + slot) : INFINITY;
    v1 = slot < N ? __ldg(sc + slot) : 0.f;
  }
  __device__ __forceinline__ static float score(int32_t acc, float o,
                                               float c, float r) {
    return __fadd_rn(o, __fmul_rn(__fmul_rn(__int2float_rn(acc), c), r));
  }
};

// B7: int32 score = off_i - cross (the wrapper scales it back to f32).
struct Global {
  using Mma = wg::S8Mma;
  using Val = int32_t;
  const int32_t* off_i;
  __device__ __forceinline__ static int32_t init() { return 0x7fffffff; }
  __device__ __forceinline__ static bool live(int32_t v) {
    return v != 0x7fffffff;
  }
  __device__ __forceinline__ float row_value(int, int) const { return 0.f; }
  __device__ __forceinline__ void col_values(long long slot, int N,
                                             float& v0, float& v1) const {
    // past N: a dead slot
    v0 = __int_as_float(slot < N ? __ldg(off_i + slot) : (1 << 29));
    v1 = 0.f;
  }
  __device__ __forceinline__ static int32_t score(int32_t acc, float o,
                                                 float, float) {
    return __float_as_int(o) - acc;
  }
};

// The producer for these rows, then the tile loop.  q8 [q, d16] (d16 = d
// rounded up to 16, zeros past d, 16-byte aligned) is read by TMA.
template <class Epi>
int launch_s8(const Epi& epi, const void* q8, const void* rows,
              void* part_vals, void* part_slots, void* vals, void* slots,
              int q, int n, int d, int w, int splits, int stages,
              int streamed, void* stream) {
  if (d <= 0 || d % 4 != 0 || reinterpret_cast<uintptr_t>(rows) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int q_cols = (d + 15) & ~15;
  if (d % 16 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0) {
    const wg::TmaRows<Epi> op{epi};
    return wg::launch(q8, q_cols, rows, op, part_vals, part_slots, vals,
                      slots, q, n, d, w, splits, stages, streamed, stream);
  }
  const wg::CopyRows<Epi> op{epi, static_cast<const uint8_t*>(rows), d};
  return wg::launch(q8, q_cols, nullptr, op, part_vals, part_slots, vals,
                    slots, q, n, d, w, splits, stages, streamed, stream);
}

}  // namespace

extern "C" {

// All pointers are device pointers; q8 [q, d16] int8 (d rounded up to 16,
// zeros past d, 16-byte aligned); w % 128 == 0; `stages` ring stages and
// the resident (streamed == 0) or streamed query tile, as
// ops/kernels.wgmma_plan chooses them; the launch goes on `stream`.  With
// splits == 1 the kernel writes vals/slots [q, w] directly; otherwise
// part_vals/part_slots [splits, q, w], merged into vals/slots.  Each
// returns 0, a cudaError_t, or wg::kTensorMapError + a CUresult.

// B2: sq [q] f32, base8 [n, d] int8, off/sc [n] f32; d % 4 == 0.
int vdb_fused_int8_pool(const void* q8, const void* sq, const void* base8,
                        const void* off, const void* sc, void* part_vals,
                        void* part_slots, void* vals, void* slots, int q,
                        int n, int d, int w, int splits, int stages,
                        int streamed, void* stream) {
  const Scaled epi{static_cast<const float*>(off),
                   static_cast<const float*>(sc),
                   static_cast<const float*>(sq)};
  return launch_s8(epi, q8, base8, part_vals, part_slots, vals, slots, q, n,
                   d, w, splits, stages, streamed, stream);
}

// B4: the same kernel over the compressed store's own rows, int32 words
// [n, d/4] holding four int8 dims each, byte j of word c = dim 4c + j
// (little-endian): byte for byte an int8 [n, d] matrix in true dim order.
// The caller guarantees n % w == 0 (no tail pass).
int vdb_fused_packed_pool(const void* q8, const void* sq, const void* packed,
                          const void* off, const void* sc, void* part_vals,
                          void* part_slots, void* vals, void* slots, int q,
                          int n, int d, int w, int splits, int stages,
                          int streamed, void* stream) {
  if (w > 0 && n % w != 0) return (int)cudaErrorInvalidValue;
  return vdb_fused_int8_pool(q8, sq, packed, off, sc, part_vals, part_slots,
                             vals, slots, q, n, d, w, splits, stages,
                             streamed, stream);
}

// B7: q8 one batch scale (applied by the caller), base8 [n, d] int8 (one
// corpus scale), off_i [n] int32; vals are int32 scores.
int vdb_fused_int8g_pool(const void* q8, const void* base8, const void* off_i,
                         void* part_vals, void* part_slots, void* vals,
                         void* slots, int q, int n, int d, int w, int splits,
                         int stages, int streamed, void* stream) {
  const Global epi{static_cast<const int32_t*>(off_i)};
  return launch_s8(epi, q8, base8, part_vals, part_slots, vals, slots, q, n,
                   d, w, splits, stages, streamed, stream);
}

}  // extern "C"
