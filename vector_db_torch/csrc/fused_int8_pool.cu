// Fused s8 scan + strided-bucket min pool over a corpus matrix, for NVIDIA
// Hopper: three TPU kernels of vector_db_tpu/ops/pallas_kernels.py through one
// tile loop (pool_tile.cuh) with two epilogues.  (The bf16 pool B6 is
// fused_raw_pool.cu, on the wgmma tile loop of pool_wgmma.cuh.)
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
//     sq the per-query scale; +inf/-1 where empty.
//   * global s8 (B7): score = off_i[n] - (q8 . v8_n), all int32, init
//     INT32_MAX; slots past N score 2^29 (a dead slot).  The wrapper scales the
//     [Q, W] result back to f32 and masks scores >= 2^28, as the reference
//     does outside its kernel (:826-828).
//
// The f32 epilogue rounds each operation separately (__fmul_rn / __fadd_rn)
// in the reference's order, so nvcc cannot contract it into an FMA.  The s8
// cross terms are exact (|q8 . v8| <= 127^2 * d < 2^24 for d <= 1040), so B2,
// B4 and B7 are bit-equal to their plain PyTorch versions (ops/kernels.py).
//
// What bounds them on an H100: at the main path's shape (Q = 1024 queries,
// N ~ 1M slots, d = 512) the 5.4e11 multiply-adds, on the tensor cores
// through mma.sync; the corpus itself is 0.5 GB.
//
// On the TPU, B4 unpacks its int32 words by shifts into a lane-permuted order;
// on this card the little-endian words are the int8 rows in true dim order,
// so B4 is B2's kernel over the same bytes.

#include "pool_tile.cuh"

namespace {

using pool::kTN;

// B2, B4: f32 score = off + (float(cross) * sc) * sq.
struct ScaledS8 : pool::MatrixRows {
  using Acc = int;
  using Val = float;
  using Col = float;
  const float* off;
  const float* sc;
  const float* sq;
  __device__ static float init() { return INFINITY; }
  __device__ void prepare(int32_t*, int, int, int) const {}
  __device__ float row_value(int qr, int Q) const {
    return qr < Q ? sq[qr] : 0.f;
  }
  __device__ void stage_cols(float* c0, float* c1, int i, long long slot,
                             int N) const {
    c0[i] = slot < N ? off[slot] : INFINITY;
    c1[i] = slot < N ? sc[slot] : 0.f;
  }
  __device__ static float score(int acc, float o, float c, float r) {
    return __fadd_rn(o, __fmul_rn(__fmul_rn(__int2float_rn(acc), c), r));
  }
  __device__ static int32_t final_slot(float v, int32_t s) {
    return isfinite(v) ? s : -1;
  }
};

// B7: int32 score = off_i - cross (the wrapper scales it back to f32).
struct GlobalS8 : pool::MatrixRows {
  using Acc = int;
  using Val = int;
  using Col = int;
  const int32_t* off_i;
  __device__ static int init() { return 0x7fffffff; }
  __device__ void prepare(int32_t*, int, int, int) const {}
  __device__ float row_value(int, int) const { return 0.f; }
  __device__ void stage_cols(int* c0, float* c1, int i, long long slot,
                             int N) const {
    c0[i] = slot < N ? off_i[slot] : (1 << 29);  // past N: a dead slot
    c1[i] = 0.f;
  }
  __device__ static int score(int acc, int o, float, float) { return o - acc; }
  __device__ static int32_t final_slot(int, int32_t s) { return s; }
};

bool aligned16(const void* a, const void* b, int dw) {
  return dw % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

int launch_scaled(const void* q8, const void* sq, const void* base8,
                  const void* off, const void* sc, void* part_vals,
                  void* part_slots, void* vals, void* slots, int q, int n,
                  int d, int w, int splits, void* stream) {
  if (d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  ScaledS8 op;
  op.base = static_cast<const int32_t*>(base8);
  op.off = static_cast<const float*>(off);
  op.sc = static_cast<const float*>(sc);
  op.sq = static_cast<const float*>(sq);
  return pool::launch(q8, op, part_vals, part_slots, vals, slots, q, n, d / 4,
                      w, splits, aligned16(q8, base8, d / 4), stream);
}

}  // namespace

extern "C" {

// All pointers are device pointers; w % 128 == 0; the launch goes on
// `stream`.  With splits == 1 the kernel writes vals/slots [q, w] directly;
// otherwise part_vals/part_slots [splits, q, w], merged into vals/slots.
// Each returns cudaGetLastError().

// B2: q8 [q, d] int8, sq [q] f32, base8 [n, d] int8, off/sc [n] f32; d % 4 == 0.
int vdb_fused_int8_pool(const void* q8, const void* sq, const void* base8,
                        const void* off, const void* sc, void* part_vals,
                        void* part_slots, void* vals, void* slots, int q,
                        int n, int d, int w, int splits, void* stream) {
  return launch_scaled(q8, sq, base8, off, sc, part_vals, part_slots, vals,
                       slots, q, n, d, w, splits, stream);
}

// B4: the same kernel over the compressed store's own rows, int32 words
// [n, d/4] holding four int8 dims each, byte j of word c = dim 4c + j
// (little-endian): byte for byte an int8 [n, d] matrix in true dim order.
// The caller guarantees n % w == 0 (no tail pass).
int vdb_fused_packed_pool(const void* q8, const void* sq, const void* packed,
                          const void* off, const void* sc, void* part_vals,
                          void* part_slots, void* vals, void* slots, int q,
                          int n, int d, int w, int splits, void* stream) {
  if (w > 0 && n % w != 0) return (int)cudaErrorInvalidValue;
  return launch_scaled(q8, sq, packed, off, sc, part_vals, part_slots, vals,
                       slots, q, n, d, w, splits, stream);
}

// B7: q8 [q, d] int8 (one batch scale, applied by the caller), base8 [n, d]
// int8 (one corpus scale), off_i [n] int32; vals are int32 scores.
int vdb_fused_int8g_pool(const void* q8, const void* base8, const void* off_i,
                         void* part_vals, void* part_slots, void* vals,
                         void* slots, int q, int n, int d, int w, int splits,
                         void* stream) {
  if (d <= 0 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  GlobalS8 op;
  op.base = static_cast<const int32_t*>(base8);
  op.off_i = static_cast<const int32_t*>(off_i);
  return pool::launch(q8, op, part_vals, part_slots, vals, slots, q, n, d / 4,
                      w, splits, aligned16(q8, base8, d / 4), stream);
}

}  // extern "C"
