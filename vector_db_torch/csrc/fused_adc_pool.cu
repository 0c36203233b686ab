// Fused PQ decode + bf16 scan + strided-bucket min pool, for NVIDIA Hopper.
//
// Replaces the TPU kernel `fused_adc_pool` of
// vector_db_tpu/ops/pallas_kernels.py (:284, pallas_call at :338; body
// `_make_adc_pool_kernel` :229-278).
//
// What it computes, for bf16 queries q16 [Q, d] in PQ space, codes_t [S, N]
// uint8 (row s at codes + s * ld), the codebooks as cbk [S, K, sd] bf16
// (cbk[s, c, j] = bf16_rn(codebooks[s, c, j]), rounded to nearest even by
// the wrapper, so a decoded value is bit for bit the decode kernel's,
// pq_decode.cu) and masked_norms [N] f32 (+inf at dead slots):
//
//   recon(n)   = the concatenation over s of cbk[s, codes_t[s, n], :]  [d]
//   score(q,n) = masked_norms[n] - 2 * (q16 . recon(n))   (f32 sums)
//   vals[q, c] = min over passes j of score(q, c + j*W), slots[q, c] its
//                slot; +inf / -1 where empty.
//
// It is the bf16 pool of fused_int8_pool.cu (the tile loop of
// pool_tile.cuh) with a decode in place of the row copy: each pass decodes
// its 128 columns straight into the shared bf16 tile [128][d], so neither
// the [d, N] reconstruction nor the [Q, N] scores reach device memory.  One
// (column, subspace) is one load of sd bf16 from the [S, K, sd] table (16
// bytes at sd = 8; the table is 256 KB at d = 512, K = 256 and stays in L2),
// and the 128 codes of a subspace are one contiguous 128-byte read of the
// uint8 code row (a column slice of the [S, cap] matrix is read in place).
// Any K <= 256 indexes the table directly; a ragged N is masked in the
// kernel (slots past N decode to zeros and score +inf), so nothing is padded
// or copied.  The epilogue rounds each operation (__fmul_rn, __fsub_rn).
//
// What bounds it on an H100: at the main path's shape (Q = 1024, a 524,288-
// column chunk, d = 512) the 5.5e11 bf16 multiply-adds.  The decode is
// redone for each 64-query tile (16 times at Q = 1024, as the reference
// notes at :303-305); each decode reads as many bytes from L2 as the bf16
// row copy of fused_raw_pool reads from device memory.  The f32 sums run in
// the tensor cores' order, so the scores agree with the plain version within
// the f32 summation-order bound 2 d 2^-24 (|q|.|recon|) * 2.

#include "pool_tile.cuh"

namespace {

struct AdcBf16 {
  using Acc = float;
  using Val = float;
  using Col = float;
  const uint8_t* codes;
  long long ld;
  const __nv_bfloat16* cbk;
  const float* norms;
  int S, sd, K;
  int unit;  // bytes per load of a codebook entry: 16, 8, 4 or 2

  __device__ static float init() { return INFINITY; }
  __device__ float row_value(int, int) const { return 0.f; }

  // zero the pad words past the d dims of every tile row, once: the decode
  // writes only the first d bf16 of a row
  __device__ void prepare(int32_t* s_b, int dw, int dw8, int stride) const {
    const int pad = dw8 - dw;
    for (int i = threadIdx.x; i < pool::kTN * pad; i += pool::kThreads)
      s_b[(i / pad) * stride + dw + i % pad] = 0;
  }

  __device__ void stage(int32_t* s_b, long long row0, int N, int, int,
                        int stride, bool) const {
    const int entry = sd * 2;  // bytes of one codebook entry
    if (unit == 16) {
      stage16(s_b, row0, N, stride, entry / 16);
      return;
    }
    for (int i = threadIdx.x; i < pool::kTN * S; i += pool::kThreads) {
      const int r = i % pool::kTN;
      const int s = i / pool::kTN;
      const long long slot = row0 + r;
      char* dst = reinterpret_cast<char*>(s_b + r * stride) + s * entry;
      const char* src = nullptr;
      if (slot < N) {
        const int code = __ldg(codes + (size_t)s * ld + slot);
        src = reinterpret_cast<const char*>(cbk + ((size_t)s * K + code) * sd);
      }
      switch (unit) {
        case 16:
          for (int b = 0; b < entry; b += 16)
            *reinterpret_cast<int4*>(dst + b) =
                src ? __ldg(reinterpret_cast<const int4*>(src + b))
                    : make_int4(0, 0, 0, 0);
          break;
        case 8:
          for (int b = 0; b < entry; b += 8)
            *reinterpret_cast<int2*>(dst + b) =
                src ? __ldg(reinterpret_cast<const int2*>(src + b))
                    : make_int2(0, 0);
          break;
        case 4:
          for (int b = 0; b < entry; b += 4)
            *reinterpret_cast<int*>(dst + b) =
                src ? __ldg(reinterpret_cast<const int*>(src + b)) : 0;
          break;
        default:
          for (int b = 0; b < entry; b += 2)
            *reinterpret_cast<unsigned short*>(dst + b) =
                src ? __ldg(reinterpret_cast<const unsigned short*>(src + b))
                    : (unsigned short)0;
      }
    }
  }

  // The decode when an entry is whole 16-byte vectors (sd % 8 == 0, the
  // main path's sd = 8): item i is vector `part` of the entry of column r
  // in subspace s.  Each thread loads kBatch codes, then their kBatch table
  // vectors, then stores them, so kBatch independent code -> table chains
  // are in flight at once instead of one (the loads come from L2).
  __device__ void stage16(int32_t* s_b, long long row0, int N, int stride,
                          int parts) const {
    constexpr int kBatch = 8;
    const int items = pool::kTN * S * parts;
    for (int i0 = threadIdx.x; i0 < items; i0 += pool::kThreads * kBatch) {
      int code[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * pool::kThreads;
        const int r = i % pool::kTN;
        const int s = i / pool::kTN / parts;
        code[u] = -1;
        if (i < items && row0 + r < N)
          code[u] = __ldg(codes + (size_t)s * ld + row0 + r);
      }
      int4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * pool::kThreads;
        const int rest = i / pool::kTN;
        const int s = rest / parts;
        v[u] = make_int4(0, 0, 0, 0);
        if (code[u] >= 0)
          v[u] = __ldg(reinterpret_cast<const int4*>(
                           cbk + ((size_t)s * K + code[u]) * sd) +
                       (rest - s * parts));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * pool::kThreads;
        if (i >= items) break;
        const int r = i % pool::kTN;
        const int rest = i / pool::kTN;
        const int s = rest / parts;
        *reinterpret_cast<int4*>(reinterpret_cast<char*>(s_b + r * stride) +
                                 s * sd * 2 + (rest - s * parts) * 16) = v[u];
      }
    }
  }

  __device__ void stage_cols(float* c0, float* c1, int i, long long slot,
                             int N) const {
    c0[i] = slot < N ? norms[slot] : INFINITY;
    c1[i] = 0.f;
  }
  __device__ static float score(float acc, float o, float, float) {
    return __fsub_rn(o, __fmul_rn(2.f, acc));
  }
  __device__ static int32_t final_slot(float v, int32_t s) {
    return isfinite(v) ? s : -1;
  }
};

}  // namespace

extern "C" {

// Launch on `stream`.  q16 [q, S*sd] bf16 contiguous, S*sd even; codes: S
// rows of n uint8 codes < K <= 256, row stride ld >= n bytes; cbk
// [S, K, sd] bf16 contiguous; norms [n] f32; w % 128 == 0.  With
// splits == 1 the kernel writes vals/slots [q, w] directly; otherwise
// part_vals/part_slots [splits, q, w], merged into vals/slots.  Returns
// cudaGetLastError().
int vdb_fused_adc_pool(const void* q16, const void* codes, long long ld,
                       const void* cbk, const void* norms, void* part_vals,
                       void* part_slots, void* vals, void* slots, int q, int n,
                       int S, int sd, int K, int w, int splits, void* stream) {
  const int d = S * sd;
  if (S <= 0 || sd <= 0 || d % 2 != 0 || K <= 0 || K > 256 || ld < n)
    return (int)cudaErrorInvalidValue;
  AdcBf16 op;
  op.codes = static_cast<const uint8_t*>(codes);
  op.ld = ld;
  op.cbk = static_cast<const __nv_bfloat16*>(cbk);
  op.norms = static_cast<const float*>(norms);
  op.S = S;
  op.sd = sd;
  op.K = K;
  const uintptr_t base = reinterpret_cast<uintptr_t>(cbk);
  op.unit = 2;
  for (int u = 16; u > 2; u /= 2)
    if ((sd * 2) % u == 0 && base % u == 0) {
      op.unit = u;
      break;
    }
  const bool vec16 = (d / 2) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(q16) % 16 == 0;
  return pool::launch(q16, op, part_vals, part_slots, vals, slots, q, n, d / 2,
                      w, splits, vec16, stream);
}

}  // extern "C"
