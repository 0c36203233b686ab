// Fused PQ decode + bf16 scan + strided-bucket min pool, for NVIDIA Hopper:
// the bf16 instance of the wgmma tile loop (pool_wgmma.cuh) with a producer
// that decodes codes into the ring.
//
// Replaces the TPU kernel `fused_adc_pool` of
// vector_db_tpu/ops/pallas_kernels.py (:284, pallas_call at :338; body
// `_make_adc_pool_kernel` :229-278).
//
// What it computes, for bf16 queries q16 [Q, d8] in PQ space (d = S * sd,
// d8 = d rounded up to 8, the extra columns zero), codes_t [S, N] uint8 (row
// s at codes + s * ld), the codebooks as cbk [S, K, sd] bf16 (cbk[s, c, j] =
// bf16_rn(codebooks[s, c, j]), rounded to nearest even by the wrapper, so a
// decoded value is bit for bit the decode kernel's, pq_decode.cu) and
// masked_norms [N] f32 (+inf at dead slots):
//
//   recon(n)   = the concatenation over s of cbk[s, codes_t[s, n], :]  [d]
//   score(q,n) = masked_norms[n] - 2 * (q16 . recon(n))   (f32 sums)
//   vals[q, c] = min over passes j of score(q, c + j*W), slots[q, c] its
//                slot; +inf / -1 where empty.
//
// It is B6's tile loop with a decode in place of the TMA row copy: each
// ring stage, [128 columns x 64 dims], is decoded straight into the
// swizzled shared tile, so neither the [d, N] reconstruction nor the
// [Q, N] scores reach device memory.  One (column, subspace) is one
// cp.async of its codebook entry from the [S, K, sd] table (16 bytes at
// sd = 8; the table is 256 KB at d = 512, K = 256 and stays in L2); thread
// (warp u, lane c) of the producer warpgroup decodes columns 4c .. 4c+3 of
// the stage's units u, u+4, ... with one 4-byte load of their four codes
// (byte loads where the code rows are not 4-byte aligned or at N), and,
// for entries of 16 or 8 bytes, loads the next stage's codes while the
// copies of this one fly.  A stage is
// handed to the consumers after cp.async.wait_group and
// fence.proxy.async.shared::cta (the copies are generic-proxy writes that
// wgmma, an async-proxy reader, would not otherwise see).  Dims past d and
// slots past N are written as zeros (and those slots score +inf through
// their norms).  Rows past 640 dims stream the query tile through the ring
// (pool_wgmma.cuh's streamed layout: one TMA of the stage's query slab by
// warp 0's lane 0 beside the decode, counted on the stage's full barrier).
// Any K <= 256 indexes the table directly; entries of 16, 8, 4
// or 2 bytes (the largest unit that divides the entry and the table's
// alignment) are template instances.  The epilogue rounds each operation
// (__fmul_rn, __fsub_rn).
//
// What bounds it on an H100: at the main path's shape (Q = 1024, a 524,288-
// column chunk, d = 512) the 5.5e11 bf16 multiply-adds.  The decode is redone
// for each 128-query tile (8 times at Q = 1024, as the reference notes at
// :303-305), 128 KB of L2 gathers per block and pass.  The f32 sums run in the
// tensor cores' order, so the scores agree with the plain version within the
// f32 summation-order bound 2 d 2^-24 (|q|.|recon|) * 2.

#include "pool_wgmma.cuh"

namespace {

constexpr int kTK = wg::Bf16Mma::kDims;  // dims of one k-chunk

// Copy kUnit bytes global -> shared (cp.async; 2 bytes by a plain load).
template <int kUnit>
__device__ __forceinline__ void copy_unit(uint32_t dst, const void* src) {
  if constexpr (kUnit >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(kUnit)
                 : "memory");
  } else {
    const unsigned short v = __ldg(static_cast<const unsigned short*>(src));
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

template <int kUnit>
__device__ __forceinline__ void zero_unit(uint32_t dst) {
  if constexpr (kUnit == 16) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
                 "r"(0)
                 : "memory");
  } else if constexpr (kUnit == 8) {
    asm volatile("st.shared.v2.u32 [%0], {%1, %1};\n" ::"r"(dst), "r"(0)
                 : "memory");
  } else if constexpr (kUnit == 4) {
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(0) : "memory");
  } else {
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst),
                 "h"((unsigned short)0)
                 : "memory");
  }
}

template <int kUnit>
struct AdcDecode {
  using Mma = wg::Bf16Mma;
  using Val = float;
  static constexpr int kFullArrivals = 4;     // one per producer warp
  static constexpr int kPer = 32 / kUnit;     // units a thread decodes a stage
  static constexpr bool kPrefetch = kUnit >= 8;  // codes of the next stage
  const uint8_t* codes;
  long long ld;
  const __nv_bfloat16* cbk;
  const float* norms;
  int d, sd, K;
  bool codes4;  // code rows 4-byte aligned: one load for four columns

  __device__ __forceinline__ static float init() { return INFINITY; }
  __device__ __forceinline__ static bool live(float v) { return isfinite(v); }
  __device__ __forceinline__ float row_value(int, int) const { return 0.f; }
  __device__ __forceinline__ static float score(float acc, float o, float,
                                               float) {
    return __fsub_rn(o, __fmul_rn(2.f, acc));
  }
  __device__ __forceinline__ void col_values(long long slot, int N,
                                             float& v0, float& v1) const {
    v0 = slot < N ? __ldg(norms + slot) : INFINITY;
    v1 = 0.f;
  }

  // The codes of columns row0 + 4 cg .. + 3 (byte b = column 4 cg + b) in
  // the subspace of unit m of k-chunk kc (0 past d or N).
  __device__ __forceinline__ uint32_t code_word(long long row0, int kc, int N,
                                                int cg, int m) const {
    const long long col0 = row0 + 4 * cg;
    const int dim0 = kTK * kc + m * (kUnit / 2);
    if (dim0 >= d || col0 >= N) return 0;
    const uint8_t* src = codes + (size_t)(dim0 / sd) * ld + col0;
    if (codes4 && col0 + 4 <= N)
      return __ldg(reinterpret_cast<const uint32_t*>(src));
    uint32_t cw = 0;
    for (int b = 0; b < 4; ++b)
      if (col0 + b < N) cw |= (uint32_t)__ldg(src + b) << (8 * b);
    return cw;
  }

  // Decode unit m of those four columns into the stage at shared address
  // `stage`: column r, byte ob of its 128-byte row lands at r*128 +
  // ((ob/16) ^ (r%8))*16 + ob%16, the 128-byte swizzle of the wgmma
  // descriptors.
  __device__ __forceinline__ void decode_unit(uint32_t stage, uint32_t cw,
                                             long long row0, int kc, int N,
                                             int cg, int m) const {
    const int ob = m * kUnit;
    const int dim0 = kTK * kc + ob / 2;
    const int s = dim0 / sd;
    const __nv_bfloat16* entry = cbk + (size_t)s * K * sd + (dim0 - s * sd);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = 4 * cg + b;
      const uint32_t dst =
          stage + r * 128 + ((((ob >> 4) ^ (r & 7)) << 4) | (ob & 15));
      if (dim0 < d && row0 + r < N)
        copy_unit<kUnit>(dst, entry + (size_t)((cw >> (8 * b)) & 255) * sd);
      else
        zero_unit<kUnit>(dst);
    }
  }

  // Thread (warp ul, lane cg) decodes units ul, ul + 4, ... of a stage:
  // with kPrefetch from the codes loaded during the previous stage, else
  // one unit at a time (entries of 4 or 2 bytes: many units, few
  // registers).
  __device__ __forceinline__ void load_codes(uint32_t (&cw)[kPer],
                                             long long row0, int kc, int N,
                                             int cg, int ul) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      cw[i] = code_word(row0, kc, N, cg, ul + 4 * i);
  }
  __device__ __forceinline__ void decode_stage(uint32_t stage,
                                               const uint32_t (&cw)[kPer],
                                               long long row0, int kc,
                                               int N, int cg,
                                               int ul) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      uint32_t c;
      if constexpr (kPrefetch)
        c = cw[i];
      else
        c = code_word(row0, kc, N, cg, ul + 4 * i);
      decode_unit(stage, c, row0, kc, N, cg, ul + 4 * i);
    }
  }

  // All four producer warps decode; stage `it` is handed over once stage
  // it+1's copies are started, so two stages of gathers are in flight a
  // thread.
  __device__ __forceinline__ void produce(const wg::Ring& r,
                                          const CUtensorMap*, int N, int W,
                                          int c0, int p_begin,
                                          int p_end) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int total = (p_end - p_begin) * r.kc_n;
    if (total <= 0) return;
    uint32_t cur[kPer], nxt[kPer];  // unused without kPrefetch
    float v0[4], v1[4];
    int kc = 0, pl = 0, s = 0;
    uint32_t ph = 0;
    long long row0 = (long long)p_begin * W + c0;
    if constexpr (kPrefetch) load_codes(cur, row0, 0, N, lane, warp);
    for (int it = 0; it < total; ++it) {
      if (warp == 0 && kc == 0) wg::col_load(*this, row0, N, lane, v0, v1);
      wg::wait(r.empty + 8 * s, ph ^ 1);
      if (warp == 0 && lane == 0) wg::stream_query<kTK>(r, s, kc);
      decode_stage(wg::slab(r, s), cur, row0, kc, N, lane, warp);
      wg::cp_async_commit();
      int nkc = kc + 1;
      long long nrow0 = row0;
      if (nkc == r.kc_n) {
        nkc = 0;
        nrow0 += W;
      }
      if constexpr (kPrefetch) {
        if (it + 1 < total) load_codes(nxt, nrow0, nkc, N, lane, warp);
      }
      if (it > 0) {
        wg::cp_async_wait<1>();
        wg::hand_over(r, (it - 1) % r.stages, lane);
      }
      if (warp == 0 && kc == r.kc_n - 1) wg::col_store(r, pl, lane, v0, v1);
      if (++s == r.stages) {
        s = 0;
        ph ^= 1;
      }
      if constexpr (kPrefetch) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) cur[i] = nxt[i];
      }
      if (nkc == 0) ++pl;
      kc = nkc;
      row0 = nrow0;
    }
    wg::cp_async_wait<0>();
    wg::hand_over(r, (total - 1) % r.stages, lane);
  }
};

template <int kUnit>
int launch_unit(const void* q16, const uint8_t* codes, long long ld,
                const void* cbk, const void* norms, void* part_vals,
                void* part_slots, void* vals, void* slots, int q, int n,
                int S, int sd, int K, int w, int splits, int stages,
                int streamed, void* stream) {
  AdcDecode<kUnit> op;
  op.codes = codes;
  op.ld = ld;
  op.cbk = static_cast<const __nv_bfloat16*>(cbk);
  op.norms = static_cast<const float*>(norms);
  op.d = S * sd;
  op.sd = sd;
  op.K = K;
  op.codes4 = reinterpret_cast<uintptr_t>(codes) % 4 == 0 && ld % 4 == 0;
  const int d8 = (S * sd + 7) & ~7;
  return wg::launch(q16, d8, nullptr, op, part_vals, part_slots, vals, slots,
                    q, n, d8, w, splits, stages, streamed, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`.  q16 [q, d8] bf16 contiguous (d8 = S*sd rounded up to
// 8, the extra columns zero, 16-byte aligned); codes: S rows of n uint8
// codes < K <= 256, row stride ld >= n bytes; cbk [S, K, sd] bf16
// contiguous; norms [n] f32; w % 128 == 0; `stages` ring stages and the
// resident (streamed == 0) or streamed query tile, as ops/kernels.wgmma_plan
// chooses them.  With splits == 1 the kernel writes vals/slots [q, w]
// directly; otherwise part_vals/part_slots [splits, q, w], merged into
// vals/slots.  Returns 0, a cudaError_t, or wg::kTensorMapError + a
// CUresult.
int vdb_fused_adc_pool(const void* q16, const void* codes, long long ld,
                       const void* cbk, const void* norms, void* part_vals,
                       void* part_slots, void* vals, void* slots, int q, int n,
                       int S, int sd, int K, int w, int splits, int stages,
                       int streamed, void* stream) {
  if (S <= 0 || sd <= 0 || K <= 0 || K > 256 || ld < n)
    return (int)cudaErrorInvalidValue;
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  // the widest unit that divides a codebook entry and the table's alignment
  const uintptr_t base = reinterpret_cast<uintptr_t>(cbk);
  int unit = 2;
  for (int u = 16; u > 2; u /= 2)
    if ((sd * 2) % u == 0 && base % u == 0) {
      unit = u;
      break;
    }
  switch (unit) {
    case 16:
      return launch_unit<16>(q16, c, ld, cbk, norms, part_vals, part_slots,
                             vals, slots, q, n, S, sd, K, w, splits,
                            stages, streamed, stream);
    case 8:
      return launch_unit<8>(q16, c, ld, cbk, norms, part_vals, part_slots,
                            vals, slots, q, n, S, sd, K, w, splits,
                            stages, streamed, stream);
    case 4:
      return launch_unit<4>(q16, c, ld, cbk, norms, part_vals, part_slots,
                            vals, slots, q, n, S, sd, K, w, splits,
                            stages, streamed, stream);
    default:
      return launch_unit<2>(q16, c, ld, cbk, norms, part_vals, part_slots,
                            vals, slots, q, n, S, sd, K, w, splits,
                            stages, streamed, stream);
  }
}

}  // extern "C"
