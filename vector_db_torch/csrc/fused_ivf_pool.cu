// Cluster-pruned fused scan + per-bucket winners for NVIDIA Hopper: the port
// of fused_ivf_pool (vector_db_tpu/ops/pallas_kernels.py:1153, pallas_call
// :1191, body _make_ivf_pool_kernel :1083), the kernel of
// search_mode="scan_ivf".
//
// For every probed cluster cid (counts[cid] > 0 probers) and every prober row
// p < min(counts[cid], p_cap) of its tile, over the cluster's cap grid
// positions cid*cap + c:
//
//   dist[p, c]  = off[c] + float(q8_p . v8_c) * sc[c]   (two roundings, the
//                 reference's order: __fmul_rn then __fadd_rn)
//   for each 128-column bucket b, winners t = 0..W-1 rising by value, a tie
//   to the lowest lane (the reference's argmin), the winner masked to +inf
//   before the next:  vals[row, t*(cap/128) + b] = value,
//                     pos[row, t*(cap/128) + b]  = cid*cap + b*128 + lane;
//   columns W*(cap/128)..127 of a row hold (+inf, -1).
//
// row = cid*p_cap + p.  Output rows of unprobed clusters and rows at or past a
// cluster's prober count are not written (the caller gathers only the rows of
// its (query, probe) pairs).  The s8 cross term is an exact s32 sum at any
// width below the s32 range (127^2 d < 2^31), converted to f32 once as the
// reference does, so the kernel is bit-equal to its plain PyTorch version
// (ops/kernels.fused_ivf_pool_plain).
//
// Layout: one block scores a 64-prober x 128-column tile (one bucket) with
// the s8 m16n8k32 mma.sync fragments of pool_tile.cuh (8 warps, 32 x 32
// each), staging both tiles k-chunk by k-chunk (kChunkWords words = 512
// dims at a time, so any width fits) while the s32 accumulators stay in
// registers; then it writes the f32 scores to shared memory over the staged
// chunks, and each warp picks the winners of 8 prober rows with a (value,
// lane) warp reduction.  The grid is flat over (cluster, bucket, prober tile), the
// prober tile fastest, so the blocks that read one cluster tile run together
// and find it in L2.  The TPU kernel walks a sorted worklist of probed
// clusters (scalar prefetch); here each block reads its cluster's prober count
// and returns at once when its tile lies wholly past it: at the 1M shape
// (p_cap = 512 against ~128 probers a cluster) most blocks do.
//
// What bounds it on an H100: the bytes.  A search at Q = 1024, nprobe = 64
// reads the cluster-major grid once (nlist * cap * d bytes, ~0.7 GB at 1M x
// 512) and writes small pools, while its s8 products (~1.8e11 ops) need
// ~0.1 ms of the int8 tensor cores.  Loads are not overlapped with the
// products (no cp.async/TMA ring) and wgmma is not used: later work.

#include "pool_tile.cuh"

namespace {

using pool::kMT;
using pool::kNT;
using pool::kPadWords;
using pool::kThreads;
using pool::kTN;
using pool::kTQ;
using pool::kWM;
using pool::kWN;

constexpr int kPW = 128;       // pool width of a (cluster, prober) row
constexpr int kSD = kTN + 1;   // shared score row stride (odd: no conflicts)
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = 128;  // words of one staged k-chunk: 512 dims

__device__ __forceinline__ bool key_less(float v1, int c1, float v2, int c2) {
  return v1 < v2 || (v1 == v2 && c1 < c2);
}

// Shared words of one staged row: a k-chunk's words, whole k steps, padded.
__host__ __device__ inline int chunk_stride(int dw) {
  const int cw = dw < kChunkWords ? dw : kChunkWords;
  return ((cw + 7) & ~7) + kPadWords;
}

// Words of one block's shared region: the two staged k-chunks, reused for
// the [kTQ][kSD] f32 scores once the products are done.
__host__ __device__ inline int region_words(int dw) {
  const int tiles = (kTQ + kTN) * chunk_stride(dw);
  return tiles > kTQ * kSD ? tiles : kTQ * kSD;
}

// kChunked: rows wider than one k-chunk; otherwise the chunk loop is one
// compile-time pass (a runtime loop of one pass made the narrow rows 5-9%
// slower on an H100).
template <bool kChunked>
__global__ void __launch_bounds__(kThreads)
ivf_pool_kernel(const int32_t* __restrict__ counts,  // [nlist]
                const int32_t* __restrict__ qsel,    // [nlist*p_cap, dw]
                const int32_t* __restrict__ cm,      // [nlist*cap, dw]
                const float* __restrict__ off,       // [nlist*cap]
                const float* __restrict__ sc,        // [nlist*cap]
                float* __restrict__ vals,            // [nlist*p_cap, kPW]
                int32_t* __restrict__ pos,           // [nlist*p_cap, kPW]
                int cap, int p_cap, int dw, int winners, bool vec16) {
  extern __shared__ __align__(16) int32_t smem[];
  const int ptiles = (p_cap + kTQ - 1) / kTQ;
  const int bpb = cap / kTN;
  long long blk = blockIdx.x;
  const int pt = (int)(blk % ptiles);
  blk /= ptiles;
  const int b = (int)(blk % bpb);
  const int cid = (int)(blk / bpb);
  const int live = min(counts[cid], p_cap);
  const int r0 = pt * kTQ;
  if (r0 >= live) return;  // an unprobed cluster, or a tile past its probers
  const int rows = min(kTQ, live - r0);

  const int stride = chunk_stride(dw);
  int32_t* s_q = smem;
  int32_t* s_b = smem + kTQ * stride;
  float* s_d = reinterpret_cast<float*>(smem);  // after the products
  float* s_off = reinterpret_cast<float*>(smem + region_words(dw));
  float* s_sc = s_off + kTN;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm0 = (warp >> 2) * kWM;
  const int wn0 = (warp & 3) * kWN;
  const long long qrow0 = (long long)cid * p_cap + r0;
  const long long col0 = (long long)cid * cap + (long long)b * kTN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const int chunks = kChunked ? (dw + kChunkWords - 1) / kChunkWords : 1;
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    const int k0 = kc * kChunkWords;
    const int cw = kChunked ? min(kChunkWords, dw - k0) : dw;  // its words
    const int cw8 = (cw + 7) & ~7;
    // prober rows past the count stage as zeros (their scores are never read)
    pool::stage_rows(s_q, kTQ, cw, cw8, stride, vec16,
                     [&](int r) -> const int32_t* {
                       return r < rows ? qsel + (size_t)(qrow0 + r) * dw + k0
                                       : nullptr;
                     });
    pool::stage_rows(s_b, kTN, cw, cw8, stride, vec16,
                     [&](int r) -> const int32_t* {
                       return cm + (size_t)(col0 + r) * dw + k0;
                     });
    if (k0 == 0 && tid < kTN) {
      s_off[tid] = off[col0 + tid];
      s_sc[tid] = sc[col0 + tid];
    }
    __syncthreads();

    for (int kw = 0; kw < cw8; kw += 8) {  // one k step = 8 words = 32 dims
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
        for (int mt = 0; mt < kMT; ++mt)
          pool::mma(acc[mt][nt], a[mt], b0, b1);
      }
    }
    // every warp is done with the chunk, which the next chunk or s_d
    // overwrites
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm0 + 16 * mt + g + 8 * (i >> 1);
        const int col = wn0 + 8 * nt + 2 * t + (i & 1);
        s_d[row * kSD + col] = __fadd_rn(
            s_off[col], __fmul_rn(__int2float_rn(acc[mt][nt][i]), s_sc[col]));
      }
  __syncthreads();

  const int used = winners * bpb;
  for (int r = warp; r < rows; r += kWarps) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = s_d[r * kSD + lane + 32 * j];
    float* out_v = vals + (size_t)(qrow0 + r) * kPW;
    int32_t* out_p = pos + (size_t)(qrow0 + r) * kPW;
    for (int w = 0; w < winners; ++w) {
      float bv = v[0];
      int bc = lane;
#pragma unroll
      for (int j = 1; j < 4; ++j)
        if (key_less(v[j], lane + 32 * j, bv, bc)) {
          bv = v[j];
          bc = lane + 32 * j;
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
        if (key_less(ov, oc, bv, bc)) {
          bv = ov;
          bc = oc;
        }
      }
      // every lane holds the winner; its owner masks it for the next round
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (bc == lane + 32 * j) v[j] = INFINITY;
      if (lane == 0) {
        out_v[w * bpb + b] = bv;
        out_p[w * bpb + b] = (int32_t)(col0 + bc);
      }
    }
    if (b == 0)
      for (int c = used + lane; c < kPW; c += 32) {
        out_v[c] = INFINITY;
        out_p[c] = -1;
      }
  }
}

}  // namespace

extern "C" {

// counts [nlist] int32 (probers of each cluster, 0 = not probed), qsel
// [nlist*p_cap, dw] and cm [nlist*cap, dw] int32 words of four int8 dims each,
// off/sc [nlist*cap] f32, vals/pos [nlist*p_cap, 128].  cap % 128 == 0 and
// winners * cap / 128 <= 128.  Launches on `stream`; returns
// cudaGetLastError().
int vdb_fused_ivf_pool(const void* counts, const void* qsel, const void* cm,
                       const void* off, const void* sc, void* vals, void* pos,
                       int nlist, int cap, int p_cap, int dw, int winners,
                       void* stream) {
  if (nlist <= 0 || cap <= 0 || cap % kTN != 0 || p_cap <= 0 || dw <= 0 ||
      winners < 1 || winners * (cap / kTN) > kPW)
    return (int)cudaErrorInvalidValue;
  const int smem = (region_words(dw) + 2 * kTN) * 4;
  const long long blocks =
      (long long)nlist * (cap / kTN) * ((p_cap + kTQ - 1) / kTQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto kernel = dw > kChunkWords ? &ivf_pool_kernel<true>
                                       : &ivf_pool_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec16 = dw % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(qsel) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cm) % 16 == 0;
  kernel<<<(unsigned)blocks, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(qsel),
      static_cast<const int32_t*>(cm), static_cast<const float*>(off),
      static_cast<const float*>(sc), static_cast<float*>(vals),
      static_cast<int32_t*>(pos), cap, p_cap, dw, winners, vec16);
  return (int)cudaGetLastError();
}

}  // extern "C"
