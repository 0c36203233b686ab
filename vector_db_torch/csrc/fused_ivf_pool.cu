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
// cluster's prober count are never written (the caller gathers only the rows
// of its (query, probe) pairs).  The s8 cross term is an exact s32 sum at any
// width below the s32 range (127^2 d < 2^31), converted to f32 once as the
// reference does, so the kernel is bit-equal to its plain PyTorch version
// (ops/kernels.fused_ivf_pool_plain).
//
// Layout: the wgmma tile loop of pool_wgmma.cuh with "pass" read as
// "bucket".  One block (384 threads) owns a (cluster, 128-prober tile) and
// walks the cluster's buckets: the producer warpgroup loads the prober tile
// once (TMA; it stays resident, or past 1,280 dims streams beside each
// stage) and streams the cluster's buckets through the ring, four
// [128 columns x 128 bytes] k-chunks a bucket at 512 dims, by TMA from a
// 2-D map over the grid's rows (or by the cp.async producer where rows are
// not whole 16-byte vectors), with each bucket's 128 off/sc values in the
// per-column double buffer; the two consumer warpgroups run s8 wgmma
// m64n128k32 on 64 prober rows each.  After a bucket's last k-chunk a
// consumer thread holds 2 rows x 32 of the bucket's 128 scores in its
// accumulator registers (a row's columns lie across the 4 lanes of a quad):
// bucket_winners scores them in place and picks the winners there.  No
// score tile in shared memory, no block-wide barrier in the loop.
//
// The TPU kernel walks a sorted worklist of probed clusters (scalar
// prefetch).  Here a one-block kernel ahead of the scan lists the live
// (cluster, prober tile) pairs from the device-built counts, the clusters
// with most probers first, so the host never reads them; block x of the
// scan takes pair x and returns when there is none.  The caller sizes the
// grid by what it knows: every pair (nlist * ceil(p_cap / 128)), or fewer
// when it knows how many probes the batch makes; and when the pairs cannot
// fill the card (one query probes 64 clusters on 132 SMs) it splits each
// cluster's buckets over gridDim.y: buckets write disjoint columns, so a
// split needs no merge (ops/kernels.ivf_pool_plan mirrors this arithmetic).
//
// What bounds it on an H100: the bytes, then the winner picking.  A search
// at Q = 1024, nprobe = 64 reads the probed clusters' rows once (~0.65 GB
// of a 1M x 512 grid) and writes 1 KB a live prober row, while its s8
// products (~1.8e11 ops) need ~0.1 ms of the int8 tensor cores: the ring
// keeps up to nine 16 KB loads in flight a block while the consumers work.
// With 128 live rows a tile, the four winners of each row and bucket cost
// more than the bucket's load (compares and selects, which run at half
// rate); with the ~13 rows of a 10M grid's tile the bytes are the bound.

#include "pool_wgmma.cuh"

namespace {

constexpr int kPW = 128;  // pool width of a (cluster, prober) row
constexpr int kWorklistThreads = 1024;

__device__ __forceinline__ bool key_less(float v1, int c1, float v2, int c2) {
  return v1 < v2 || (v1 == v2 && c1 < c2);
}

// One level of row_argmin's tree: the N pairwise minima of 2 N candidates,
// the right-hand one winning only when strictly smaller.
template <int N>
__device__ __forceinline__ void argmin_level(float (&v)[16], int (&m)[16]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool lt = v[2 * k + 1] < v[2 * k];
    v[k] = lt ? v[2 * k + 1] : v[2 * k];
    m[k] = lt ? m[2 * k + 1] : m[2 * k];
  }
}

// The smallest of the 16 pair heads acc[4 k + 2 h] (f32 bits) of accumulator
// row h and its pair k: a tree of depth 4 (the compares of a level are
// independent), which keeps the lowest pair of a tie as a left-to-right scan
// would.
__device__ __forceinline__ void row_argmin(const int32_t (&acc)[64], int h,
                                           float& bv, int& bk) {
  float v[16];
  int m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    v[k] = __int_as_float(acc[4 * k + 2 * h]);
    m[k] = k;
  }
  argmin_level<8>(v, m);
  argmin_level<4>(v, m);
  argmin_level<2>(v, m);
  argmin_level<1>(v, m);
  bv = v[0];
  bk = m[0];
}

// A bucket's winners for the thread's two accumulator rows (row h
// is prober row `row + 8 h` of the tile, its 32 entries the pairs
// (acc[4 k + 2 h], acc[4 k + 2 h + 1]), k < 16, at columns 8 k + 2 t and
// + 1; t the thread's lane in its quad, which holds the row's 128 columns).
//
// The s32 sums are scored in place (cv: the bucket's [2][128] off and sc)
// and each pair is put in order once, its smaller score (the lower column
// on a tie) in front, with one bit a pair in `src` saying which column that
// is.  A winner is then the (value, column) minimum of the thread's 16 pair
// heads, reduced over the quad by two shuffles; its owner moves the pair's
// other score to the front for the next round, and the quad's lane w % 4
// stores winner w of a live row (ok[h]) straight to its pool row,
// vals/pos[out + 8 h * 128 + w * stride] (value, and position `first` +
// column; out: the bucket's column of row `row`; stride: the buckets of a
// cluster).
__device__ __forceinline__ void bucket_winners(
    int32_t (&acc)[64], const float* cv, int t, int winners, int first,
    int stride, const bool (&ok)[2], size_t out, float* __restrict__ vals,
    int32_t* __restrict__ pos) {
  float* out_v[2];
  int32_t* out_p[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    out_v[h] = vals + out + (size_t)h * 8 * kPW;
    out_p[h] = pos + out + (size_t)h * 8 * kPW;
  }
  uint32_t src[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) src[h] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float2 o = *reinterpret_cast<const float2*>(cv + 8 * k + 2 * t);
    const float2 c =
        *reinterpret_cast<const float2*>(cv + wg::kTN + 8 * k + 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * k + 2 * h;
      const float a = __fadd_rn(o.x, __fmul_rn(__int2float_rn(acc[i]), c.x));
      const float b =
          __fadd_rn(o.y, __fmul_rn(__int2float_rn(acc[i + 1]), c.y));
      const bool lt = b < a;
      acc[i] = __float_as_int(lt ? b : a);
      acc[i + 1] = __float_as_int(lt ? a : b);
      src[h] |= lt ? 1u << k : 0u;
    }
  }
  // the two rows' rounds side by side: trees, shuffles, stores, updates
  for (int w = 0; w < winners; ++w) {
    float bv[2];
    int bc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int bk;
      row_argmin(acc, h, bv[h], bk);
      bc[h] = 8 * bk + 2 * t + ((src[h] >> bk) & 1);
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv[h], o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc[h], o);
        if (key_less(ov, oc, bv[h], bc[h])) {
          bv[h] = ov;
          bc[h] = oc;
        }
      }
    }
    // the quad agrees on each row's winner
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ok[h] && (w & 3) == t) {
        out_v[h][w * stride] = bv[h];
        out_p[h][w * stride] = first + bc[h];
      }
      const int mine = ((bc[h] >> 1) & 3) == t ? bc[h] >> 3 : -1;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k == mine) {
          acc[4 * k + 2 * h] = acc[4 * k + 2 * h + 1];
          acc[4 * k + 2 * h + 1] = __float_as_int(INFINITY);
        }
      src[h] ^= mine >= 0 ? 1u << mine : 0u;
    }
  }
}

// The per-position values of a bucket: (off, sc) of grid positions.
struct Cluster {
  using Mma = wg::S8Mma;
  const float* off;
  const float* sc;
  __device__ __forceinline__ void col_values(long long slot, int N,
                                             float& v0, float& v1) const {
    v0 = slot < N ? __ldg(off + slot) : INFINITY;
    v1 = slot < N ? __ldg(sc + slot) : 0.f;
  }
};

// work[0] = the number of live (cluster, prober tile) pairs, work[1 + i] =
// pair i as cid * ptiles + tile.  A cluster's tiles are next to each other
// (their blocks run together, and the later ones find the cluster's rows
// in L2), and the clusters with more probers come first (sixteen classes by
// prober count: a block's time grows with its live rows, and the blocks
// run in this order, so the short ones fill the last wave).  One block;
// the order within a class is whatever the atomics give, which the scan's
// output does not depend on.
__global__ void __launch_bounds__(kWorklistThreads)
ivf_worklist_kernel(const int32_t* __restrict__ counts,
                    int32_t* __restrict__ work, int nlist, int p_cap,
                    int ptiles) {
  constexpr int kClasses = 16;
  __shared__ int at[kClasses];  // pairs of each class, then its cursor
  if (threadIdx.x < kClasses) at[threadIdx.x] = 0;
  __syncthreads();
  // class 0: the fullest sixteenth of p_cap ... class 15: the emptiest
  auto cls = [&](int live) {
    return kClasses - 1 - (int)((long long)(live - 1) * kClasses / p_cap);
  };
  auto tiles_of = [](int live) { return (live + wg::kTQ - 1) / wg::kTQ; };
  for (int cid = threadIdx.x; cid < nlist; cid += kWorklistThreads) {
    const int live = min(counts[cid], p_cap);
    if (live > 0) atomicAdd(&at[cls(live)], tiles_of(live));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int c = 0; c < kClasses; ++c) {
      const int n = at[c];
      at[c] = sum;
      sum += n;
    }
    work[0] = sum;
  }
  __syncthreads();
  for (int cid = threadIdx.x; cid < nlist; cid += kWorklistThreads) {
    const int live = min(counts[cid], p_cap);
    if (live <= 0) continue;
    const int tiles = tiles_of(live);
    const int i0 = atomicAdd(&at[cls(live)], tiles);
    for (int i = 0; i < tiles; ++i) work[1 + i0 + i] = cid * ptiles + i;
  }
}

template <class Op>
__global__ void __launch_bounds__(wg::kThreads, 1)
ivf_pool_kernel(const __grid_constant__ CUtensorMap qmap,  // the prober rows
                const __grid_constant__ CUtensorMap rmap,  // the grid's rows
                const Op op,
                const int32_t* __restrict__ counts,  // [nlist]
                const int32_t* __restrict__ work,    // the live pairs
                float* __restrict__ vals,            // [nlist*p_cap, kPW]
                int32_t* __restrict__ pos,           // [nlist*p_cap, kPW]
                int n_pos, int cap, int p_cap, int ptiles, int winners,
                int kc_n, int stages, int streamed, int buckets_per_split) {
  using Mma = typename Op::Mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if ((int)blockIdx.x >= work[0]) return;  // no pair left for this block
  const int pair = work[1 + blockIdx.x];
  const int cid = pair / ptiles;
  const int r0 = (pair - cid * ptiles) * wg::kTQ;
  // the tile's live rows: rows at or past it are read (a neighbour's
  // probers, or zeros past the end) and never written
  const int rows = min(counts[cid], p_cap) - r0;
  const int bpb = cap / wg::kTN;
  const int b_begin = blockIdx.y * buckets_per_split;
  const int b_end = min(bpb, b_begin + buckets_per_split);
  wg::Ring r;
  wg::ring_init(r, smem_raw, &qmap, cid * p_cap + r0, kc_n, stages, streamed,
                Op::kFullArrivals);

  // warp roles and the flag that guards the wgmmas are shuffled from lane 0
  // (provably warp-uniform), as in pool_kernel
  const int role = __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
  if (role == 0) {
    // ---- producer warpgroup: bucket b is "pass" b of width 128 from the
    // cluster's first position
    wg::setmaxnreg_dec<wg::kProducerRegs>();
    wg::load_query_tile<Mma>(r);
    op.produce(r, &rmap, n_pos, wg::kTN, cid * cap, b_begin, b_end);
  } else {
    // ---- consumer warpgroups: prober rows r0 + 64 cw .. + 63
    wg::setmaxnreg_inc<wg::kConsumerRegs>();
    const int cw = role - 1;
    const int ct = threadIdx.x & 127;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row = 64 * cw + 16 * (ct >> 5) + g;  // and row + 8
    // below 65 live rows the second warpgroup only keeps the protocol
    const bool active = __shfl_sync(0xffffffffu, 64 * cw < rows, 0);
    const size_t out = ((size_t)cid * p_cap + r0 + row) * kPW;
    const bool ok[2] = {row < rows, row + 8 < rows};
    int32_t acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    // a warp whose 16 rows are all dead skips the epilogue (warp-uniform)
    const int warp_row = 64 * cw + 16 * (ct >> 5);
    const bool warp_live = warp_row < rows;
    if (warp_live && gridDim.y == 1) {
      // The block owns its rows' whole pool rows: write them once as whole
      // 16-byte vectors of (+inf, -1), which also are the unused columns'
      // values, so the winners' 4-byte stores land in sectors that L2
      // holds complete and need no fill from device memory.
      const int live = min(16, rows - warp_row);
      const size_t o0 =
          ((size_t)cid * p_cap + r0 + warp_row) * kPW + 4 * lane;
      for (int i = 0; i < live; ++i) {
        *reinterpret_cast<float4*>(vals + o0 + (size_t)i * kPW) =
            make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
        *reinterpret_cast<int4*>(pos + o0 + (size_t)i * kPW) =
            make_int4(-1, -1, -1, -1);
      }
      __syncwarp();
    }
    auto pass_end = [&](int b, const float* cv) {
      if (warp_live)
        bucket_winners(acc, cv, t, winners, cid * cap + b * wg::kTN, bpb, ok,
                       out + b, vals, pos);
    };
    if (active)
      wg::consume<Mma, true>(r, cw, b_begin, b_end, acc, pass_end);
    else
      wg::consume<Mma, false>(r, cw, b_begin, b_end, acc, pass_end);
    if (active && b_begin == 0 && gridDim.y > 1) {
      // buckets split over blocks: the row's unused columns, by the first
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
        for (int c = winners * bpb + t; c < kPW; c += 4) {
          vals[out + (size_t)h * 8 * kPW + c] = INFINITY;
          pos[out + (size_t)h * 8 * kPW + c] = -1;
        }
      }
    }
  }
}

// The tensor maps, the worklist, then the scan.  qsel [nlist*p_cap, q_cols]
// bytes by TMA; the grid's rows by TMA when `op` takes them so (rows
// given), else by op's own copies.
template <class Op>
int launch_ivf(const Op& op, const void* counts, const void* qsel, int q_cols,
               const void* rows, void* work, void* vals, void* pos, int nlist,
               int cap, int p_cap, int d, int winners, int tiles, int splits,
               int stages, int streamed, cudaStream_t stream) {
  const int kc_n = (d + wg::kRowBytes - 1) / wg::kRowBytes;
  const int smem = wg::smem_bytes(kc_n, stages, streamed != 0);
  if (smem > pool::kMaxSmem) return (int)cudaErrorInvalidValue;
  const int ptiles = (p_cap + wg::kTQ - 1) / wg::kTQ;
  const int bpb = cap / wg::kTN;
  const int bps = (bpb + splits - 1) / splits;
  CUtensorMap qmap, rmap;
  int rc = wg::encode_rows<wg::S8Mma>(&qmap, qsel, (long long)nlist * p_cap,
                                      q_cols);
  if (rc != 0) return rc;
  rmap = qmap;  // a placeholder for the producer that reads no rows by TMA
  if (rows != nullptr) {
    rc = wg::encode_rows<wg::S8Mma>(&rmap, rows, (long long)nlist * cap, d);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&ivf_pool_kernel<Op>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ivf_worklist_kernel<<<1, kWorklistThreads, 0, stream>>>(
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(work), nlist,
      p_cap, ptiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ivf_pool_kernel<Op><<<dim3(tiles, splits), wg::kThreads, smem, stream>>>(
      qmap, rmap, op, static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(work), static_cast<float*>(vals),
      static_cast<int32_t*>(pos), nlist * cap, cap, p_cap, ptiles, winners,
      kc_n, stages, streamed, bps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// counts [nlist] int32 (probers of each cluster, 0 = not probed), qsel
// [nlist*p_cap, q_words] int32 (q_words = dw rounded up to 4: rows of whole
// 16-byte vectors, zeros past dw) and cm [nlist*cap, dw] int32 words of four
// int8 dims each, off/sc [nlist*cap] f32, vals/pos [nlist*p_cap, 128], work
// [nlist * ceil(p_cap/128) + 1] int32 scratch.  cap % 128 == 0 and
// winners * cap / 128 <= 128.  The plan is the caller's
// (ops/kernels.ivf_pool_plan): `tiles` blocks along x, at least the live
// (cluster, 128-prober tile) pairs; `splits` blocks along y sharing a
// cluster's buckets, none empty; `stages` ring stages and the resident
// (streamed == 0) or streamed prober tile.  Launches on `stream`; returns 0,
// a cudaError_t, or wg::kTensorMapError + a CUresult.
int vdb_fused_ivf_pool(const void* counts, const void* qsel, const void* cm,
                       const void* off, const void* sc, void* work,
                       void* vals, void* pos, int nlist, int cap, int p_cap,
                       int dw, int q_words, int winners, int tiles,
                       int splits, int stages, int streamed, void* stream) {
  if (nlist <= 0 || cap <= 0 || cap % wg::kTN != 0 || p_cap <= 0 ||
      dw <= 0 || q_words < dw || q_words % 4 != 0 || winners < 1 ||
      winners * (cap / wg::kTN) > kPW || tiles < 1 || splits < 1 ||
      splits > cap / wg::kTN || splits > 65535 ||
      stages < wg::kMinStages || stages > wg::kMaxStages ||
      (long long)nlist * cap > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(cm) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int bpb = cap / wg::kTN;
  const int bps = (bpb + splits - 1) / splits;
  if ((long long)(splits - 1) * bps >= bpb)  // an empty split
    return (int)cudaErrorInvalidValue;
  const Cluster epi{static_cast<const float*>(off),
                    static_cast<const float*>(sc)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = 4 * dw;
  if (d % 16 == 0 && reinterpret_cast<uintptr_t>(cm) % 16 == 0) {
    const wg::TmaRows<Cluster> op{epi};
    return launch_ivf(op, counts, qsel, 4 * q_words, cm, work, vals, pos,
                      nlist, cap, p_cap, d, winners, tiles, splits, stages,
                      streamed, s);
  }
  const wg::CopyRows<Cluster> op{epi, static_cast<const uint8_t*>(cm), d};
  return launch_ivf(op, counts, qsel, 4 * q_words, nullptr, work, vals, pos,
                    nlist, cap, p_cap, d, winners, tiles, splits, stages,
                    streamed, s);
}

}  // extern "C"
