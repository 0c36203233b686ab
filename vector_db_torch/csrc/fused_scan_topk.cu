// Fused f32 distance scan + bucket winners for NVIDIA Hopper: the port of
// fused_scan_topk (vector_db_tpu/ops/pallas_kernels.py:988, pallas_call
// :1032, bodies _make_kernel :67), the original exact-distance bucket-winner
// scan.
//
// For queries q [Q, D] (passed as -2q, an exact scaling), corpus rows v [N, D]
// and squared norms n [N] (+inf = never returned), the score of (q, v) is the
// reference's augmented product [-2q; 1] . [v; |v|^2] = |v|^2 - 2 q.v, summed
// in f32.  Each 128-column bucket keeps `winners` (1 or 2) best columns: the
// minimum, a tie to the lowest lane (the reference's argmin), then with
// winners == 2 the minimum with the first winner masked to +inf.  Columns at
// or past N score +inf (the reference's padded rows).  The winners land where
// the reference's grid writes them: for bucket bk in column block j = bk /
// bpb (bpb = block_n / 128 buckets a block), winner t goes to output column
// j * bpb * winners + t * bpb + bk % bpb, with the global column bk * 128 +
// lane as its index.  The exact top-k over the winners and the + |q|^2 stay
// in the wrapper, as in the reference (:1061-1075).
//
// The product runs in f32 on the CUDA cores (FFMA, no TF32: the reference's
// arithmetic is f32 and the card has no f32 tensor-core path).  Its sums run
// in this kernel's order, so it agrees with its plain PyTorch version within
// the f32 summation-order bound (ops/kernels.check_scan_topk).
//
// Layout: a block owns a 128-query x 128-column tile (one whole bucket, so
// the bucket minimum and the masked second winner never leave the block) and
// streams D in 8-wide slabs through two shared buffers (k-major, padded
// rows): the next slab's global loads are in registers while the current one
// is multiplied.  Each of the 256 threads accumulates 8 queries x 8 columns
// (rows 4ty..4ty+3 and 64+4ty.., columns 4tx..4tx+3 and 64+4tx..) from four
// float4 shared reads per k.  The grid is flat with the query tile fastest,
// so the blocks that read one bucket's rows run together and find them in
// L2.
//
// What bounds it on an H100: the operations.  At Q = 1024, N = 100,000, D =
// 512 the 1.05e11 f32 operations need >= 1.57 ms at the 67 TFLOP/s FP32 peak;
// the bytes (the 205 MB corpus read once) need 0.06 ms.  No cp.async or TMA
// ring: later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // queries per block
constexpr int kBN = 128;       // columns per block: one bucket
constexpr int kBK = 8;         // dims per shared slab
constexpr int kThreads = 256;  // 16 x 16: 8 queries x 8 columns a thread
constexpr int kPad = 4;        // shared row padding (keeps float4 alignment)

__device__ __forceinline__ bool key_less(float v1, int c1, float v2, int c2) {
  return v1 < v2 || (v1 == v2 && c1 < c2);
}

// This thread's four consecutive dims k0 + 4 (tid & 1) .. + 3 of tile row
// tid / 2 (zeros past the matrix), with 16-byte loads when rows are aligned.
__device__ __forceinline__ float4 load4(const float* __restrict__ m,
                                        long long row, long long rows, int D,
                                        int k, bool vec) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return x;
  const float* p = m + (size_t)row * D + k;
  if (vec && k + 3 < D) return __ldg(reinterpret_cast<const float4*>(p));
  if (k < D) x.x = __ldg(p);
  if (k + 1 < D) x.y = __ldg(p + 1);
  if (k + 2 < D) x.z = __ldg(p + 2);
  if (k + 3 < D) x.w = __ldg(p + 3);
  return x;
}

__device__ __forceinline__ void store_t(float (*dst)[kBM + kPad], int r,
                                        int k4, float4 x) {
  dst[k4][r] = x.x;
  dst[k4 + 1][r] = x.y;
  dst[k4 + 2][r] = x.z;
  dst[k4 + 3][r] = x.w;
}

__global__ void __launch_bounds__(kThreads)
scan_topk_kernel(const float* __restrict__ qm2,    // [Q, D] = -2 q
                 const float* __restrict__ base,   // [N, D]
                 const float* __restrict__ norms,  // [N]
                 float* __restrict__ vals,         // [Q, cols]
                 int32_t* __restrict__ idx,        // [Q, cols]
                 int Q, int N, int D, int winners, int bpb, int cols,
                 int qtiles, bool vec) {
  __shared__ __align__(16) float s_a[2][kBK][kBM + kPad];
  __shared__ __align__(16) float s_b[2][kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qt = (int)(blockIdx.x % qtiles);
  const long long bucket = blockIdx.x / qtiles;
  const int q0 = qt * kBM;
  const long long n0 = bucket * kBN;
  const int lr = tid >> 1;        // the tile row this thread loads
  const int lk = 4 * (tid & 1);   // and its first dim within the slab

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 pa = load4(qm2, q0 + lr, Q, D, lk, vec);
  float4 pb = load4(base, n0 + lr, N, D, lk, vec);
  store_t(s_a[0], lr, lk, pa);
  store_t(s_b[0], lr, lk, pb);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += kBK) {
    const bool more = k0 + kBK < D;
    if (more) {  // the next slab, in flight during this one's products
      pa = load4(qm2, q0 + lr, Q, D, k0 + kBK + lk, vec);
      pb = load4(base, n0 + lr, N, D, k0 + kBK + lk, vec);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s_a[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s_b[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s_b[buf][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_t(s_a[buf ^ 1], lr, lk, pa);
      store_t(s_b[buf ^ 1], lr, lk, pb);
      __syncthreads();
      buf ^= 1;
    }
  }

  // this thread's columns and their norms (+inf past N)
  int col[8];
  float nv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] = (j < 4 ? 4 * tx + j : 64 + 4 * tx + (j - 4));
    const long long n = n0 + col[j];
    nv[j] = n < N ? norms[n] : INFINITY;
  }
  const long long blk_j = bucket / bpb;
  const int bb = (int)(bucket - blk_j * bpb);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = acc[i][j] + nv[j];
    const int qr = q0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + (i - 4));
    for (int w = 0; w < winners; ++w) {
      float bv = v[0];
      int bc = col[0];
#pragma unroll
      for (int j = 1; j < 8; ++j)
        if (key_less(v[j], col[j], bv, bc)) {
          bv = v[j];
          bc = col[j];
        }
      // the 16 threads of one query group share a half warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
        if (key_less(ov, oc, bv, bc)) {
          bv = ov;
          bc = oc;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col[j] == bc) v[j] = INFINITY;
      if (tx == 0 && qr < Q) {
        const size_t o = (size_t)qr * cols +
                         (size_t)(blk_j * bpb * winners + w * bpb + bb);
        vals[o] = bv;
        idx[o] = (int32_t)(n0 + bc);
      }
    }
  }
}

}  // namespace

extern "C" {

// qm2 [q, d] f32 (= -2 * queries), base [n, d] f32, norms [n] f32, vals/idx
// [q, cols] with cols = buckets * winners, buckets = ceil(n / block_n) *
// block_n / 128, bpb = block_n / 128.  Launches on `stream`; returns
// cudaGetLastError().
int vdb_fused_scan_topk(const void* qm2, const void* base, const void* norms,
                        void* vals, void* idx, int q, int n, int d,
                        int winners, int bpb, int buckets, void* stream) {
  if (q <= 0 || n <= 0 || d <= 0 || bpb <= 0 || buckets <= 0 ||
      buckets % bpb != 0 || (long long)buckets * kBN < n ||
      (winners != 1 && winners != 2))
    return (int)cudaErrorInvalidValue;
  const int qtiles = (q + kBM - 1) / kBM;
  const long long blocks = (long long)buckets * qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(qm2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(base) % 16 == 0;
  scan_topk_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qm2), static_cast<const float*>(base),
      static_cast<const float*>(norms), static_cast<float*>(vals),
      static_cast<int32_t*>(idx), q, n, d, winners, bpb, buckets * winners,
      qtiles, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
