// In-block back substitution of the blocked triangular eigenvectors: rows
// [r0, r0 + p) of the unit upper-triangular Y with T Y = Y diag(lambda).
//
// Replaces the TPU kernel torcwa_tpu/ops/vec_blocked.py::_kernel_block
// (public entry eig_tri_vectors_blocked).  The caller has put
// S = T[r0:r1, r1:] Y[r1:, :] (one GEMM over the rows already solved) in S
// and the identity in rows [r0, r1) of Y.  For j = r1-1 .. r0 and every
// column m > j,
//     Y[j, m] = -( S[j-r0, m] + sum_{j<l<r1} T[j, l] Y[l, m] ) / D[j, m],
// D[j, m] = lambda_j - lambda_m floored in modulus at dmin[m] (an exactly
// zero D becomes dmin[m]), the pivot guard of tri_vectors.cu.
//
// Design: a warp per column m, the recurrence by columns.  Lane L keeps
// the running sums s_i of the rows i = L, L + 32, L + 64, L + 96 of the
// block in registers, seeded from S (and from T[i, m - r0] where column m
// lies in the block: Y's unit entry).  For i from the last row m may use
// down to 0, the lane that owns row i forms y_i = -s_i / D_i, writes it and
// broadcasts it with a shuffle, and every lane subtracts T[l, i] y_i from
// its rows l < i (s_l += T[l, i] y_i): the sums of the row-oriented
// recurrence, taken in descending l.  Row slots are compile-time indices
// (slot<Q> below), so nothing is indexed at run time and nothing goes to
// local memory.  The block's upper triangle of T is staged once per CTA
// in shared memory, packed by columns (column i at i (i + 1) / 2), so a
// warp reads a column of it on consecutive addresses.  The grid has at most
// one CTA of 32 warps per SM, and the warps loop over the columns.
//
// What bounds it on an H100: each warp's chain of p dependent steps (one
// complex division by one lane, one shuffle, up to p / 32 FFMAs a lane),
// ~60 us a launch on average at n = 3362 (qr_compare.py --stage
// tri_vectors_blocked); a half warp per column, two columns a warp spread
// over every SM, ran slower.  The function reads p (p + 1) / 2 of T
// and p x n of S and writes p x n of Y, ~7 MB at n = 3362.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 128;  // ops/vec_blocked.py: MAX_BLOCK
constexpr int kSlots = kMaxBlock / 32;

__device__ __forceinline__ int tri_col(int i) { return i * (i + 1) / 2; }

// The steps i = 32 Q + l, l from lmax down to 0: rows of slot Q.
template <int Q>
__device__ __forceinline__ void slot(float2 (&s)[kSlots],
                                     const float2 (&d)[kSlots],
                                     const float (&dd)[kSlots],
                                     const float2* __restrict__ tri,
                                     float2* __restrict__ Y, int n, int r0,
                                     int m, int top, int lane) {
  if (32 * Q > top) return;
  const int lmax = min(31, top - 32 * Q);
  for (int l = lmax; l >= 0; --l) {
    const int i = 32 * Q + l;
    float2 y = c_make(0.f, 0.f);
    if (lane == l) {
      y = c_make(-(s[Q].x * d[Q].x + s[Q].y * d[Q].y) / dd[Q],
                 -(s[Q].y * d[Q].x - s[Q].x * d[Q].y) / dd[Q]);
      Y[(size_t)(r0 + i) * n + m] = y;
    }
    y.x = __shfl_sync(0xffffffffu, y.x, l);
    y.y = __shfl_sync(0xffffffffu, y.y, l);
    const float2* tc = tri + tri_col(i);
#pragma unroll
    for (int q = 0; q <= Q; ++q) {
      const int row = 32 * q + lane;
      if (row < i) s[q] = c_add(s[q], c_mul(tc[row], y));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tri_vectors_block_kernel(const float2* __restrict__ T,
                         const float2* __restrict__ S,
                         const float* __restrict__ dmin,
                         float2* __restrict__ Y, int n, int r0, int p) {
  extern __shared__ float2 tri[];  // tri[tri_col(i) + l] = T[r0 + l, r0 + i]
  for (int e = threadIdx.x; e < p * p; e += kThreads) {
    const int l = e / p, i = e % p;
    if (l <= i) tri[tri_col(i) + l] = T[(size_t)(r0 + l) * n + r0 + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = r0 + 1 + blockIdx.x * kWarps + warp; m < n;
       m += gridDim.x * kWarps) {
    const float2 lm = T[(size_t)m * n + m];
    const float dm = dmin[m];
    const int mloc = m - r0;                 // >= 1
    const int top = min(mloc - 1, p - 1);    // rows j < m only
    float2 s[kSlots], d[kSlots];
    float dd[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int i = 32 * q + lane;
      s[q] = c_make(0.f, 0.f);
      d[q] = c_make(1.f, 0.f);
      dd[q] = 1.f;
      if (i <= top) {
        s[q] = S[(size_t)i * n + m];
        if (mloc < p) s[q] = c_add(s[q], tri[tri_col(mloc) + i]);  // Y[m,m]=1
        float2 dq = c_sub(tri[tri_col(i) + i], lm);
        const float dabs = sqrtf(c_abs2(dq));
        if (dabs < dm) {
          if (dabs > 0.f) dq = c_scale(dm / dabs, dq);
          else dq = c_make(dm, 0.f);
        }
        float dden = c_abs2(dq);
        if (!(dden > 0.f)) dden = 1.f;
        d[q] = dq;
        dd[q] = dden;
      }
    }
    static_assert(kSlots == 4, "slot<> calls below assume 4 slots");
    slot<3>(s, d, dd, tri, Y, n, r0, m, top, lane);
    slot<2>(s, d, dd, tri, Y, n, r0, m, top, lane);
    slot<1>(s, d, dd, tri, Y, n, r0, m, top, lane);
    slot<0>(s, d, dd, tri, Y, n, r0, m, top, lane);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

}  // namespace

extern "C" int torcwa_tri_vectors_block_c64(const void* T, const void* S,
                                            const void* dmin, void* Y, int n,
                                            int r0, int p, void* stream) {
  if (p <= 0 || p > kMaxBlock || r0 < 0 || r0 + p > n)
    return (int)cudaErrorInvalidValue;
  const int cols = n - r0 - 1;
  if (cols <= 0) return 0;
  const size_t smem = (size_t)p * (p + 1) / 2 * sizeof(float2);
  cudaError_t err = set_smem(tri_vectors_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = min(sm_count(), (cols + kWarps - 1) / kWarps);
  tri_vectors_block_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)T, (const float2*)S, (const float*)dmin, (float2*)Y, n,
      r0, p);
  return (int)cudaGetLastError();
}
