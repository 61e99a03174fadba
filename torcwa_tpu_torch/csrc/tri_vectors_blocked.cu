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
// Design: columns are independent, so one thread owns one column m for
// the whole block and keeps its p entries of Y in a private array; blocks
// of kThreads columns cover m > r0.  The p x p triangle of T is staged in
// shared memory once per block of threads and read as broadcasts.  The
// TPU kernel's padding to a block multiple and its one-hot lane gathers
// are not carried over: r0 and p arrive as arguments.
//
// What bounds it on an H100: each thread runs p^2/2 dependent complex
// multiply-adds (p = 128: 8192), and at most n / kThreads blocks are in
// flight, so latency of one thread's chain, not bandwidth: the function
// reads p x p of T, p x n of S and writes p x n of Y, ~7 MB at n = 3362.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBlock = 128;  // ops/vec_blocked.py: MAX_BLOCK

__global__ void __launch_bounds__(kThreads)
tri_vectors_block_kernel(const float2* __restrict__ T,
                         const float2* __restrict__ S,
                         const float* __restrict__ dmin,
                         float2* __restrict__ Y, int n, int r0, int p) {
  extern __shared__ float2 tb[];  // tb[i * p + l] = T[r0 + i, r0 + l]
  for (int e = threadIdx.x; e < p * p; e += kThreads)
    tb[e] = T[(size_t)(r0 + e / p) * n + r0 + e % p];
  __syncthreads();

  const int m = r0 + 1 + blockIdx.x * kThreads + threadIdx.x;
  if (m >= n) return;
  const float2 lm = T[(size_t)m * n + m];
  const float dm = dmin[m];
  float2 y[kMaxBlock];
  for (int i = 0; i < p; ++i) y[i] = c_make(r0 + i == m ? 1.f : 0.f, 0.f);

  const int jtop = min(m - 1, r0 + p - 1) - r0;  // rows j < m only
  for (int i = jtop; i >= 0; --i) {
    float2 s = S[(size_t)i * n + m];
    for (int l = i + 1; l < p; ++l) s = c_add(s, c_mul(tb[i * p + l], y[l]));
    float2 d = c_sub(tb[i * p + i], lm);
    const float dabs = sqrtf(c_abs2(d));
    if (dabs < dm) {
      if (dabs > 0.f) d = c_scale(dm / dabs, d);
      else d = c_make(dm, 0.f);
    }
    float dden = c_abs2(d);
    if (!(dden > 0.f)) dden = 1.f;
    y[i] = c_make(-(s.x * d.x + s.y * d.y) / dden,
                  -(s.y * d.x - s.x * d.y) / dden);
    Y[(size_t)(r0 + i) * n + m] = y[i];
  }
}

}  // namespace

extern "C" int torcwa_tri_vectors_block_c64(const void* T, const void* S,
                                            const void* dmin, void* Y, int n,
                                            int r0, int p, void* stream) {
  if (p <= 0 || p > kMaxBlock || r0 < 0 || r0 + p > n)
    return (int)cudaErrorInvalidValue;
  const int cols = n - r0 - 1;
  if (cols <= 0) return 0;
  const size_t smem = (size_t)p * p * sizeof(float2);
  cudaError_t err = set_smem(tri_vectors_block_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tri_vectors_block_kernel<<<(cols + kThreads - 1) / kThreads, kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const float2*)T, (const float2*)S, (const float*)dmin, (float2*)Y, n,
      r0, p);
  return (int)cudaGetLastError();
}
