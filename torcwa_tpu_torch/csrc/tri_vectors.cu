// Eigenvectors of a batch of upper-triangular Schur factors T: the unit
// upper-triangular Y with T Y = Y diag(lambda), lambda = diag(T).
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_pallas.py::_kernel_vec
// (public entry eig_tri_vectors_pallas).  Row back-substitution from the
// bottom: for j = n-2 .. 0 and every column m > j,
//     y[j, m] = -( sum_{j < l <= m} T[j, l] y[l, m] ) / D[j, m],
// D[j, m] = lambda_j - lambda_m floored in modulus at
// dmin_m = max(eps max(|lambda_m|, ||T||_1), 1e-31) (LAPACK-style pivot
// guard; an exactly zero D becomes dmin_m).  V = Z Y and the column
// normalisation run outside the kernel as a plain batched matmul.
//
// Design: one thread block per matrix (grid = batch).  Each thread owns a
// fixed set of columns m of Y for the whole recurrence, so Y needs no
// barrier: only T's row j, staged in shared memory, is shared per step.
// Y lives in device memory; reads of Y[l, m] by neighbouring threads are
// neighbouring addresses.
//
// What bounds it on an H100: per step, the longest column sum (n - j
// terms, sequential in one thread) and one barrier; ~n^3/6 complex
// multiply-adds in all, a few MFLOP, so latency and the load imbalance of
// the triangular shape, not bandwidth.  Splitting each column sum over a
// warp is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tri_vectors_kernel(const float2* __restrict__ T, float2* __restrict__ Y,
                   int n) {
  extern __shared__ float2 sh[];
  float2* lam = sh;                            // diag(T)
  float2* trow = sh + n;                       // T[j, :]
  float* dmin = reinterpret_cast<float*>(sh + 2 * n);
  __shared__ float red[33];

  const size_t off = (size_t)blockIdx.x * n * n;
  T += off;
  Y += off;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * n; e += kThreads)
    Y[e] = c_make((e / n == e % n) ? 1.f : 0.f, 0.f);

  // ||T||_1 = max column sum of |T|
  float cmax = 0.f;
  for (int m = tid; m < n; m += kThreads) {
    lam[m] = T[(size_t)m * n + m];
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += sqrtf(c_abs2(T[(size_t)i * n + m]));
    cmax = fmaxf(cmax, s);
  }
  const float tnorm = block_reduce<true>(cmax, red);
  for (int m = tid; m < n; m += kThreads)
    dmin[m] = fmaxf(TORCWA_EPS_F32 * fmaxf(sqrtf(c_abs2(lam[m])), tnorm),
                    TORCWA_SMLNUM_F32);
  __syncthreads();

  for (int j = n - 2; j >= 0; --j) {
    for (int l = tid; l < n; l += kThreads) trow[l] = T[(size_t)j * n + l];
    __syncthreads();
    const float2 lj = lam[j];
    for (int m = tid; m < n; m += kThreads) {
      if (m <= j) continue;
      float2 s = c_make(0.f, 0.f);
      for (int l = j + 1; l <= m; ++l)
        s = c_add(s, c_mul(trow[l], Y[(size_t)l * n + m]));
      float2 d = c_sub(lj, lam[m]);
      const float dabs = sqrtf(c_abs2(d));
      const float dm = dmin[m];
      if (dabs < dm) {
        if (dabs > 0.f) d = c_scale(dm / dabs, d);
        else d = c_make(dm, 0.f);
      }
      float dden = c_abs2(d);
      if (!(dden > 0.f)) dden = 1.f;
      Y[(size_t)j * n + m] = c_make(-(s.x * d.x + s.y * d.y) / dden,
                                    -(s.y * d.x - s.x * d.y) / dden);
    }
    __syncthreads();  // trow is overwritten next step
  }
}

}  // namespace

extern "C" int torcwa_tri_vectors_c64(const void* T, void* Y, int batch,
                                      int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = 2 * (size_t)n * sizeof(float2) + (size_t)n * sizeof(float);
  cudaError_t err = set_smem(tri_vectors_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tri_vectors_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)T, (float2*)Y, n);
  return (int)cudaGetLastError();
}
