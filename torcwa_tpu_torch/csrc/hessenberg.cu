// Batched complex Householder reduction to upper Hessenberg form with the
// unitary factor accumulated: A = Q H Q^H.
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_pallas.py::_kernel_hess
// (public entry hessenberg_pallas).  Same reflector convention, so H and Q
// agree element by element: for column k, x = H[k+1:, k],
// v = x + phase(x_0) ||x|| e_1, beta = 2 / ||v||^2; then
// w = beta v^H H, H -= v w, u = beta H v, H -= u v^H, Q -= (beta Q v) v^H.
// The entries below the subdiagonal are zeroed at the end.
//
// Design: one thread block of 1024 threads per matrix (grid = batch).  H
// and Q live in device memory (8 lanes x 2 arrays x 0.9 MB at n = 338,
// resident in the 50 MB L2); v, w, u, beta Q v and the partial sums of w
// live in shared memory.  Each of the n - 2 steps is six phases separated
// by block barriers: two block reductions for the reflector, w with
// threads over columns (coalesced rows) and the rows split into up to 32
// groups whose partial sums are then added, the rank-1 row update, u and
// Q v as warp-per-row dot products (coalesced), and the rank-1 column
// updates of H and Q.  Columns left of k are not touched by the row
// update: they hold only round-off that the final mask zeroes.
//
// What bounds it on an H100: the per-step barrier latency and the L2
// round trips of the row and column sweeps, not arithmetic (4 n^3 complex
// flops, ~0.6 GFLOP per matrix at n = 338).  A whole block per matrix
// keeps 32 warps of loads in flight to hide that latency; with 8
// matrices only 8 of the 132 SMs work, and spreading one matrix over a
// cluster is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 32;  // row groups of the w phase

__global__ void __launch_bounds__(kThreads)
hessenberg_kernel(const float2* __restrict__ A, float2* __restrict__ H,
                  float2* __restrict__ Q, int n) {
  extern __shared__ float2 sh[];
  float2* v = sh;          // reflector
  float2* w = sh + n;      // beta v^H H
  float2* u = sh + 2 * n;  // beta H v
  float2* uq = sh + 3 * n; // beta Q v
  float2* wpart = sh + 4 * n;  // partial sums of w, max(kThreads, n)
  __shared__ float red[33];

  const size_t off = (size_t)blockIdx.x * n * n;
  A += off;
  H += off;
  Q += off;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int nn = n * n;

  for (int e = tid; e < nn; e += kThreads) {
    H[e] = A[e];
    Q[e] = c_make((e / n == e % n) ? 1.f : 0.f, 0.f);
  }
  __syncthreads();

  for (int k = 0; k < n - 2; ++k) {
    // ---- reflector from column k below the diagonal ----
    float part = 0.f;
    for (int i = tid; i < n; i += kThreads) {
      const float2 x = (i > k) ? H[(size_t)i * n + k] : c_make(0.f, 0.f);
      v[i] = x;
      part += c_abs2(x);
    }
    const float xnorm = sqrtf(block_reduce<false>(part, red));
    const float2 alpha = H[(size_t)(k + 1) * n + k];
    const float aabs = sqrtf(c_abs2(alpha));
    const float phr = aabs > 0.f ? alpha.x / aabs : 1.f;
    const float phi = aabs > 0.f ? alpha.y / aabs : 0.f;
    part = 0.f;
    for (int i = k + 1 + tid; i < n; i += kThreads) {
      float2 vi = v[i];
      if (i == k + 1) {
        vi = c_add(vi, c_make(phr * xnorm, phi * xnorm));
        v[i] = vi;
      }
      part += c_abs2(vi);
    }
    const float vnorm2 = block_reduce<false>(part, red);
    const float beta = vnorm2 > 0.f ? 2.f / vnorm2 : 0.f;

    // ---- w[j] = beta sum_i conj(v_i) H[i, j], j >= k ----
    // thread t sums rows k+1+g, k+1+g+G, ... of column k + t % C, g = t / C
    {
      const int C = n - k;
      const int G = min(kMaxGroups, max(1, kThreads / C));
      for (int t = tid; t < G * C; t += kThreads) {
        const int g = t / C, j = k + t % C;
        float2 acc = c_make(0.f, 0.f);
        for (int i = k + 1 + g; i < n; i += G)
          acc = c_add(acc, c_cmul(v[i], H[(size_t)i * n + j]));
        wpart[t] = acc;
      }
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        float2 acc = wpart[c];
        for (int g = 1; g < G; ++g) acc = c_add(acc, wpart[g * C + c]);
        w[k + c] = c_scale(beta, acc);
      }
    }
    __syncthreads();

    // ---- H -= v w on rows > k, columns >= k ----
    {
      const int rows = n - k - 1, cols = n - k;
      for (int e = tid; e < rows * cols; e += kThreads) {
        const int i = k + 1 + e / cols, j = k + e % cols;
        float2* h = &H[(size_t)i * n + j];
        *h = c_sub(*h, c_mul(v[i], w[j]));
      }
    }
    __syncthreads();

    // ---- u = beta H v, uq = beta Q v (warp per row, v_j = 0 for j <= k) --
    for (int i = wid; i < n; i += kWarps) {
      float hr = 0.f, hi = 0.f, qr = 0.f, qi = 0.f;
      for (int j = k + 1 + lane; j < n; j += 32) {
        const float2 vj = v[j];
        const float2 h = H[(size_t)i * n + j];
        const float2 q = Q[(size_t)i * n + j];
        hr += h.x * vj.x - h.y * vj.y;
        hi += h.x * vj.y + h.y * vj.x;
        qr += q.x * vj.x - q.y * vj.y;
        qi += q.x * vj.y + q.y * vj.x;
      }
      hr = warp_sum(hr);
      hi = warp_sum(hi);
      qr = warp_sum(qr);
      qi = warp_sum(qi);
      if (lane == 0) {
        u[i] = c_make(beta * hr, beta * hi);
        uq[i] = c_make(beta * qr, beta * qi);
      }
    }
    __syncthreads();

    // ---- H -= u v^H, Q -= uq v^H on columns > k ----
    {
      const int cols = n - k - 1;
      for (int e = tid; e < n * cols; e += kThreads) {
        const int i = e / cols, j = k + 1 + e % cols;
        const size_t p = (size_t)i * n + j;
        H[p] = c_sub(H[p], c_mulc(u[i], v[j]));
        Q[p] = c_sub(Q[p], c_mulc(uq[i], v[j]));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < nn; e += kThreads)
    if (e / n > e % n + 1) H[e] = c_make(0.f, 0.f);
}

}  // namespace

extern "C" int torcwa_hessenberg_c64(const void* A, void* H, void* Q,
                                     int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem =
      (4 * (size_t)n + (size_t)max(kThreads, n)) * sizeof(float2);
  cudaError_t err = set_smem(hessenberg_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  hessenberg_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)A, (float2*)H, (float2*)Q, n);
  return (int)cudaGetLastError();
}
