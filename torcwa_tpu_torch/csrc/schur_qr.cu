// Batched implicit single-shift complex Schur QR: H = Z T Z^H with T upper
// triangular, from an upper Hessenberg H and its accumulated Q.
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_pallas.py::_kernel_acc
// (public entry schur_qr_pallas_acc) and keeps every rule of it:
//  * deflation: subdiagonal k is dead when |h_k+1,k| <= max(kDeflMult eps
//    (|h_kk| + |h_k+1,k+1|), 1e-31); the window bottom only moves up;
//  * up to kRuns independent windows (alive runs) per sweep, one bulge
//    each, bottom-most run first in the shift rules;
//  * Wilkinson shift from each run's trailing 2x2; every kExcEvery-th
//    sweep the bottom run takes the exceptional shift d + 0.75 |sub|;
//  * stall gate: an exactly real discriminant takes the real branch until
//    the window has not shrunk for kCplxStall sweeps (with real eps at
//    normal incidence A = PQ is exactly real, and an eager complex branch
//    costs ~15% more sweeps);
//  * budget max_iters sweeps; stats[b] = (final window bottom, sweeps,
//    rotations applied), window bottom 0 meaning converged.  The wrapper NaN-poisons the
//    diagonal of lanes that did not converge.
// The TPU kernel's deferred-column accumulator W, the Z^T storage and the
// prefix-bucket switch are TPU-shaped and are not carried over: each
// rotation is applied to the rows and columns of H and to Z directly.
//
// Design: one thread block per matrix (grid = batch); H (in T) and Z live
// in device memory (L2-resident at the main-path size); the deflation
// flags, the runs and the rotation carry live in shared memory.  Each
// sweep: all threads compute the deflation flags, thread 0 walks them to
// find the runs and their shifts, then each rotation is two phases (rows
// k, k+1 with threads over columns; columns k, k+1 of H and Z with threads
// over rows) separated by barriers.  The row update covers columns
// >= k - 1 and the column update rows <= k + 2, the only entries that are
// not structurally zero; the round-off the bulge chase leaves on the
// second subdiagonal is zeroed once per sweep.
//
// The same function serves a second entry point with other rules
// (torcwa_schur_qr_v2_c64).  It replaces the TPU kernel
// torcwa_tpu/ops/eig_qr_pallas.py::_kernel (public entries schur_qr_pallas
// and schur_qr_pallas_batched), the "v2" masked-rotation QR: ONE window per
// lane (the bottom-most alive run), deflation at eps (|d| + |d'|)
// (multiplier 1), the complex Wilkinson branch always open (no stall gate),
// the exceptional shift every 13th sweep, budget max_iters sweeps, the lower
// triangle zeroed at the end; its wrapper hands T back unpoisoned.  The
// masked full-matrix rotations, the rolls and the one-hot scalar reads of
// that kernel are the TPU compiler's constraints, not the function: here the
// rules are a template parameter of the kernel below and everything else is
// shared, so the two entry points cannot drift apart in what they share.
// The rule sets and the start of a sweep (flags, runs, shifts) live in
// single_shift.cuh, which schur_qr_packed.cu uses too.
//
// What bounds it on an H100: latency.  Every rotation is O(n) work behind
// two block barriers and an L2 round trip, and a sweep starts with a
// serial scan by one thread; the ~tens of thousands of rotations per
// matrix are inherently sequential.  The design does nothing yet against
// that beyond keeping the per-rotation work to the non-zero band; multi-
// shift chases and a cluster per matrix are later work.

#include "single_shift.cuh"

namespace {

constexpr int kThreads = 256;

template <typename R>
__global__ void __launch_bounds__(kThreads)
schur_qr_kernel(const float2* __restrict__ Hin, const float2* __restrict__ Zin,
                float2* __restrict__ H, float2* __restrict__ Z,
                int* __restrict__ stats, int n, int max_iters) {
  extern __shared__ unsigned char alive[];  // alive[c]: subdiagonal c+1,c
  __shared__ SweepPlan<R> plan;
  __shared__ float2 s_x, s_y;

  const size_t off = (size_t)blockIdx.x * n * n;
  Hin += off;
  Zin += off;
  H += off;
  Z += off;
  const int tid = threadIdx.x;
  const int nn = n * n;
  for (int e = tid; e < nn; e += kThreads) {
    H[e] = Hin[e];
    Z[e] = Zin[e];
  }
  __syncthreads();

  int hi = n - 1, it = 0;
  int stall = 0, rot = 0;  // meaningful in thread 0 only
  while (hi > 0 && it < max_iters) {
    // ---- deflation flags, windows and shifts (single_shift.cuh) ----
    plan_sweep<R>([&](int i, int j) { return H[(size_t)i * n + j]; }, hi, it,
                  stall, rot, alive, plan);
    hi = plan.hi0;
    const int nr = plan.nr;

    // ---- one bulge per run, top-most run first ----
    for (int r = nr - 1; r >= 0; --r) {
      const int lo = plan.lo[r], hr = plan.hi[r];
      if (tid == 0) {
        s_x = c_sub(H[(size_t)lo * n + lo], plan.shift[r]);
        s_y = H[(size_t)(lo + 1) * n + lo];
      }
      __syncthreads();
      for (int k = lo; k < hr; ++k) {
        const Givens g = givens(s_x, s_y);
        const float c = g.c;
        const float2 s = g.s;
        // rows k, k+1:  new_k = c h_k + s h_k1 ; new_k1 = c h_k1 - conj(s) h_k
        for (int j = max(k - 1, 0) + tid; j < n; j += kThreads) {
          const float2 hk = H[(size_t)k * n + j];
          const float2 h1 = H[(size_t)(k + 1) * n + j];
          H[(size_t)k * n + j] = c_add(c_scale(c, hk), c_mul(s, h1));
          H[(size_t)(k + 1) * n + j] = c_sub(c_scale(c, h1), c_cmul(s, hk));
        }
        __syncthreads();
        // columns k, k+1:  new_l = c l + conj(s) r ; new_r = c r - s l
        const int imax = min(k + 2, n - 1);
        for (int i = tid; i < n; i += kThreads) {
          if (i <= imax) {
            const float2 l = H[(size_t)i * n + k];
            const float2 rr = H[(size_t)i * n + k + 1];
            const float2 nl = c_add(c_scale(c, l), c_cmul(s, rr));
            H[(size_t)i * n + k] = nl;
            H[(size_t)i * n + k + 1] = c_sub(c_scale(c, rr), c_mul(s, l));
            if (i == k + 1) s_x = nl;
            if (i == k + 2) s_y = (k + 2 <= hi) ? nl : c_make(0.f, 0.f);
          }
          const float2 zl = Z[(size_t)i * n + k];
          const float2 zr = Z[(size_t)i * n + k + 1];
          Z[(size_t)i * n + k] = c_add(c_scale(c, zl), c_cmul(s, zr));
          Z[(size_t)i * n + k + 1] = c_sub(c_scale(c, zr), c_mul(s, zl));
        }
        if (tid == 0 && k + 2 > n - 1) s_y = c_make(0.f, 0.f);
        __syncthreads();
      }
    }
    // round-off of the chase on the second subdiagonal
    if (nr > 0) {
      for (int j = tid; j < n - 2; j += kThreads)
        H[(size_t)(j + 2) * n + j] = c_make(0.f, 0.f);
      __syncthreads();
    }
    ++it;
  }

  for (int e = tid; e < nn; e += kThreads)
    if (e / n > e % n) H[e] = c_make(0.f, 0.f);
  if (tid == 0) {
    stats[3 * blockIdx.x] = hi;
    stats[3 * blockIdx.x + 1] = it;
    stats[3 * blockIdx.x + 2] = rot;
  }
}

template <typename R>
int launch(const void* Hin, const void* Zin, void* T, void* Z, void* stats,
           int batch, int n, int max_iters, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  schur_qr_kernel<R><<<batch, kThreads, (size_t)n, (cudaStream_t)stream>>>(
      (const float2*)Hin, (const float2*)Zin, (float2*)T, (float2*)Z,
      (int*)stats, n, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int torcwa_schur_qr_c64(const void* Hin, const void* Zin, void* T,
                                   void* Z, void* stats, int batch, int n,
                                   int max_iters, void* stream) {
  return launch<AccRules>(Hin, Zin, T, Z, stats, batch, n, max_iters, stream);
}

extern "C" int torcwa_schur_qr_v2_c64(const void* Hin, const void* Zin,
                                      void* T, void* Z, void* stats, int batch,
                                      int n, int max_iters, void* stream) {
  return launch<V2Rules>(Hin, Zin, T, Z, stats, batch, n, max_iters, stream);
}
