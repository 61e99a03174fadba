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
//    rotations applied), window bottom 0 meaning converged.  The wrapper
//    NaN-poisons the diagonal of lanes that did not converge.
//
// The same function serves a second entry point with other rules
// (torcwa_schur_qr_v2_c64).  It replaces the TPU kernel
// torcwa_tpu/ops/eig_qr_pallas.py::_kernel (public entries schur_qr_pallas
// and schur_qr_pallas_batched), the "v2" masked-rotation QR: ONE window per
// lane (the bottom-most alive run), deflation at eps (|d| + |d'|)
// (multiplier 1), the complex Wilkinson branch always open (no stall gate),
// the exceptional shift every 13th sweep, budget max_iters sweeps, the lower
// triangle zeroed at the end; its wrapper hands T back unpoisoned.  The rule
// sets and the start of a sweep (flags, runs, shifts) live in
// single_shift.cuh, which schur_qr_packed.cu uses too.
//
// What bounds it on an H100: latency: a lane's rotations are one dependent
// sequence with O(n) useful work each.  The design (qr_window.cuh, shared
// with schur_qr_packed.cu) keeps the part of a rotation that decides the
// next one in one warp, on a window of H staged in shared memory, and
// defers the rest to chains on the other warps:
//  * one thread block of qr_window::kThreads per matrix (grid = batch); H
//    (in T) and Z in device memory, L2-resident at the path's size, Z held
//    transposed until the end;
//  * a run's bulge is chased window by window by one warp with
//    __syncwarp() only, each lane forming (c, s) in registers; the slab
//    right of the window, the rows above it and Z's rows are chains run by
//    warps 1..7 while warp 0 chases the next window;
//  * every entry receives the per-rotation schedule's operations in its
//    order, each rounded on its own (rot_rows), so T, Z and the stats do not
//    depend on the window;
//  * the round-off of the chase on the second subdiagonal is zeroed once a
//    sweep, the lower triangle at the end.
// IEEE f32 FFMA only; no tensor-core product.  What is left (PERF.md): the
// chase is one warp's dependent loop on one SM a matrix (8 of 132 SMs busy
// at B = 8), ~800 cycles a rotation; a cluster of blocks per matrix that
// shares the chains is a later lever.

#include "qr_window.cuh"

namespace {

using qr_window::kThreads;
using qr_window::Layout;

template <typename R>
__global__ void __launch_bounds__(kThreads)
schur_qr_kernel(const float2* __restrict__ Hin, const float2* __restrict__ Zin,
                float2* __restrict__ H, float2* __restrict__ Z,
                int* __restrict__ stats, int n, int max_iters) {
  extern __shared__ float2 smem[];

  const size_t off = (size_t)blockIdx.x * n * n;
  Hin += off;
  Zin += off;
  H += off;
  Z += off;
  const int tid = threadIdx.x;
  const int nn = n * n;
  for (int e = tid; e < nn; e += kThreads) {
    H[e] = Hin[e];
    Z[(size_t)(e % n) * n + e / n] = Zin[e];  // Z^T until the end
  }
  __syncthreads();

  int hi, it, rot;
  qr_window::sweeps<R>(qr_window::Interleaved{H, n},
                       qr_window::Interleaved{Z, n}, n, max_iters, smem, hi,
                       it, rot);

  for (int e = tid; e < nn; e += kThreads) {
    const int i = e / n, j = e % n;
    if (i > j) H[e] = c_make(0.f, 0.f);
    if (i < j) {  // Z^T back to Z
      const float2 t = Z[e];
      Z[e] = Z[(size_t)j * n + i];
      Z[(size_t)j * n + i] = t;
    }
  }
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
  const size_t smem = Layout::bytes(n);
  cudaError_t err = set_smem(schur_qr_kernel<R>, smem);
  if (err != cudaSuccess) return (int)err;
  schur_qr_kernel<R><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
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
