// Batched implicit single-shift complex Schur QR on a PACKED planar layout:
// H = Z T Z^H with T upper triangular, H and Z^T stored as rows
// [re(0..n) pad | im(0..n) pad] of 2 npad floats.
//
// Replaces the TPU kernel
// torcwa_tpu/ops/attic/eig_qr_pallas_packed.py::_kernel_packed (public entry
// schur_qr_pallas_packed) and keeps its rules, which are _kernel_acc's
// iteration (schur_qr.cu) under one other constant:
//  * deflation: subdiagonal k is dead when |h_k+1,k| <= max(eps (|h_kk| +
//    |h_k+1,k+1|), 1e-31) (multiplier 1, where _kernel_acc takes 4); the
//    window bottom only moves up;
//  * up to 4 independent windows (alive runs) per sweep, one bulge each;
//  * Wilkinson shift from each run's trailing 2x2; every 13th sweep the
//    bottom run takes the exceptional shift d + 0.75 |sub|;
//  * stall gate: an exactly real discriminant takes the real branch until the
//    window has not shrunk for 30 sweeps;
//  * budget max_iters sweeps; stats[b] = (final window bottom, sweeps,
//    rotations applied), bottom 0 meaning converged.  The wrapper NaN-poisons
//    the diagonal of lanes that did not converge.
// What makes it this kernel and not schur_qr.cu is the storage, which is kept
// as the design: the wrapper packs H and Z^T into planar rows whose imaginary
// half starts at float npad, n rounded up to 32 floats, so that both halves of
// a row start on a 128-byte line (the TPU's reason for its pad was the
// 128-lane vector register); the kernel rotates those rows in place, the
// TPU kernel's packed rotation algebra
//     nk = c hk + sr h1 + si (S swap(h1)),  n1 = c h1 - sr hk + si (S swap(hk))
// with S = (-1 | +1) over the two halves and swap exchanging them, taken
// for each lane pair (j, npad + j), i.e. entry j of the row pair as a
// complex number.  The padding floats [n, npad) of each half are never
// written and stay zero.
// Not carried over, because they serve the TPU's matrix unit and compiler:
// the deferred-column accumulator W with its once-per-sweep products H W^T
// and W Z^T (on one SM ~16 n^3 flops a sweep against ~20 n^2 for rotating
// directly), the prefix-bucket switch, the carried rows and the single roll
// per step, the chunking of the batch.
//
// Design: schur_qr.cu's windowed chase (qr_window.cuh) on the planar rows,
// in place: one thread block of qr_window::kThreads per matrix (grid =
// batch), H and Z^T in device memory (L2-resident at the main-path size).
// A run's bulge is chased through windows of 32 rows of H staged in shared
// memory, interleaved there, by one warp with __syncwarp() only, each lane
// forming (c, s) in registers; the rest of each rotation (the slab right of
// the window, the rows above it, Z^T's rows) is deferred to chains on warps
// 1..7, staged by 4-byte cp.async from the two halves of the planar rows,
// while warp 0 chases the next window.  Every entry receives the
// per-rotation schedule's operations in its order, each rounded on its own
// (qr_window::rot_rows), so T, Z and the stats do not depend on the window:
// built with -fmad=false they are those of the per-rotation kernel this one
// replaced (one block of 512 threads a matrix, two block barriers and two
// dependent round trips to the L2 cache a rotation).  On this card the
// planar layout neither helps nor hurts a chain: 32 columns of one row are
// one 128-byte line of each half instead of one 256-byte run.
//
// What bounds it on an H100: as schur_qr.cu, one warp's dependent chase on
// one SM a matrix; its rules deflate later (multiplier 1), so a lane takes
// more sweeps than schur_qr's.

#include "qr_window.cuh"

namespace {

using qr_window::kThreads;

__global__ void __launch_bounds__(kThreads)
schur_qr_packed_kernel(float* __restrict__ Hp, float* __restrict__ Ztp,
                       int* __restrict__ stats, int n, int npad,
                       int max_iters) {
  extern __shared__ float2 smem[];
  const size_t off = (size_t)blockIdx.x * n * 2 * npad;
  const qr_window::Planar H{Hp + off, npad}, Zt{Ztp + off, npad};
  const int tid = threadIdx.x;

  int hi, it, rot;
  qr_window::sweeps<PackedRules>(H, Zt, n, max_iters, smem, hi, it, rot);

  for (int e = tid; e < n * n; e += kThreads)
    if (e / n > e % n) H.put(e / n, e % n, c_make(0.f, 0.f));
  if (tid == 0) {
    stats[3 * blockIdx.x] = hi;
    stats[3 * blockIdx.x + 1] = it;
    stats[3 * blockIdx.x + 2] = rot;
  }
}

}  // namespace

// Hp (packed H in, T out) and Ztp (packed Q^T in, Z^T out): batch x n x
// 2 npad float32, in place; npad >= n, a multiple of 32; stats takes three
// 32-bit integers per matrix.
extern "C" int torcwa_schur_qr_packed_f32(void* Hp, void* Ztp, void* stats,
                                          int batch, int n, int npad,
                                          int max_iters, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (npad < n || npad % 32 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = qr_window::Layout::bytes(n);
  cudaError_t err = set_smem(schur_qr_packed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  schur_qr_packed_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)Hp, (float*)Ztp, (int*)stats, n, npad, max_iters);
  return (int)cudaGetLastError();
}
