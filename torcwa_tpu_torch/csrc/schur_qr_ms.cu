// Multishift complex Schur QR for ONE upper Hessenberg matrix, the whole
// iteration in one launch: H = Z T Z^H with T upper triangular.
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_pallas_ms.py::_kernel_ms
// (public entry schur_qr_pallas_ms) and keeps the rules that decide its
// convergence and its answer:
//  * deflation: subdiagonal k is dead when |h_k+1,k| <= max(eps (|h_kk| +
//    |h_k+1,k+1|), 1e-31); the window bottom hi only moves up, the active
//    block [lo, hi] is the bottom-most alive run;
//  * shifts: the eigenvalues of the trailing m x m block of the active block
//    ordered by distance to H[hi, hi], padding lanes last; after 13 sweeps
//    without progress one exceptional sweep with the perturbed trailing
//    diagonal (ms_shifts.cuh);
//  * chase: m spacing-2 bulges over the whole active block; bulge i sits at
//    row k = t - 2 i at step t, enters at k = lo with (H[lo,lo] - sigma_i,
//    H[lo+1,lo]), and only bulges with lo + 2 i + 1 <= hi are alive; a
//    bulge outside [lo, hi) is no rotation at all (pipeline fill and drain);
//  * budget max_sweeps sweeps, counted as the TPU kernel counts them (the
//    pass that finds the block closed included); stats = (final window
//    bottom, sweeps, rotations applied), bottom 0 meaning converged.  The
//    wrapper NaN-poisons the diagonal when the bottom is not 0.
// Not carried over, because they serve the TPU's matrix unit and compiler:
// the deferred-column accumulator W with its per-sweep prefix GEMMs and the
// 256-bucket switch, the one-hot selection matmuls, the split-real planes,
// the per-bulge scalar extraction by masked sums.  Rotations are applied to
// H and Z directly, so no matrix product is left in the stage.
//
// Two kernels, chosen by n and m in the C entry point (cluster_choice
// below; ops/schur_qr_ms.py: schur_qr_ms_cluster mirrors it):
//
// * ms_cluster::kernel<P, kZs> (ms_cluster.cuh): one thread-block cluster
//   of P CTAs for the matrix, H in the cluster's distributed shared memory
//   (column j on rank j mod P), Z^T beside it where both fit (kZs), else
//   in device memory with a slice of its columns per rank; two cluster
//   barriers a chase step.  P is picked from n alone: 8 where a rank holds
//   at most 32 columns (n <= 256), else 16, the non-portable size.
// * schur_qr_ms_kernel, where H's columns do not fit the cluster's shared
//   memory (n above ~670 at m = 16): one thread block of 1024 threads.
//   H and Z stay in device memory (0.9 MB each at n = 338, resident in the
//   L2 cache up to n ~ 1500); the m x m shift block, the shifts and the
//   bulge carries live in shared memory.  The band scan is two block-wide
//   max-reductions; warp 0 computes the shifts while the others wait; the
//   chase is chase_whole_block of ms_chase.cuh, which schur_qr_baed.cu runs
//   too; a chase step is three phases behind block barriers: (1) threads
//   0..m-1 form the step's rotations from the carries, (2) every row
//   rotation, (3) every column rotation of H.
// Either way a step's m rotations touch disjoint row pairs and disjoint
// column pairs, and a row rotation covers columns >= max(k - 1, lo) only,
// so that the bump a trailing bulge creates is never smeared by the bulge
// ahead of it: then all rows before all columns equals the bulges taken one
// after another, leading bulge first.
// Z is held TRANSPOSED (the wrapper hands Q^T in and takes Z^T out):
// Z <- Z G^H on columns k, k+1 becomes a rotation of two rows of Z^T,
// contiguous in memory, and joins the row phase.  With plain Z the column
// pairs would be read at stride n, one 32-byte sector for every 16 bytes
// used.
//
// What bounds it on an H100: latency, in two serial chains.  On the
// order-6 wave matrix (n = 338, m = 16: 339 sweeps, 124465 rotations) the
// active block is ~23 rows on average, so a sweep is ~23 steps plus
// 2 (nb - 1) of pipeline fill and drain, ~18k steps in all.  A step of the
// cluster kernel took ~3.2k cycles (a clock64() split of thread 0 of rank
// 0 in a scratch build: forming the rotations ~650, the row phase ~310,
// the first cluster barrier ~620, the column phase ~510, Z^T's rows ~800
// and the second barrier ~280), and the shifts, one warp's serial QR of
// the 16 x 16 block, ~28 us a sweep, a quarter of the launch: 38 ms
// against the one-block kernel's 91 (PERF.md).  The one-block kernel
// streamed each step's m (3 n x 16 B of rows + (k + 3) x 32 B of column
// sectors) through one SM's path to the L2 cache behind three block
// barriers.

#include "ms_chase.cuh"
#include "ms_cluster.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kExcStall = 13;

__global__ void __launch_bounds__(kThreads)
schur_qr_ms_kernel(float2* __restrict__ H, float2* __restrict__ Zt,
                   long long* __restrict__ stats, int n, int m,
                   int max_sweeps) {
  extern __shared__ float2 blockB[];  // the m x m shift block
  __shared__ int red[33];
  __shared__ float s_dist[kShiftMaxM];
  __shared__ float2 s_shift[kShiftMaxM];
  __shared__ ChaseCarry cc;
  __shared__ unsigned long long s_rot;

  const int tid = threadIdx.x;
  if (tid == 0) s_rot = 0ull;
  auto alive = [&](int c) {  // subdiagonal H[c+1, c]
    return sub_alive(H[(size_t)c * n + c], H[(size_t)(c + 1) * n + c + 1],
                     H[(size_t)(c + 1) * n + c], 1.f);
  };

  int hi = n - 1, it = 0, stall = 0;
  while (hi > 0 && it < max_sweeps) {
    // ---- band scan: the active block [lo, hi] ----
    const int hi_prev = hi;
    int best = 0;
    for (int c = tid; c < hi_prev; c += kThreads)
      if (alive(c)) best = max(best, c + 1);
    hi = block_max_int(best, red);
    best = 0;
    for (int g = tid + 1; g <= hi; g += kThreads)
      if (!alive(g - 1)) best = max(best, g);
    const int lo = block_max_int(best, red);
    const bool exc = stall >= kExcStall;

    if (hi > 0) {
      // ---- shifts (warp 0) ----
      if (tid < 32)
        trailing_shifts_warp(H, n, lo, hi, m, exc, blockB, s_dist, s_shift);
      // ---- chase over the whole active block (ms_chase.cuh) ----
      chase_whole_block<kThreads>(H, Zt, n, lo, hi, m, s_shift, cc, &s_rot);
    }
    stall = (hi < hi_prev || exc) ? 0 : stall + 1;
    ++it;
  }

  for (int e = tid; e < n * n; e += kThreads)
    if (e / n > e % n) H[e] = c_make(0.f, 0.f);
  __syncthreads();
  if (tid == 0) {
    stats[0] = hi;
    stats[1] = it;
    stats[2] = (long long)s_rot;
  }
}

// The kernel the entry point launches at (n, m): the cluster size P (0:
// the one-block kernel) and whether Z^T sits in shared memory.
struct ClusterChoice {
  int P;
  bool zs;
};

ClusterChoice cluster_choice(int n, int m) {
  const int P = ms_cluster::cluster_of(n);
  const size_t room =
      ms_cluster::kSmemPerBlock - ms_cluster::kStaticReserve;
  if (ms_cluster::smem_bytes(n, P, m, true) <= room) return {P, true};
  if (ms_cluster::smem_bytes(n, P, m, false) <= room) return {P, false};
  return {0, false};
}

template <int P, bool kZs>
int launch_cluster(void* H, void* Zt, void* stats, int n, int m,
                   int max_sweeps, cudaStream_t stream) {
  auto kern = ms_cluster::kernel<P, kZs>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  if (fa.sharedSizeBytes > ms_cluster::kStaticReserve)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = ms_cluster::smem_bytes(n, P, m, kZs);
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (P > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P);
  cfg.blockDim = dim3(ms_cluster::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (float2*)H, (float2*)Zt,
                           (long long*)stats, n, m, max_sweeps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// H (in place: T on return) and Zt (Q^T in, Z^T out) are n x n complex64,
// row-major; stats takes three 64-bit integers.
extern "C" int torcwa_schur_qr_ms_c64(void* H, void* Zt, void* stats, int n,
                                      int m, int max_sweeps, void* stream) {
  if (n < 1 || m < 1 || m > kShiftMaxM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ClusterChoice ch = n >= 2 ? cluster_choice(n, m) : ClusterChoice{0};
  using ms_cluster::kSmall;
  using ms_cluster::kWide;
  if (ch.P == kSmall && ch.zs)
    return launch_cluster<kSmall, true>(H, Zt, stats, n, m, max_sweeps, s);
  if (ch.P == kSmall)
    return launch_cluster<kSmall, false>(H, Zt, stats, n, m, max_sweeps, s);
  if (ch.P == kWide && ch.zs)
    return launch_cluster<kWide, true>(H, Zt, stats, n, m, max_sweeps, s);
  if (ch.P == kWide)
    return launch_cluster<kWide, false>(H, Zt, stats, n, m, max_sweeps, s);
  const size_t smem = shift_block_elems(m) * sizeof(float2);
  cudaError_t err = set_smem(schur_qr_ms_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  schur_qr_ms_kernel<<<1, kThreads, smem, s>>>(
      (float2*)H, (float2*)Zt, (long long*)stats, n, m, max_sweeps);
  return (int)cudaGetLastError();
}

// The kernel torcwa_schur_qr_ms_c64 launches at (n, m): out[0] = the
// cluster size (0: the one-block kernel), out[1] = 1 where Z^T sits in
// shared memory, out[2] = the dynamic shared memory of a CTA in bytes.
extern "C" int torcwa_schur_qr_ms_cluster_info(int n, int m, void* out) {
  int* o = (int*)out;
  if (n < 1 || m < 1 || m > kShiftMaxM) return (int)cudaErrorInvalidValue;
  const ClusterChoice ch = n >= 2 ? cluster_choice(n, m) : ClusterChoice{0};
  o[0] = ch.P;
  o[1] = ch.zs ? 1 : 0;
  o[2] = ch.P ? (int)ms_cluster::smem_bytes(n, ch.P, m, ch.zs) : 0;
  return 0;
}
