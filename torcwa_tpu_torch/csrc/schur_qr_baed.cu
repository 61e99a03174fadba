// Batched multishift complex Schur QR with aggressive early deflation (AED)
// inside the launch: H = Z T Z^H with T upper triangular, for a batch of upper
// Hessenberg matrices with their accumulated Q.
//
// Replaces the TPU kernel
// torcwa_tpu/ops/attic/eig_qr_pallas_baed.py::_kernel_baed with its
// _mini_schur_b (public entry schur_qr_pallas_baed) and keeps its rules, per
// matrix and per sweep:
//  * band scan at eps (|d| + |d'|) (multiplier 1): the active block [lo, hi]
//    is the bottom-most alive run at or above the previous bottom;
//  * AED on the kw-row trailing window from s = max(hi - kw + 1, lo + 1)
//    (aed_warp.cuh): single-shift Schur form of the window with accumulated
//    vectors, budget 3 kw + 40; the spike beta Qm[:, 0]; the bottom run of
//    converged lanes with |spike_i| <= eps max(|T_ii|, max|W|) deflates, max|W|
//    over the uncut kw-row window as the TPU kernel sees it; the transform is
//    applied to H's rows and columns and to Z only where it deflates, with the
//    structural zeros exact;
//  * shifts: the m undeflated window eigenvalues nearest the new corner, ties
//    by index; after 13 sweeps without progress one exceptional sweep with the
//    perturbed trailing undeflated diagonals;
//  * EVERY sweep then chases up to m spacing-2 bulges over the whole active
//    block [lo, hi] with the post-AED hi (ms_chase.cuh); no sweep skips its
//    chase (schur_ms.cu's nibble rule is not this kernel's);
//  * stall counts sweeps whose post-AED bottom did not move; budget max_sweeps
//    sweeps per matrix; stats = (final bottom, sweeps, rotations applied, rows
//    AED deflated, complex multiply-adds of the applied AED transforms),
//    bottom 0 meaning converged.  The wrapper NaN-poisons the diagonal where
//    the bottom is not 0.
// Not carried over, because they serve the TPU's matrix unit and compiler: the
// one-hot selection and embedding GEMMs, the (kw + 8) pad, the deferred-column
// accumulator W with its prefix-bucket switch, the split-real pairs, the
// chunking of the batch by a memory budget, the copy-in, and the lock step of
// the lanes: there one loop runs until the slowest lane is done and every
// lane pays every sweep; here a matrix's block ends with its own last sweep.
//
// Design: two kernels, chosen by n, kw and the batch in the C entry point
// (baed_cluster::cluster_of; ops/schur_qr_baed.py: schur_qr_baed_cluster
// mirrors it, torcwa_schur_qr_baed_cluster_info reports it):
//
// * baed_cluster::kernel<P> (baed_cluster.cuh): one thread-block cluster of
//   P CTAs per matrix, H in the cluster's distributed shared memory (column
//   j on rank j mod P), Z^T in device memory, a slice of its columns per
//   rank; the AED on rank 0, its transform applied by every rank to its own
//   part, ms_cluster.cuh's chase (two cluster barriers a step).  P = 8
//   where a CTA's columns of H and the AED arrays fit its shared memory (n
//   <= 392 at kw = 64), else 16 (n <= 553); a cluster of 8 leaves room for
//   twice the clusters at once.  Only for a batch that runs in one wave of
//   clusters (15 of 8 or 7 of 16 at once on an H100): a second wave would
//   double the time, where the one-block kernel runs every matrix at once.
// * schur_qr_baed_kernel, above or for a larger batch: one thread block of
//   1024 threads per matrix, the sweep loop in place on H and Z^T in device
//   memory.  The band scan is two block-wide max-reductions; the AED runs
//   in the block's first four warps on a named barrier while the other
//   warps wait at the block barrier; its off-window products, P (kwe x kwe)
//   times the slabs
//   H[s:e, e:], H[:s, s:e] and Z^T[s:e, :], are computed by the whole block:
//   a strip of 2 kw columns (rows) of the slab is staged in shared memory,
//   each thread accumulates up to 8 outputs in registers, and the strip is
//   written back in place; then the chase, three barriers a step
//   (ms_chase.cuh).
// Both run the AED of aed_warp.cuh: one warp chases the window's Schur form
// with __syncwarp() only, the other AED warps apply its rotations to the
// Schur vectors a sweep behind, one named barrier a sweep.
//
// What bounds it on an H100: latency.  The AED window's QR is a serial
// chain of ~kw^2 rotations a pass on one warp; a chase step is O(m n) work
// behind two cluster (three block) barriers; the slab products are the
// only throughput part (8 kwe^2 (2 n - kwe) flops per deflating sweep).

#include "aed_warp.cuh"
#include "baed_cluster.cuh"
#include "ms_chase.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kAedThreads = 128;
constexpr int kAedBar = 1;        // named barrier of the AED warps
constexpr int kExcStall = 13;
constexpr int kAcc = 8;           // outputs a thread accumulates per strip

// X[row0 + i, j] <- sum_k P(i, k) X[row0 + k, j] (conj(P) when kConj) for
// i < w, c0 <= j < c1, in place; X has leading dimension n, P(i, k) =
// L[(i + 1) ld1 + k + 1].  stage: w * cw float2 of shared memory, cw columns
// a strip.  Called by all threads; starts and ends on a block barrier.
template <bool kConj>
__device__ void slab_left(float2* X, int n, int row0, int w, int c0, int c1,
                          const float2* L, int ld1, float2* stage, int cw) {
  const int tid = threadIdx.x;
  const int groups = kThreads / cw;       // row groups, <= kAcc rows each
  const int j = tid % cw, rg = tid / cw;
  for (int cb = c0; cb < c1; cb += cw) {
    const int nc = min(cw, c1 - cb);
    __syncthreads();
    for (int e = tid; e < w * nc; e += kThreads)
      stage[(e / nc) * cw + e % nc] = X[(size_t)(row0 + e / nc) * n + cb + e % nc];
    __syncthreads();
    if (rg < groups && j < nc) {
      float2 acc[kAcc];
#pragma unroll
      for (int q = 0; q < kAcc; ++q) acc[q] = c_make(0.f, 0.f);
      for (int k = 0; k < w; ++k) {
        const float2 x = stage[k * cw + j];
#pragma unroll
        for (int q = 0; q < kAcc; ++q) {
          const int i = rg + groups * q;
          if (i < w) {
            const float2 p = L[(i + 1) * ld1 + k + 1];
            acc[q] = c_add(acc[q], kConj ? c_cmul(p, x) : c_mul(p, x));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        const int i = rg + groups * q;
        if (i < w) X[(size_t)(row0 + i) * n + cb + j] = acc[q];
      }
    }
  }
  __syncthreads();
}

// X[r, col0 + i] <- sum_k X[r, col0 + k] conj(P(i, k)) for i < w, r0 <= r <
// r1, in place.  A strip of cw - 1 rows is staged transposed with the odd
// leading dimension cw - 1, which keeps the shared-memory banks apart.
__device__ void slab_right(float2* X, int n, int r0, int r1, int col0, int w,
                           const float2* L, int ld1, float2* stage, int cw) {
  const int tid = threadIdx.x;
  const int rows = cw - 1;                // rows a strip, and its stride
  const int groups = kThreads / cw;
  const int r = tid % cw, cg = tid / cw;
  for (int rb = r0; rb < r1; rb += rows) {
    const int nr = min(rows, r1 - rb);
    __syncthreads();
    for (int e = tid; e < nr * w; e += kThreads)
      stage[(e % w) * rows + e / w] = X[(size_t)(rb + e / w) * n + col0 + e % w];
    __syncthreads();
    if (cg < groups && r < nr) {
      float2 acc[kAcc];
#pragma unroll
      for (int q = 0; q < kAcc; ++q) acc[q] = c_make(0.f, 0.f);
      for (int k = 0; k < w; ++k) {
        const float2 x = stage[k * rows + r];
#pragma unroll
        for (int q = 0; q < kAcc; ++q) {
          const int i = cg + groups * q;
          if (i < w)
            acc[q] = c_add(acc[q], c_mulc(x, L[(i + 1) * ld1 + k + 1]));
        }
      }
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        const int i = cg + groups * q;
        if (i < w) X[(size_t)(rb + r) * n + col0 + i] = acc[q];
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
schur_qr_baed_kernel(float2* H, float2* Zt, long long* __restrict__ stats,
                     int n, int m, int kw, int max_sweeps) {
  extern __shared__ float2 sm[];  // the AED arrays, then the strips
  __shared__ int red[33];
  __shared__ float2 s_shift[kShiftMaxM];
  __shared__ ChaseCarry cc;
  __shared__ unsigned long long s_rot;
  __shared__ AedResult s_aed;

  H += (size_t)blockIdx.x * n * n;
  Zt += (size_t)blockIdx.x * n * n;
  stats += 5 * (size_t)blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) s_rot = 0ull;
  auto alive = [&](int c) {  // subdiagonal H[c+1, c]
    return sub_alive(H[(size_t)c * n + c], H[(size_t)(c + 1) * n + c + 1],
                     H[(size_t)(c + 1) * n + c], 1.f);
  };
  auto hat = [&](int i, int j) { return H + (size_t)i * n + j; };
  const float2* L = sm + aed_warp_L_offset(kw);
  float2* stage = sm + aed_warp_smem_elems(kw);
  const int ld1 = kw + 1, cw = 2 * kw;

  int hi = n - 1, it = 0, stall = 0;
  long long deflated = 0, aed_cmacs = 0;
  AED_CLK(const long long clk_l0 = clock64();
          unsigned long long clk[3] = {};)
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
      // ---- AED in the first warps; the shifts come with it ----
      AED_CLK(const long long clk_a = clock64();)
      if (tid < kAedThreads) {
        const AedResult r = aed_window_warp<kAedThreads, kAedBar>(
            hat, n, lo, hi, exc, m, kw, 1.f, true, sm, s_shift);
        if (tid == 0) s_aed = r;
      }
      __syncthreads();
      AED_CLK(const long long clk_b = clock64(); clk[0] += clk_b - clk_a;)
      const int s = s_aed.s, kwe = s_aed.kwe;
      const int hi_new = s + s_aed.ku - 1;
      if (hi_new < hi) {
        // ---- the transform on the off-window slabs of H and on Z^T ----
        const int e = s + kwe;
        slab_left<false>(H, n, s, kwe, e, n, L, ld1, stage, cw);
        slab_right(H, n, 0, s, s, kwe, L, ld1, stage, cw);
        slab_left<true>(Zt, n, s, kwe, 0, n, L, ld1, stage, cw);
        deflated += hi - hi_new;
        aed_cmacs += (long long)kwe * kwe * ((n - e) + s + n);
        hi = hi_new;
      }
      // ---- chase over the whole active block (ms_chase.cuh) ----
      AED_CLK(const long long clk_c = clock64(); clk[1] += clk_c - clk_b;)
      if (hi > lo)
        chase_whole_block<kThreads>(H, Zt, n, lo, hi, m, s_shift, cc, &s_rot);
      AED_CLK(clk[2] += clock64() - clk_c;)
    }
    stall = (hi < hi_prev || exc) ? 0 : stall + 1;
    ++it;
  }

  __syncthreads();
  AED_CLK(if (tid == 0) aed_warp::add_loop_clocks(clk_l0, clk, it);)
  for (int e = tid; e < n * n; e += kThreads)
    if (e / n > e % n) H[e] = c_make(0.f, 0.f);
  if (tid == 0) {
    stats[0] = hi;
    stats[1] = it;
    stats[2] = (long long)s_rot;
    stats[3] = deflated;
    stats[4] = aed_cmacs;
  }
}

// dynamic shared memory of the one-block kernel: the AED arrays and a strip
// of 2 kw columns (rows) of kw entries
size_t one_block_smem(int kw) {
  return (aed_warp_smem_elems(kw) + 2 * (size_t)kw * kw) * sizeof(float2);
}

template <int P>
cudaError_t prepare_cluster(size_t smem) {
  auto kern = baed_cluster::kernel<P>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return err;
  if (fa.sharedSizeBytes > ms_cluster::kStaticReserve)
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  if (P > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int P>
cudaLaunchConfig_t cluster_config(int batch, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = P;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * batch);
  cfg.blockDim = dim3(baed_cluster::threads_of(P));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int P>
int launch_cluster(void* H, void* Zt, void* stats, int batch, int n, int m,
                   int kw, int max_sweeps, cudaStream_t stream) {
  const size_t smem = baed_cluster::smem_bytes(n, P, kw);
  cudaError_t err = prepare_cluster<P>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<P>(batch, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, baed_cluster::kernel<P>, (float2*)H,
                           (float2*)Zt, (long long*)stats, n, m, kw,
                           max_sweeps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int P>
int max_clusters(int n, int kw, int* out) {
  const size_t smem = baed_cluster::smem_bytes(n, P, kw);
  cudaError_t err = prepare_cluster<P>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<P>(1, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, baed_cluster::kernel<P>,
                                             &cfg);
}

bool valid(int n, int m, int kw) {
  return n >= 2 && m >= 1 && m <= kShiftMaxM && m <= kw && kw <= kAedMaxKw &&
         (kThreads / (2 * kw)) * kAcc >= kw;
}

}  // namespace

// H (in place: T on return) and Zt (Q^T in, Z^T out): batch x n x n
// complex64, row-major; stats takes five 64-bit integers per matrix.
extern "C" int torcwa_schur_qr_baed_c64(void* H, void* Zt, void* stats,
                                        int batch, int n, int m, int kw,
                                        int max_sweeps, void* stream) {
  if (batch <= 0) return 0;
  // a strip's kThreads / (2 kw) thread groups of kAcc accumulators each must
  // cover the kw rows of the transform (true for every kw <= 64)
  if (!valid(n, m, kw)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // a cluster kernel only where the batch runs in one wave of clusters:
  // a second wave doubles the time, and the one-block kernel runs every
  // matrix at once on an SM of its own
  int P = baed_cluster::cluster_of(n, kw), fit = 0;
  if (P) {
    const int err = P == baed_cluster::kSmall
                        ? max_clusters<baed_cluster::kSmall>(n, kw, &fit)
                        : max_clusters<baed_cluster::kWide>(n, kw, &fit);
    if (err) return err;
    if (batch > fit) P = 0;
  }
  switch (P) {
    case baed_cluster::kSmall:
      return launch_cluster<baed_cluster::kSmall>(H, Zt, stats, batch, n, m,
                                                  kw, max_sweeps, st);
    case baed_cluster::kWide:
      return launch_cluster<baed_cluster::kWide>(H, Zt, stats, batch, n, m,
                                                 kw, max_sweeps, st);
    default:
      break;
  }
  const size_t smem = one_block_smem(kw);
  cudaError_t err = set_smem(schur_qr_baed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  schur_qr_baed_kernel<<<batch, kThreads, smem, st>>>(
      (float2*)H, (float2*)Zt, (long long*)stats, n, m, kw, max_sweeps);
  return (int)cudaGetLastError();
}

// The kernel torcwa_schur_qr_baed_c64 launches at (n, m, kw): out[0] = the
// cluster size (0: the one-block kernel), out[1] = the dynamic shared
// memory of a CTA (block) in bytes, out[2] = the clusters the card runs at
// once (cudaOccupancyMaxActiveClusters; 0 for the one-block kernel).  A
// batch of more than out[2] matrices takes the one-block kernel.
extern "C" int torcwa_schur_qr_baed_cluster_info(int n, int m, int kw,
                                                 void* out) {
  int* o = (int*)out;
  if (!valid(n, m, kw)) return (int)cudaErrorInvalidValue;
  const int P = baed_cluster::cluster_of(n, kw);
  o[0] = P;
  o[1] = (int)(P ? baed_cluster::smem_bytes(n, P, kw) : one_block_smem(kw));
  o[2] = 0;
  if (P == baed_cluster::kSmall)
    return max_clusters<baed_cluster::kSmall>(n, kw, o + 2);
  if (P == baed_cluster::kWide)
    return max_clusters<baed_cluster::kWide>(n, kw, o + 2);
  return 0;
}
