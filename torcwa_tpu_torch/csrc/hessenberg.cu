// Batched complex Householder reduction to upper Hessenberg form with the
// unitary factor accumulated: A = Q H Q^H.
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_pallas.py::_kernel_hess
// (public entry hessenberg_pallas).  Same reflector convention, so H and Q
// agree element by element: for column k, x = H[k+1:, k],
// v = x + phase(x_0) ||x|| e_1, beta = 2 / ||v||^2; then
// w = beta v^H H, H -= v w, u = beta H v, H -= u v^H, Q -= (beta Q v) v^H.
// The entries below the subdiagonal are zeroed at the end.  Columns left
// of k are not touched by the row update: they hold only round-off that
// the final mask zeroes.
//
// Two kernels, chosen by n in the C entry point (kCluster where a CTA's
// columns of H fit its shared memory, else kMaxCluster, else one block;
// ops/eig_kernels.py: hessenberg_cluster mirrors the choice):
//
// * hessenberg_cluster_kernel<P>: one thread-block cluster of P CTAs per
//   matrix (P = 8, or 16, a non-portable size, where 8 cannot hold n), H
//   held in the cluster's shared memory.  Column j lives on rank j mod P
//   (Hs[c * n + i] = H[i, r + P c]), so the shrinking trailing matrix stays
//   spread over all P CTAs.  A step k is:
//     - every CTA reads column k from its owner through distributed shared
//       memory and forms v and beta itself (one warp; the same bits on
//       every rank);
//     - w = beta v^H H and H -= v w on its own columns right of k (a warp
//       a column, the column in registers between the two); the owner's
//       column k waits until every rank has read it, after the second
//       cluster barrier;
//     - the partial sums of H v over its own columns right of k, one
//       n-vector in its shared memory; arrive at the cluster barrier;
//     - u_i = beta (part_0[i] + part_1[i] + ... + part_{P-1}[i]), summed in
//       rank order from every rank's shared memory, and H -= u v^H on its
//       own columns; arrive at the cluster barrier.
//   Q has only the right update Q -= (beta Q v) v^H, which needs v alone,
//   so rank r owns the rows i = r + P t of Q, in place in device memory
//   (L2-resident).  It keeps the last kQBatch reflectors and applies them
//   together every kQBatch steps, a warp a row held in registers (loaded
//   and stored once for the batch), between its arrival at the second
//   barrier and its wait on it.
// * hessenberg_kernel, for larger n: one 1024-thread block per matrix, H
//   and Q in device memory, six phases a step separated by block
//   barriers (two block reductions for the reflector, w with threads over
//   columns and rows in up to 32 groups, the rank-1 row update, u and Q v
//   as warp-per-row dot products, the rank-1 column updates).
//
// What bounds it on an H100: latency, not arithmetic (4 n^3 complex flops,
// ~0.6 GFLOP per matrix at n = 338) or bytes.  Each of the n - 2 steps is a
// chain of five parts of 2-4k cycles each (the reflector, the column
// phase, the partial sums, Q's rows, the remote sums and column updates;
// ~16k cycles a step at P = 8, n = 338, from a clock64() build), of which
// the two cluster barriers take ~0.7k.  At P = 16 a step is no shorter,
// and an H100 runs only 7 clusters of 16 at once against 15 of 8, so a
// batch of 8 takes two waves: P = 8 wherever it holds n.
//
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 32;  // row groups of the w phase

// the cluster kernel
constexpr int kCThreads = 512;
constexpr int kCWarps = kCThreads / 32;
constexpr int kCluster = 8;      // portable: wherever it holds n
constexpr int kMaxCluster = 16;  // non-portable: the largest an H100 takes
// lane-strided entries of a column or row a lane holds: n <= 32 kPerLane
// (the largest n whose columns fit a cluster of 16 is 640)
constexpr int kPerLane = 21;
// reflectors that Q's rows take per load: v of the last kQBatch steps kept
constexpr int kQBatch = 4;
// dynamic shared memory a block may use on an H100 (227 KB)
constexpr size_t kSmemPerBlock = 232448;

// Bytes of dynamic shared memory of one CTA of the cluster kernel: room
// for ceil(n / P) columns of H, the last kQBatch reflectors v and their
// beta (one float2 each) and the partial sums of u.  ops/eig_kernels.py
// mirrors the count (cluster_smem_bytes).
size_t cluster_smem(int n, int P) {
  const size_t cols = (size_t)(n + P - 1) / P;
  return (cols * n + (kQBatch + 1) * (size_t)n + kQBatch) * sizeof(float2);
}

// The cluster size at n: kCluster where a CTA holds its columns of H, else
// kMaxCluster where that does, else 0 (the one-block kernel).
int cluster_size(int n) {
  if (n > 32 * kPerLane) return 0;
  if (cluster_smem(n, kCluster) <= kSmemPerBlock) return kCluster;
  if (cluster_smem(n, kMaxCluster) <= kSmemPerBlock) return kMaxCluster;
  return 0;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Reflector k on the column x of H, x -= v (beta v^H x), by one warp: the
// entries k+1 .. n-1, lane-strided, stay in registers between the dot
// product and the update.
__device__ __forceinline__ void column_reflect(float2* x, const float2* v,
                                               float beta, int k, int n,
                                               int lane) {
  float2 xr[kPerLane];
  float ar = 0.f, ai = 0.f;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    if (k + 1 + 32 * t >= n) break;  // the same for every lane
    const int i = k + 1 + lane + 32 * t;
    if (i < n) {
      xr[t] = x[i];
      const float2 p = c_cmul(v[i], xr[t]);
      ar += p.x;
      ai += p.y;
    }
  }
  const float2 w = c_make(beta * warp_sum(ar), beta * warp_sum(ai));
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    if (k + 1 + 32 * t >= n) break;
    const int i = k + 1 + lane + 32 * t;
    if (i < n) x[i] = c_sub(xr[t], c_mul(v[i], w));
  }
}

// The reflectors k0 .. k1 in turn on a row x of Q held by a warp's lanes
// (entries k0+1 .. n-1, lane-strided), loaded and stored once:
// x -= (beta_k x v_k) v_k^H, the sum over j > k.
__device__ __forceinline__ void row_reflect(float2* x, const float2* vring,
                                            const float2* betas, int k0,
                                            int k1, int n, int lane) {
  float2 xr[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    if (k0 + 1 + 32 * t >= n) break;
    const int j = k0 + 1 + lane + 32 * t;
    if (j < n) xr[t] = x[j];
  }
  for (int k = k0; k <= k1; ++k) {
    const float2* v = vring + (size_t)(k % kQBatch) * n;
    float ar = 0.f, ai = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      if (k0 + 1 + 32 * t >= n) break;
      const int j = k0 + 1 + lane + 32 * t;
      if (j > k && j < n) {
        const float2 p = c_mul(xr[t], v[j]);
        ar += p.x;
        ai += p.y;
      }
    }
    const float beta = betas[k % kQBatch].x;
    const float2 uq = c_make(beta * warp_sum(ar), beta * warp_sum(ai));
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      if (k0 + 1 + 32 * t >= n) break;
      const int j = k0 + 1 + lane + 32 * t;
      if (j > k && j < n) xr[t] = c_sub(xr[t], c_mulc(uq, v[j]));
    }
  }
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    if (k0 + 1 + 32 * t >= n) break;
    const int j = k0 + 1 + lane + 32 * t;
    if (j < n) x[j] = xr[t];
  }
}

template <int P>
__global__ void __launch_bounds__(kCThreads, 1)
hessenberg_cluster_kernel(const float2* __restrict__ A, float2* __restrict__ H,
                          float2* __restrict__ Q, int n) {
  extern __shared__ float2 sh[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const size_t off = (size_t)(blockIdx.x / P) * n * n;
  A += off;
  H += off;
  Q += off;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // this rank's columns j = r + P c of H and rows i = r + P t of Q
  const int ncl = r < n ? (n - r + P - 1) / P : 0;
  // the same offsets on every rank: remote reads map them
  float2* Hs = sh;                                     // Hs[c * n + i]
  float2* vring = Hs + (size_t)((n + P - 1) / P) * n;  // v of the last steps
  float2* part = vring + (size_t)kQBatch * n;          // sum over own cols
  float2* betas = part + n;
  float2* qrows = Q + (size_t)r * n;  // row r + P t at qrows + t P n

  for (int e = tid; e < ncl * n; e += kCThreads) {
    const int i = e / ncl, c = e % ncl;
    Hs[(size_t)c * n + i] = A[(size_t)i * n + r + P * c];
  }
  for (int e = tid; e < ncl * n; e += kCThreads) {
    const int t = e / n, j = e % n;
    qrows[(size_t)t * P * n + j] = c_make(r + P * t == j ? 1.f : 0.f, 0.f);
  }
  cluster_arrive();

  for (int k = 0; k < n - 2; ++k) {
    cluster_wait();
    const int owner = k % P;
    float2* vs = vring + (size_t)(k % kQBatch) * n;
    // ---- v and beta from column k, on every rank ----
    {
      const float2* col =
          cluster.map_shared_rank(Hs, owner) + (size_t)(k / P) * n;
      for (int i = k + 1 + tid; i < n; i += kCThreads) vs[i] = col[i];
    }
    __syncthreads();
    if (warp == 0) {
      float s = 0.f;
      for (int i = k + 1 + lane; i < n; i += 32) s += c_abs2(vs[i]);
      const float xnorm = sqrtf(warp_sum(s));
      const float2 alpha = vs[k + 1];
      const float aabs = sqrtf(c_abs2(alpha));
      const float phr = aabs > 0.f ? alpha.x / aabs : 1.f;
      const float phi = aabs > 0.f ? alpha.y / aabs : 0.f;
      const float2 v1 = c_add(alpha, c_make(phr * xnorm, phi * xnorm));
      s = 0.f;
      for (int i = k + 1 + lane; i < n; i += 32)
        s += c_abs2(i == k + 1 ? v1 : vs[i]);
      const float vnorm2 = warp_sum(s);
      if (lane == 0) {
        vs[k + 1] = v1;
        betas[k % kQBatch].x = vnorm2 > 0.f ? 2.f / vnorm2 : 0.f;
      }
    }
    __syncthreads();
    const float beta = betas[k % kQBatch].x;
    // first own column right of k
    const int c1 = k + 1 - r <= 0 ? 0 : (k + 1 - r + P - 1) / P;

    // ---- w and H -= v w on own columns > k ----
    for (int c = c1 + warp; c < ncl; c += kCWarps)
      column_reflect(Hs + (size_t)c * n, vs, beta, k, n, lane);
    __syncthreads();

    // ---- partial sums of H v over own columns > k ----
    for (int i = tid; i < n; i += kCThreads) {
      float2 acc = c_make(0.f, 0.f);
      for (int c = c1; c < ncl; ++c)
        acc = c_add(acc, c_mul(Hs[(size_t)c * n + i], vs[r + P * c]));
      part[i] = acc;
    }
    cluster_arrive();

    // ---- Q -= (beta Q v) v^H on own rows, the last kQBatch steps' v in
    // turn, while the others arrive ----
    if (k % kQBatch == kQBatch - 1 || k == n - 3)
      for (int t = warp; t < ncl; t += kCWarps)
        row_reflect(qrows + (size_t)t * P * n, vring, betas,
                    k - k % kQBatch, k, n, lane);
    cluster_wait();

    // ---- the owner's column k: every rank has read it ----
    if (r == owner && warp == kCWarps - 1)
      column_reflect(Hs + (size_t)(k / P) * n, vs, beta, k, n, lane);

    // ---- u = beta H v in rank order, H -= u v^H on own columns > k ----
    for (int i = tid; i < n; i += kCThreads) {
      float2 pr[P];
#pragma unroll
      for (int q = 0; q < P; ++q) pr[q] = cluster.map_shared_rank(part, q)[i];
      float2 acc = pr[0];
#pragma unroll
      for (int q = 1; q < P; ++q) acc = c_add(acc, pr[q]);
      const float2 u = c_scale(beta, acc);
      for (int c = c1; c < ncl; ++c) {
        float2* h = Hs + (size_t)c * n + i;
        *h = c_sub(*h, c_mulc(u, vs[r + P * c]));
      }
    }
    cluster_arrive();
  }
  cluster_wait();  // no rank reads another's shared memory after this

  for (int e = tid; e < ncl * n; e += kCThreads) {
    const int i = e / ncl, c = e % ncl, j = r + P * c;
    H[(size_t)i * n + j] =
        i > j + 1 ? c_make(0.f, 0.f) : Hs[(size_t)c * n + i];
  }
}

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

// Launch configuration of the cluster kernel for P at n, `batch`
// matrices; sets the kernel's shared-memory and cluster-size attributes.
template <int P>
cudaError_t cluster_config(int batch, int n, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = cluster_smem(n, P);
  cudaError_t err = cudaFuncSetAttribute(
      hessenberg_cluster_kernel<P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (P > 8) {
    err = cudaFuncSetAttribute(hessenberg_cluster_kernel<P>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = P;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(batch * P);
  cfg->blockDim = dim3(kCThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int P>
int launch_cluster(const void* A, void* H, void* Q, int batch, int n,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<P>(batch, n, stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, hessenberg_cluster_kernel<P>,
                           (const float2*)A, (float2*)H, (float2*)Q, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int P>
int cluster_info(int n, int* o) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<P>(1, n, 0, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, hessenberg_cluster_kernel<P>,
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  o[0] = P;
  o[1] = (int)cfg.dynamicSmemBytes;
  o[2] = active;
  return 0;
}

}  // namespace

// A cluster of cluster_size(n) CTAs per matrix, or one block per matrix
// where that is 0.
extern "C" int torcwa_hessenberg_c64(const void* A, void* H, void* Q,
                                     int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int P = cluster_size(n);
  if (P == kCluster)
    return launch_cluster<kCluster>(A, H, Q, batch, n, (cudaStream_t)stream);
  if (P == kMaxCluster)
    return launch_cluster<kMaxCluster>(A, H, Q, batch, n,
                                       (cudaStream_t)stream);
  const size_t smem =
      (4 * (size_t)n + (size_t)max(kThreads, n)) * sizeof(float2);
  cudaError_t err = set_smem(hessenberg_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  hessenberg_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)A, (float2*)H, (float2*)Q, n);
  return (int)cudaGetLastError();
}

// The kernel torcwa_hessenberg_c64 launches at n: out[0] = the cluster
// size (0: one block per matrix, and nothing else is written), out[1] =
// dynamic shared memory of a CTA in bytes, out[2] = how many clusters the
// card runs at once (cudaOccupancyMaxActiveClusters).
extern "C" int torcwa_hessenberg_cluster_info(int n, void* out) {
  int* o = (int*)out;
  o[0] = cluster_size(n);
  if (o[0] == kCluster) return cluster_info<kCluster>(n, o);
  if (o[0] == kMaxCluster) return cluster_info<kMaxCluster>(n, o);
  return 0;
}
