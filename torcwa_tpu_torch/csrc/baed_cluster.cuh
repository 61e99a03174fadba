// The batched multishift Schur QR with AED of schur_qr_baed.cu on a
// thread-block cluster of P CTAs per matrix, the whole sweep loop in one
// launch (grid = P x batch).  The rules are those of the one-block kernel
// (schur_qr_baed.cu): the band scan at multiplier 1, the AED pass on the
// trailing window, the transform applied to H and Z^T where it deflates,
// the m shifts from the window, m spacing-2 bulges chased over the whole
// active block, every row rotation of a step before every column rotation.
//
// Layout: ms_cluster.cuh's: column j of H on rank j mod P in that CTA's
// shared memory (Hs[c * ld + i] = H[i, r + P c], ld = n | 1), Z^T in device
// memory, rank r owning its columns [r w, (r + 1) w), w = ceil(n / P).  Each
// CTA also holds the AED arrays of aed_warp.cuh (68,632 bytes at kw = 64):
// rank 0 works the AED there, the other ranks keep their copy of the
// transform P there.
//
// A sweep:
//  * band scan: as ms_cluster.cuh (each rank tests its own columns, writes
//    the flags to every rank; a cluster barrier; [lo, hi] on every rank);
//  * AED: the first four warps of rank 0 run aed_window_warp on the window
//    gathered through distributed shared memory (one warp chases the
//    window's Schur form, the others apply its rotations to Qm); rank 0 then
//    sends (s, kwe, ku, mhi, it) and the m shifts to every rank; a cluster
//    barrier, so that every rank takes the same control path bit for bit;
//  * where it deflates, the transform: each rank copies P = L[1:, 1:] from
//    rank 0 and applies it to its own columns of H[s:e, e:] (a warp a
//    column), to the rows of H[:s, s:e] that fall to it (a warp a row,
//    through distributed shared memory) and to its columns of Z^T[s:e, :];
//    each output is summed in ascending k, as the one-block kernel's strips
//    sum it; the owner of column lo sends the first bulge's carry; a cluster
//    barrier;
//  * the chase: ms_cluster.cuh's steps (two cluster barriers a step, Z^T's
//    rows between them), with the AED's shifts.
// Every counter (rotations, rows AED deflated, the transform's multiply-adds)
// is counted once a matrix, by rank 0; the sweeps are the matrix's own.
#pragma once

#include <cooperative_groups.h>

#include "aed_warp.cuh"
#include "ms_cluster.cuh"

namespace baed_cluster {

namespace cg = cooperative_groups;
using ms_cluster::cols_of;
using ms_cluster::ld_of;

constexpr int kAedThreads = 128;
constexpr int kAedBar = 1;
constexpr int kExcStall = 13;
constexpr int kSmall = ms_cluster::kSmall;
constexpr int kWide = ms_cluster::kWide;
// threads of a CTA: 256 in a cluster of 8 (a CTA holds up to 49 columns;
// 512 ran 4% slower at n = 338, its register cap making the AED spill),
// 512 in a cluster of 16 (1% ahead of 256 at n = 450)
__host__ __device__ constexpr int threads_of(int P) {
  return P == kSmall ? 256 : 512;
}

struct Shared {
  ms_cluster::Step step[2];
  ms_cluster::Task task[kShiftMaxM];
  float2 cx[kShiftMaxM], cy[kShiftMaxM];  // carries, written by any rank
  float2 shift[kShiftMaxM];
  AedResult aed;
  int red[33];
  int ntask, span;
};

// Dynamic shared memory of a CTA: its columns of H, the AED arrays, the
// flags.
inline size_t smem_bytes(int n, int P, int kw) {
  return ((size_t)cols_of(n, P) * ld_of(n) + aed_warp_smem_elems(kw)) *
             sizeof(float2) +
         (((size_t)n + 15) & ~(size_t)15);
}
// The cluster size for (n, kw): 8 where a CTA's share fits (more clusters
// run at once), else 16, else 0 (the one-block kernel).
inline int cluster_of(int n, int kw) {
  const size_t room =
      ms_cluster::kSmemPerBlock - ms_cluster::kStaticReserve;
  if (smem_bytes(n, kSmall, kw) <= room) return kSmall;
  if (smem_bytes(n, kWide, kw) <= room) return kWide;
  return 0;
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return c_make(__shfl_sync(0xffffffffu, v.x, src),
                __shfl_sync(0xffffffffu, v.y, src));
}

// x_k, k < w (w <= 64): two slots a lane; entry k of the warp's vector.
__device__ __forceinline__ float2 entry(const float2 (&x)[2], int k) {
  return shfl2(k < 32 ? x[0] : x[1], k & 31);
}

// X[i stride] <- sum_k P(i, k) X[k stride] (conj(P(i, k)) with kConj) for
// i < w, by one warp; P(i, k) = Pm[i * ld1 + k].  Summed in ascending k as
// the one-block kernel's slab_left sums it.
template <bool kConj>
__device__ __forceinline__ void left_column(float2* X, size_t stride,
                                            const float2* Pm, int ld1,
                                            int w) {
  const int lane = threadIdx.x & 31;
  float2 x[2], acc[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int k = lane + 32 * q;
    x[q] = k < w ? X[k * stride] : c_make(0.f, 0.f);
    acc[q] = c_make(0.f, 0.f);
  }
  for (int k = 0; k < w; ++k) {
    const float2 xk = entry(x, k);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = lane + 32 * q;
      if (i < w) {
        const float2 p = Pm[i * ld1 + k];
        acc[q] = c_add(acc[q], kConj ? c_cmul(p, xk) : c_mul(p, xk));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (lane + 32 * q < w) X[(lane + 32 * q) * stride] = acc[q];
}

template <int P>
__global__ void __launch_bounds__(threads_of(P), 1)
kernel(float2* __restrict__ Hg, float2* __restrict__ Zt,
       long long* __restrict__ stats, int n, int m, int kw, int max_sweeps) {
  constexpr int kThreads = threads_of(P);
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float2 dyn[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t mat = blockIdx.x / P;
  Hg += mat * n * n;
  Zt += mat * n * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = ld_of(n), cmax = cols_of(n, P);
  const int ncl = rank < n ? (n - rank + P - 1) / P : 0;
  const int ld1 = kw + 1;
  float2* Hs = dyn;
  float2* aed = Hs + (size_t)cmax * ld;
  float2* Pm = aed + aed_warp_L_offset(kw) + ld1 + 1;  // P(i, k) on return
  unsigned char* alive =
      reinterpret_cast<unsigned char*>(aed + aed_warp_smem_elems(kw));
  // this rank's columns of Z^T
  const int zw = cols_of(n, P), z0 = min(n, rank * zw),
            z1 = min(n, z0 + zw), zn = z1 - z0;

  // H[i, j] anywhere in the cluster
  auto hat = [&](int i, int j) -> float2* {
    return cluster.map_shared_rank(Hs, j % P) + (size_t)(j / P) * ld + i;
  };
  // a carry to every rank
  auto send = [&](float2* slot, float2 v) {
    for (int q = 0; q < P; ++q) *cluster.map_shared_rank(slot, q) = v;
  };
  // the carry of bulge j, entering at k = lo, by the owner of column lo
  auto intro = [&](int j, int lo) {
    const float2* col = Hs + (size_t)(lo / P) * ld;
    send(&sh.cx[j], c_sub(col[lo], sh.shift[j]));
    send(&sh.cy[j], col[lo + 1]);
  };

  for (int e = tid; e < ncl * n; e += kThreads) {
    const int i = e / ncl, c = e - (e / ncl) * ncl;
    Hs[(size_t)c * ld + i] = Hg[(size_t)i * n + rank + P * c];
  }
  cluster.sync();

  int hi = n - 1, it = 0, stall = 0;
  long long rot = 0, deflated = 0, cmacs = 0;
  AED_CLK(const long long clk_l0 = clock64();
          unsigned long long clk[3] = {};)
  while (hi > 0 && it < max_sweeps) {
    // ---- band scan: the active block [lo, hi] ----
    const int hi_prev = hi;
    for (int c = tid; c < ncl; c += kThreads) {
      const int j = rank + P * c;
      if (j >= hi_prev) continue;
      const float2* col = Hs + (size_t)c * ld;
      const unsigned char a =
          sub_alive(col[j], *hat(j + 1, j + 1), col[j + 1], 1.f);
      for (int q = 0; q < P; ++q) cluster.map_shared_rank(alive, q)[j] = a;
    }
    cluster.sync();
    int best = 0;
    for (int c = tid; c < hi_prev; c += kThreads)
      if (alive[c]) best = max(best, c + 1);
    hi = block_max_int(best, sh.red);
    best = 0;
    for (int g = tid + 1; g <= hi; g += kThreads)
      if (!alive[g - 1]) best = max(best, g);
    const int lo = block_max_int(best, sh.red);
    const bool exc = stall >= kExcStall;

    if (hi > 0) {
      // ---- AED on rank 0; its result and shifts to every rank ----
      AED_CLK(const long long clk_a = clock64();)
      if (rank == 0 && tid < kAedThreads) {
        const AedResult r = aed_window_warp<kAedThreads, kAedBar>(
            hat, n, lo, hi, exc, m, kw, 1.f, true, aed, sh.shift);
        for (int i = tid; i < m; i += kAedThreads)
          for (int q = 1; q < P; ++q)
            *cluster.map_shared_rank(&sh.shift[i], q) = sh.shift[i];
        if (tid == 0)
          for (int q = 0; q < P; ++q) *cluster.map_shared_rank(&sh.aed, q) = r;
      }
      cluster.sync();
      AED_CLK(const long long clk_b = clock64(); clk[0] += clk_b - clk_a;)
      const int s = sh.aed.s, kwe = sh.aed.kwe;
      const int hi_new = s + sh.aed.ku - 1;
      if (hi_new < hi) {
        // ---- the transform on the off-window slabs of H and on Z^T ----
        const int e = s + kwe;
        if (rank != 0) {
          const float2* P0 = cluster.map_shared_rank(Pm, 0);
          for (int x = tid; x < kwe * kwe; x += kThreads)
            Pm[(x / kwe) * ld1 + x % kwe] = P0[(x / kwe) * ld1 + x % kwe];
          __syncthreads();
        }
        // H[s:e, j] <- P H[s:e, j], this rank's columns j >= e
        for (int c = warp; c < ncl; c += kWarps)
          if (rank + P * c >= e)
            left_column<false>(Hs + (size_t)c * ld + s, 1, Pm, ld1, kwe);
        // H[r, s:e] <- H[r, s:e] P^H, the rows r < s that fall to this rank
        for (int r = rank * kWarps + warp; r < s; r += P * kWarps) {
          float2 x[2], acc[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int k = lane + 32 * q;
            x[q] = k < kwe ? *hat(r, s + k) : c_make(0.f, 0.f);
            acc[q] = c_make(0.f, 0.f);
          }
          for (int k = 0; k < kwe; ++k) {
            const float2 xk = entry(x, k);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int i = lane + 32 * q;
              if (i < kwe) acc[q] = c_add(acc[q], c_mulc(xk, Pm[i * ld1 + k]));
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (lane + 32 * q < kwe) *hat(r, s + lane + 32 * q) = acc[q];
        }
        // Z^T[s:e, j] <- conj(P) Z^T[s:e, j], this rank's columns of Z^T
        for (int j = z0 + warp; j < z1; j += kWarps)
          left_column<true>(Zt + (size_t)s * n + j, n, Pm, ld1, kwe);
        deflated += hi - hi_new;
        cmacs += (long long)kwe * kwe * ((n - e) + s + n);
        hi = hi_new;
      }
      if (tid == 0 && rank == lo % P && hi > lo) intro(0, lo);
      cluster.sync();
      AED_CLK(const long long clk_c = clock64(); clk[1] += clk_c - clk_b;)

      // ---- the chase: nb live bulges, steps lo .. hi - 1 + 2 (nb - 1) ----
      if (hi > lo) {
        const int nb = min(m, (hi - lo - 1) / 2 + 1);
        const int t_final = hi - 1 + 2 * (nb - 1);
        for (int t = lo; t <= t_final; ++t) {
          ms_cluster::Step& st = sh.step[t & 1];
          if (warp == 0) {
            if (lane == 0) {
              sh.ntask = 0;
              sh.span = 0;
            }
            __syncwarp();
            for (int i = lane; i < m; i += 32) {
              const int k = t - 2 * i;
              const bool act = i < nb && k >= lo && k < hi;
              st.k[i] = act ? k : -1;
              if (!act) continue;
              const Givens g = givens(sh.cx[i], sh.cy[i]);
              st.c[i] = g.c;
              st.s[i] = g.s;
              const int o0 = k % P, o1 = (k + 1) % P;
              if (rank != o0 && rank != o1) continue;
              const int kmax = min(k + 2, hi), half = (kmax + 1) / 2;
              ms_cluster::Task tk;
              tk.i = i;
              tk.r0 = rank == o0 ? 0 : half;
              tk.r1 = rank == o0 ? half : kmax + 1;
              sh.task[atomicAdd(&sh.ntask, 1)] = tk;
              atomicMax(&sh.span, tk.r1 - tk.r0);
            }
          }
          __syncthreads();

          // rows k, k+1 of this rank's columns >= max(k - 1, lo)
          const int nlive = min(nb, (t - lo) / 2 + 1);  // bulges entered
          for (int idx = tid; idx < nlive * ncl; idx += kThreads) {
            const int i = idx / ncl, c = idx - (idx / ncl) * ncl;
            const int k = st.k[i], j = rank + P * c;
            if (k < 0 || j < max(k - 1, lo)) continue;
            const float cc = st.c[i];
            const float2 sg = st.s[i];
            float2* pk = Hs + (size_t)c * ld + k;
            const float2 hk = pk[0], h1 = pk[1];
            pk[0] = c_add(c_scale(cc, hk), c_mul(sg, h1));
            pk[1] = (j == k - 1 && k > lo)
                        ? c_make(0.f, 0.f)
                        : c_sub(c_scale(cc, h1), c_cmul(sg, hk));
          }
          cluster.sync();

          // columns k, k+1, rows <= min(k + 2, hi), this rank's part
          const int ntask = sh.ntask, span = sh.span;
          for (int idx = tid; idx < ntask * span; idx += kThreads) {
            const ms_cluster::Task tk = sh.task[idx / span];
            const int r = tk.r0 + idx % span;
            if (r >= tk.r1) continue;
            const int i = tk.i, k = st.k[i];
            const float cc = st.c[i];
            const float2 sg = st.s[i];
            float2* pl = hat(r, k);
            float2* pr = hat(r, k + 1);
            const float2 l = *pl, rr = *pr;
            const float2 nl = c_add(c_scale(cc, l), c_cmul(sg, rr));
            *pl = nl;
            *pr = c_sub(c_scale(cc, rr), c_mul(sg, l));
            if (r == k + 1) {
              send(&sh.cx[i], nl);
              if (k + 2 > hi) send(&sh.cy[i], c_make(0.f, 0.f));
            }
            if (r == k + 2) send(&sh.cy[i], nl);
          }
          if (tid == 0 && rank == lo % P) {
            const int d = t + 1 - lo;
            if (d % 2 == 0 && d / 2 < nb) intro(d / 2, lo);
          }
          ms_cluster::arrive_release();

          // rows k, k+1 of this rank's columns of Z^T
          for (int idx = tid; idx < nlive * zn; idx += kThreads) {
            const int i = idx / zn, c = idx - (idx / zn) * zn;
            const int k = st.k[i];
            if (k < 0) continue;
            const float cc = st.c[i];
            const float2 sg = st.s[i];
            float2* p0 = Zt + (size_t)k * n + z0 + c;
            float2* p1 = p0 + n;
            const float2 zl = *p0, zr = *p1;
            *p0 = c_add(c_scale(cc, zl), c_cmul(sg, zr));
            *p1 = c_sub(c_scale(cc, zr), c_mul(sg, zl));
          }
          ms_cluster::wait_acquire();
        }
        rot += (long long)nb * (hi - lo);
      }
      AED_CLK(clk[2] += clock64() - clk_c;)
    }
    stall = (hi < hi_prev || exc) ? 0 : stall + 1;
    ++it;
  }
  cluster.sync();  // no rank reads another's shared memory after this
  AED_CLK(if (rank == 0 && tid == 0)
              aed_warp::add_loop_clocks(clk_l0, clk, it);)

  for (int e = tid; e < ncl * n; e += kThreads) {
    const int i = e / ncl, c = e - (e / ncl) * ncl, j = rank + P * c;
    Hg[(size_t)i * n + j] =
        i > j ? c_make(0.f, 0.f) : Hs[(size_t)c * ld + i];
  }
  if (rank == 0 && tid == 0) {
    stats += 5 * mat;
    stats[0] = hi;
    stats[1] = it;
    stats[2] = rot;
    stats[3] = deflated;
    stats[4] = cmacs;
  }
}

}  // namespace baed_cluster
