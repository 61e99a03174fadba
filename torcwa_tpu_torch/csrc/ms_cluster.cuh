// The one-matrix multishift Schur QR of schur_qr_ms.cu on a thread-block
// cluster of P CTAs, the whole sweep loop in one launch.  The rules are
// those of the one-block kernel (schur_qr_ms.cu): the band scan, the shifts
// (trailing_shifts_warp of ms_shifts.cuh), m spacing-2 bulges chased over
// the whole active block, rotations formed by givens() of common.cuh, every
// row rotation of a step before every column rotation, a row rotation over
// the columns >= max(k - 1, lo) only.
//
// Layout: column j of H lives on rank j mod P, in that CTA's shared memory
// (Hs[c * ld + i] = H[i, r + P c], ld = n | 1 so that a warp's 8-byte reads
// of one row across its columns hit every bank once).  Z is held transposed
// as in the one-block kernel, so that Z <- Z G^H is a rotation of two rows
// of Z^T; with kZs its columns are split as H's are and sit beside H in
// shared memory, else rank r owns the contiguous slice of Z^T's columns
// [r w, (r + 1) w), w = ceil(n / P), in device memory.
//
// A sweep:
//  * band scan: each rank tests the subdiagonals of its own columns (the
//    diagonal entry right of a column is read from its owner) and writes
//    the flags to every rank; after a cluster barrier every rank finds
//    [lo, hi] from its own copy (two block-wide max reductions);
//  * shifts: warp 0 of every rank reads the trailing L x L block through
//    distributed shared memory into a row-major copy and runs
//    trailing_shifts_warp on it (base 0, hi L - 1: the same block, the same
//    bits on every rank); the owner of column lo writes the first bulge's
//    carry (H[lo, lo] - sigma_0, H[lo + 1, lo]) to every rank; a cluster
//    barrier;
//  * a chase step t: warp 0 of every rank forms the step's rotations from
//    the carries in its own shared memory (the same bits on every rank)
//    and lists the column rotations this rank takes part in; every rank
//    rotates rows k, k + 1 of its own columns of H; cluster barrier; the
//    column rotations of columns k, k + 1 (rows <= min(k + 2, hi)) are
//    split between the owners of the two columns, rows [0, half) on the
//    owner of k, [half, kmax] on the owner of k + 1, each reading and
//    writing the other column through distributed shared memory; the
//    threads that write H[k + 1, k] and H[k + 2, k] send them to every
//    rank as the bulge's next carry, and the owner of column lo sends the
//    carry of the bulge that enters next step (column lo is not touched
//    between this step's row phase and the next one's); arrive at the
//    cluster barrier; rows k, k + 1 of this rank's part of Z^T while the
//    others arrive (nothing reads Z^T before the end); wait.  The
//    rotations are double-buffered by the step's parity, since Z^T's rows
//    of step t may still be rotated while warp 0 forms step t + 1.
// Two cluster barriers a step (the one-block kernel: three block
// barriers), three a sweep more.  Every rank takes the same control path:
// lo, hi, the stall count and the step range come from values every rank
// holds bit for bit.
#pragma once

#include <cooperative_groups.h>

#include "ms_shifts.cuh"

namespace ms_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kExcStall = 13;
// dynamic shared memory a block may use on an H100, and what the kernel's
// static shared memory may take of it (checked at launch)
constexpr size_t kSmemPerBlock = 232448;
constexpr size_t kStaticReserve = 8192;
// P = kSmall where a rank holds at most kSmallCols columns, else kWide
constexpr int kSmall = 8;
constexpr int kWide = 16;
constexpr int kSmallCols = 32;

// A chase step's rotations: k[i] = row of bulge i, -1 when it is idle.
struct Step {
  float c[kShiftMaxM];
  float2 s[kShiftMaxM];
  int k[kShiftMaxM];
};

// A column-phase task of this rank: bulge i, rows [r0, r1).
struct Task {
  int i, r0, r1;
};

struct Shared {
  Step step[2];
  Task task[kShiftMaxM];
  float2 cx[kShiftMaxM], cy[kShiftMaxM];  // carries, written by any rank
  float2 shift[kShiftMaxM];
  float dist[kShiftMaxM];
  int red[33];
  int ntask, span;
};

__host__ __device__ inline int ld_of(int n) { return n | 1; }
__host__ __device__ inline int cols_of(int n, int P) {
  return (n + P - 1) / P;
}
inline int cluster_of(int n) {
  return cols_of(n, kSmall) <= kSmallCols ? kSmall : kWide;
}
// Dynamic shared memory of a CTA: its columns of H (and of Z^T with zs),
// the trailing block's copy and trailing_shifts_warp's scratch, the flags.
inline size_t smem_bytes(int n, int P, int m, bool zs) {
  const size_t cols = (size_t)cols_of(n, P) * ld_of(n) * (zs ? 2 : 1);
  return (cols + (size_t)m * m + shift_block_elems(m)) * sizeof(float2) +
         (((size_t)n + 15) & ~(size_t)15);
}

__device__ __forceinline__ void arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int P, bool kZs>
__global__ void __launch_bounds__(kThreads, 1)
kernel(float2* __restrict__ H, float2* __restrict__ Zt,
       long long* __restrict__ stats, int n, int m, int max_sweeps) {
  extern __shared__ float2 dyn[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = ld_of(n), cmax = cols_of(n, P);
  const int ncl = rank < n ? (n - rank + P - 1) / P : 0;
  float2* Hs = dyn;
  float2* Zs = Hs + (size_t)cmax * ld;
  float2* stage = Zs + (kZs ? (size_t)cmax * ld : 0);
  float2* B = stage + (size_t)m * m;
  unsigned char* alive =
      reinterpret_cast<unsigned char*>(B + shift_block_elems(m));
  // this rank's columns of Z^T in device memory (without kZs)
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
    Hs[(size_t)c * ld + i] = H[(size_t)i * n + rank + P * c];
    if (kZs) Zs[(size_t)c * ld + i] = Zt[(size_t)i * n + rank + P * c];
  }
  cluster.sync();

  int hi = n - 1, it = 0, stall = 0;
  long long rot = 0;
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
      // ---- shifts, on every rank ----
      const int base = max(hi - (m - 1), lo), L = hi - base + 1;
      if (warp == 0) {
        for (int e = lane; e < L * L; e += 32)
          stage[e] = *hat(base + e / L, base + e % L);
        __syncwarp();
        trailing_shifts_warp(stage, L, 0, L - 1, m, exc, B, sh.dist,
                             sh.shift);
      }
      __syncthreads();
      if (tid == 0 && rank == lo % P) intro(0, lo);
      cluster.sync();

      // ---- the chase: nb live bulges, steps lo .. hi - 1 + 2 (nb - 1) ----
      const int nb = min(m, (hi - lo - 1) / 2 + 1);
      const int t_final = hi - 1 + 2 * (nb - 1);
      for (int t = lo; t <= t_final; ++t) {
        Step& st = sh.step[t & 1];
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
            Task tk;
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
          const Task tk = sh.task[idx / span];
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
        arrive_release();

        // rows k, k+1 of this rank's part of Z^T, all its columns
        const int zc = kZs ? ncl : zn;
        for (int idx = tid; idx < nlive * zc; idx += kThreads) {
          const int i = idx / zc, c = idx - (idx / zc) * zc;
          const int k = st.k[i];
          if (k < 0) continue;
          const float cc = st.c[i];
          const float2 sg = st.s[i];
          float2 *p0, *p1;
          if (kZs) {
            p0 = Zs + (size_t)c * ld + k;
            p1 = p0 + 1;
          } else {
            p0 = Zt + (size_t)k * n + z0 + c;
            p1 = p0 + n;
          }
          const float2 zl = *p0, zr = *p1;
          *p0 = c_add(c_scale(cc, zl), c_cmul(sg, zr));
          *p1 = c_sub(c_scale(cc, zr), c_mul(sg, zl));
        }
        wait_acquire();
      }
      rot += (long long)nb * (hi - lo);
    }
    stall = (hi < hi_prev || exc) ? 0 : stall + 1;
    ++it;
  }
  cluster.sync();  // no rank reads another's shared memory after this

  for (int e = tid; e < ncl * n; e += kThreads) {
    const int i = e / ncl, c = e - (e / ncl) * ncl, j = rank + P * c;
    H[(size_t)i * n + j] =
        i > j ? c_make(0.f, 0.f) : Hs[(size_t)c * ld + i];
    if (kZs) Zt[(size_t)i * n + j] = Zs[(size_t)c * ld + i];
  }
  if (rank == 0 && tid == 0) {
    stats[0] = hi;
    stats[1] = it;
    stats[2] = rot;
  }
}

}  // namespace ms_cluster
