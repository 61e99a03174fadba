// One multishift chase over the whole active block [lo, hi] of an upper
// Hessenberg matrix, by the thread block that calls it: m spacing-2
// single-shift bulges, rotations applied directly to H and to Z^T.  Shared by
// schur_qr_ms.cu (one matrix a launch) and schur_qr_baed.cu (one matrix a
// thread block); their source comments say which TPU kernels that replaces.
//
// Bulge i sits at row k = t - 2 i at step t, enters at k = lo with
// (H[lo,lo] - sigma_i, H[lo+1,lo]), and only bulges with lo + 2 i + 1 <= hi
// are alive; a bulge outside [lo, hi) is no rotation at all (pipeline fill and
// drain).  A step is three phases behind block barriers: (1) threads 0..m-1
// form the step's rotations from the carries, (2) every row rotation, (3)
// every column rotation of H.  A step's rotations touch disjoint row pairs
// and disjoint column pairs, and a row rotation covers columns
// >= max(k - 1, lo) only, so that the bump a trailing bulge creates is never
// smeared by the bulge ahead of it: then all rows before all columns equals
// the bulges taken one after another, leading bulge first.  Z is held
// TRANSPOSED: Z <- Z G^H on columns k, k+1 is a rotation of two rows of Z^T,
// contiguous in memory, and joins phase (2); with plain Z the column pairs
// would be read at stride n, one 32-byte sector for every 16 bytes used.
#pragma once

#include "ms_shifts.cuh"

// The bulges' carries and the step's rotations, in shared memory.
struct ChaseCarry {
  float c[kShiftMaxM];
  float2 s[kShiftMaxM], x[kShiftMaxM], y[kShiftMaxM];
  unsigned char act[kShiftMaxM];
};

// H, Zt: n x n complex64 in device memory, row-major; shift: the m shifts;
// *rot is raised by one per rotation applied.  Called by all kThreads threads
// of the block after a barrier that made the shifts visible; ends on a
// barrier.
template <int kThreads>
__device__ __forceinline__ void chase_whole_block(
    float2* H, float2* Zt, int n, int lo, int hi, int m, const float2* shift,
    ChaseCarry& cc, unsigned long long* rot) {
  const int tid = threadIdx.x;
  if (tid < m) {
    cc.x[tid] = c_make(0.f, 0.f);
    cc.y[tid] = c_make(0.f, 0.f);
  }
  __syncthreads();

  // nb live bulges, steps lo .. hi - 1 + 2 (nb - 1)
  const int nb = min(m, (hi - lo - 1) / 2 + 1);
  const int t_final = hi - 1 + 2 * (nb - 1);
  for (int t = lo; t <= t_final; ++t) {
    if (tid < m) {
      const int i = tid, k = t - 2 * i;
      const bool act = i < nb && k >= lo && k < hi;
      cc.act[i] = act;
      if (act) {
        if (k == lo) {
          cc.x[i] = c_sub(H[(size_t)lo * n + lo], shift[i]);
          cc.y[i] = H[(size_t)(lo + 1) * n + lo];
        }
        const Givens g = givens(cc.x[i], cc.y[i]);
        cc.c[i] = g.c;
        cc.s[i] = g.s;
        atomicAdd(rot, 1ull);
      }
    }
    __syncthreads();
    // rows k, k+1 of H (columns >= max(k-1, lo)) and of Z^T (all)
    const int nlive = min(nb, (t - lo) / 2 + 1);  // bulges entered so far
    for (int idx = tid; idx < nlive * 2 * n; idx += kThreads) {
      const int i = idx / (2 * n), jj = idx - i * 2 * n;
      if (!cc.act[i]) continue;
      const int k = t - 2 * i;
      const float c = cc.c[i];
      const float2 sg = cc.s[i];
      if (jj < n) {
        if (jj < max(k - 1, lo)) continue;
        float2* pk = H + (size_t)k * n + jj;
        const float2 hk = pk[0], h1 = pk[n];
        pk[0] = c_add(c_scale(c, hk), c_mul(sg, h1));
        pk[n] = (jj == k - 1 && k > lo)
                    ? c_make(0.f, 0.f)
                    : c_sub(c_scale(c, h1), c_cmul(sg, hk));
      } else {
        float2* pk = Zt + (size_t)k * n + (jj - n);
        const float2 l = pk[0], r = pk[n];
        pk[0] = c_add(c_scale(c, l), c_cmul(sg, r));
        pk[n] = c_sub(c_scale(c, r), c_mul(sg, l));
      }
    }
    __syncthreads();
    // columns k, k+1 of H, rows <= min(k + 2, hi)
    const int nrow = min(t + 3, hi + 1);  // the leading bulge reaches
    for (int idx = tid; idx < nlive * nrow; idx += kThreads) {
      const int i = idx / nrow, r = idx - i * nrow;
      if (!cc.act[i]) continue;
      const int k = t - 2 * i;
      if (r > min(k + 2, hi)) continue;
      const float c = cc.c[i];
      const float2 sg = cc.s[i];
      float2* p = H + (size_t)r * n + k;
      const float2 l = p[0], rr = p[1];
      const float2 nl = c_add(c_scale(c, l), c_cmul(sg, rr));
      p[0] = nl;
      p[1] = c_sub(c_scale(c, rr), c_mul(sg, l));
      if (r == k + 1) {
        cc.x[i] = nl;
        if (k + 2 > hi) cc.y[i] = c_make(0.f, 0.f);
      }
      if (r == k + 2) cc.y[i] = nl;
    }
    __syncthreads();
  }
}
