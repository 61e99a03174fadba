// Shifts of a multishift QR sweep from the trailing m x m block of the active
// block [lo, hi] of an upper Hessenberg matrix.
//
// Replaces torcwa_tpu/ops/eig_qr_pallas_ms.py::_mini_eigvals and the shift
// choice of ::_kernel_ms (the same code stands in eig_qr_hbm.py's aed=False
// branch), and keeps their rules:
//  * the block starts at base = max(hi - (m - 1), lo); rows and columns
//    beyond hi do not exist for it (the TPU kernel masks them to zero
//    padding lanes);
//  * its eigenvalues by single-shift QR without vectors: deflation at
//    eps (|d| + |d'|), Wilkinson shift with the complex branch always open
//    (a negative real discriminant gives the +-i pair), the exceptional
//    shift d + 0.75 |sub| every 13th iteration, a budget of 6 m iterations;
//    whatever stands on the diagonal then is the candidate list;
//  * the candidates ordered by distance to H[hi, hi], ties in index order,
//    the padding lanes (value 0) behind every real candidate, so that a
//    small |H[hi, hi]| never lets a padding zero lead the bulges;
//  * on an exceptional sweep shift i is the diagonal entry at
//    pos = min(base + i, hi) with 0.75 |H[pos + 1, pos]| added to its real
//    part (nothing added at pos = hi).
// The TPU kernel extracts the block with one-hot selection matmuls and runs
// the QR as masked full-block expressions with rolls; none of that is
// carried over.
//
// Design: the block is at most 64 x 64 and the iteration is one serial chain
// of rotations, so ONE WARP works it in shared memory: every lane computes
// the scalars (window, shift, rotation) redundantly from shared memory, the
// lanes share the O(m) row and column updates, and the phases are separated
// by __syncwarp(), not by block barriers.  The functions below are called by
// all 32 lanes of one warp; the caller puts a barrier (block-wide, if other
// warps wait for the shifts) after them.
#pragma once

#include "common.cuh"

constexpr int kShiftMaxM = 64;

// float2 entries of shared scratch trailing_shifts_warp needs for m shifts
__host__ __device__ inline size_t shift_block_elems(int m) {
  return (size_t)m * (m + 1);
}

// Single-shift QR on the L x L upper Hessenberg block B (shared memory,
// leading dimension ld), no vectors; the diagonal holds the eigenvalue
// estimates afterwards.
__device__ inline void mini_eigvals_warp(float2* B, int ld, int L,
                                         int budget) {
  const int lane = threadIdx.x & 31;
  int hi = L - 1;
  for (int it = 0; it < budget; ++it) {
    while (hi > 0 && !sub_alive(B[(hi - 1) * ld + hi - 1], B[hi * ld + hi],
                                B[hi * ld + hi - 1], 1.f))
      --hi;
    if (hi <= 0) break;
    int lo = hi;
    while (lo > 0 && sub_alive(B[(lo - 1) * ld + lo - 1], B[lo * ld + lo],
                               B[lo * ld + lo - 1], 1.f))
      --lo;
    const float2 a = B[(hi - 1) * ld + hi - 1], b = B[(hi - 1) * ld + hi];
    const float2 c = B[hi * ld + hi - 1], d = B[hi * ld + hi];
    float2 sh = wilkinson(a, b, c, d, true);
    if (it % 13 == 12) sh = c_make(d.x + 0.75f * sqrtf(c_abs2(c)), d.y);
    float2 x = c_sub(B[lo * ld + lo], sh), y = B[(lo + 1) * ld + lo];
    for (int k = lo; k < hi; ++k) {
      const Givens g = givens(x, y);
      // rows k, k+1, columns >= k - 1
      for (int j = max(k - 1, 0) + lane; j < L; j += 32) {
        const float2 hk = B[k * ld + j], h1 = B[(k + 1) * ld + j];
        B[k * ld + j] = c_add(c_scale(g.c, hk), c_mul(g.s, h1));
        B[(k + 1) * ld + j] = (j == k - 1 && k > lo)
                                  ? c_make(0.f, 0.f)
                                  : c_sub(c_scale(g.c, h1), c_cmul(g.s, hk));
      }
      __syncwarp();
      // columns k, k+1, rows <= min(k + 2, hi)
      const int imax = min(k + 2, hi);
      for (int i = lane; i <= imax; i += 32) {
        const float2 l = B[i * ld + k], r = B[i * ld + k + 1];
        B[i * ld + k] = c_add(c_scale(g.c, l), c_cmul(g.s, r));
        B[i * ld + k + 1] = c_sub(c_scale(g.c, r), c_mul(g.s, l));
      }
      __syncwarp();
      x = B[(k + 1) * ld + k];
      y = k + 2 <= hi ? B[(k + 2) * ld + k] : c_make(0.f, 0.f);
    }
  }
}

// The m shifts of a sweep on the active block [lo, hi] of H (device memory,
// row-major, order n), written to shifts[0..m).  B: shift_block_elems(m)
// float2 of shared memory, dist: m floats of shared memory.  1 <= m <= 64.
// H is read through ordinary loads (no __restrict__): the caller may have
// written it earlier in the same launch.
__device__ inline void trailing_shifts_warp(const float2* H, int n, int lo,
                                            int hi, int m, bool exc, float2* B,
                                            float* dist, float2* shifts) {
  const int lane = threadIdx.x & 31;
  const int base = max(hi - (m - 1), lo);
  const int L = hi - base + 1;
  if (exc) {
    for (int i = lane; i < m; i += 32) {
      const int pos = min(base + i, hi);
      const float2 d = H[(size_t)pos * n + pos];
      const float sub =
          pos + 1 <= hi ? sqrtf(c_abs2(H[(size_t)(pos + 1) * n + pos])) : 0.f;
      shifts[i] = c_make(d.x + 0.75f * sub, d.y);
    }
    __syncwarp();
    return;
  }
  const int ld = m + 1;
  for (int e = lane; e < L * L; e += 32)
    B[(e / L) * ld + e % L] = H[(size_t)(base + e / L) * n + base + e % L];
  __syncwarp();
  mini_eigvals_warp(B, ld, L, 6 * m);
  const float2 hh = H[(size_t)hi * n + hi];
  for (int q = lane; q < L; q += 32)
    dist[q] = c_abs2(c_sub(B[q * ld + q], hh));
  __syncwarp();
  // stable order by distance: a candidate's place is the number of
  // candidates that come before it; the m - L padding lanes come last
  for (int q = lane; q < m; q += 32) {
    if (q >= L) {
      shifts[q] = c_make(0.f, 0.f);
      continue;
    }
    const float dq = dist[q];
    int rank = 0;
    for (int p = 0; p < L; ++p)
      rank += (dist[p] < dq) || (dist[p] == dq && p < q);
    shifts[rank] = B[q * ld + q];
  }
  __syncwarp();
}
