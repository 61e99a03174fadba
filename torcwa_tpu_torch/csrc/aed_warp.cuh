// Aggressive early deflation (AED) on the trailing window of the active block
// [lo, hi] of an upper Hessenberg matrix, with the window's Schur form chased
// by ONE warp.  The rules, the arithmetic of every entry and the result are
// those of aed_window (ms_aed.cuh, which says which TPU kernels they
// replace); what differs is who does the work and how often the threads
// meet:
//  * the window's single-shift QR: warp 0 holds the chase.  Every lane forms
//    each rotation (c, s) in registers (givens_rounded, in double and
//    rounded, as the plain versions form it), the row and column updates of
//    W are two slots a lane with __syncwarp() between them, and the next
//    bulge comes from the lanes that computed it by shuffles, so nothing is
//    broadcast through shared memory and no other warp waits for a
//    rotation;
//  * the deflation scan at the start of each sweep is a warp vote (two
//    ballots over the subdiagonals), the shift every lane's own;
//  * Qm's rows, which nothing in the QR reads back, are deferred: warp 0
//    records a sweep's rotations, and the other warps apply them to Qm, one
//    column a thread as a chain, while warp 0 chases the next sweep.  The
//    threads meet on the named barrier kBar once a sweep, not twice a
//    rotation (ms_aed.cuh);
//  * the spike test, the undeflated count ku and the shifts (a rank by
//    distance, ties by index: the order of aed_window's repeated minimum)
//    by warp 0 with votes, not by thread 0's loops;
//  * W sits in the bordered matrix Ap and Qm in L at row and column 1 (the
//    leading dimension is kw + 1 throughout, odd, so a warp reading down a
//    column hits distinct banks), so the border is written in place and the
//    AED arrays take 2 (kw + 1)^2 + 2 kw + 1 float2 (68,632 bytes at kw =
//    64, half of ms_aed.cuh's);
//  * H is read and written through an accessor, a pointer to entry (i, j)
//    in device memory or in a thread-block cluster's shared memory.
// Each entry of W and Qm receives aed_window's operations in its order, so
// the result is aed_window's bit for bit wherever nvcc contracts the same
// expressions alike (with -fmad=false it does).
//
// What bounds it on an H100: the chase warp's dependent chain, ~1270 cycles
// a rotation at kw = 64, of which forming (c, s) in double is ~700 and the
// two updates' shared-memory round trips ~570 (ms_aed.cuh's took ~1650 with
// its two barriers and thread 0's scan).  Keeping the bulge's entries in
// registers, with or without a division-free forming, ran slower: the
// registers it takes make the kernels spill (PERF.md).
#pragma once

#include "ms_aed.cuh"

// float2 entries of shared memory aed_window_warp needs for kw rows
__host__ __device__ inline size_t aed_warp_smem_elems(int kw) {
  return 2 * (size_t)(kw + 1) * (kw + 1) + 2 * (size_t)kw + 1;
}
// L, (kw + 1) x (kw + 1) with leading dimension kw + 1, in that memory:
// P = L[1:, 1:] is L + aed_warp_L_offset(kw) + kw + 2 on return
__host__ __device__ inline size_t aed_warp_L_offset(int kw) {
  return (size_t)(kw + 1) * (kw + 1);
}

namespace aed_warp {

// The rotations of one sweep of the window QR, as warp 0 recorded them.
struct Sweep {
  float c[kAedMaxKw];
  float2 s[kAedMaxKw];
  int k0, nrot;  // rotations k0 .. k0 + nrot - 1; nrot < 0: the QR ended
};

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return c_make(__shfl_sync(0xffffffffu, v.x, src),
                __shfl_sync(0xffffffffu, v.y, src));
}

// The 64 bits of a predicate over i = lane and i = lane + 32.
__device__ __forceinline__ unsigned long long vote64(bool p0, bool p1) {
  return (unsigned long long)__ballot_sync(0xffffffffu, p0) |
         ((unsigned long long)__ballot_sync(0xffffffffu, p1) << 32);
}

// 1 + the highest set bit, 0 for none.
__device__ __forceinline__ int top(unsigned long long b) {
  return b ? 64 - __clzll((long long)b) : 0;
}

#ifdef TORCWA_AED_CLOCKS
// Cycles of the AED passes by part, read by thread 0 of the AED threads
// with clock64() and summed over a launch, then the cycles of the kernel's
// sweep loop by phase, read by its thread 0 (of rank 0 in a cluster):
// the whole loop, the AED phase (barriers included), the transform, the
// chase, and the sweeps (qr_compare.py --stage schur_qr_baed builds a
// library with this defined and reads it).
enum Clk { kTotal, kQr, kScan, kForm, kRows, kBar, kCols, kAfter, kRot,
           kSweeps, kPasses, kLoop, kAedPhase, kTransform, kChase,
           kLoopSweeps, kSlots };
__device__ unsigned long long torcwa_aed_clk[kSlots];
// a kernel's sweep loop: its cycles since t0, the phases' (AED, transform,
// chase) and its sweeps
__device__ inline void add_loop_clocks(long long t0,
                                       const unsigned long long (&ph)[3],
                                       int sweeps) {
  atomicAdd(&torcwa_aed_clk[kLoop], clock64() - t0);
  atomicAdd(&torcwa_aed_clk[kAedPhase], ph[0]);
  atomicAdd(&torcwa_aed_clk[kTransform], ph[1]);
  atomicAdd(&torcwa_aed_clk[kChase], ph[2]);
  atomicAdd(&torcwa_aed_clk[kLoopSweeps], (unsigned long long)sweeps);
}
#define AED_CLK(...) __VA_ARGS__
#else
#define AED_CLK(...)
#endif

}  // namespace aed_warp

// Called by threads 0..kNT-1 of the block (kNT >= 64 + 32), all with the
// same arguments and hi > 0; hat(i, j) is a pointer to H[i, j] (n x n),
// read and written by ordinary loads and stores.  sm: aed_warp_smem_elems
// (kw) float2 of shared memory; shifts: m float2.  Every calling thread
// gets the result; L, the shifts and H are complete for the calling
// threads on return.
template <int kNT, int kBar, typename HA>
__device__ AedResult aed_window_warp(const HA& hat, int n, int lo, int hi,
                                     bool exc, int m, int kw,
                                     float defl_mult, bool uncut_scale,
                                     float2* sm, float2* shifts) {
  using aed_warp::shfl2;
  using aed_warp::top;
  using aed_warp::vote64;
  const int ld1 = kw + 1;
  float2* Ap = sm;                // [[0, 0], [spike, T]]
  float2* W = Ap + ld1 + 1;       // the window, then T, at (1, 1) of Ap
  float2* L = Ap + ld1 * ld1;     // reflectors . diag(1, Qm)
  float2* Qm = L + ld1 + 1;       // T = Qm W Qm^H, at (1, 1) of L
  float2* spike = L + ld1 * ld1;  // kw
  float2* v = spike + kw;         // kw + 1
  __shared__ float red[kNT / 32];
  __shared__ aed_warp::Sweep rec[2];
  __shared__ int s_mhi, s_it, s_ku;
  __shared__ float dist[kAedMaxKw];
  __shared__ unsigned char defl[kAedMaxKw];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = max(hi - kw + 1, lo + 1);
  const int kwe = hi - s + 1;
  const int K1 = kwe + 1;
  AED_CLK(const long long clk_t0 = clock64();
          unsigned long long clk[aed_warp::kSlots] = {};)

  float wmax = 0.f;
  for (int e = tid; e < kwe * kwe; e += kNT) {
    const int i = e / kwe, j = e % kwe;
    const float2 h = *hat(s + i, s + j);
    W[i * ld1 + j] = h;
    Qm[i * ld1 + j] = c_make(i == j ? 1.f : 0.f, 0.f);
    wmax = fmaxf(wmax, c_abs2(h));
  }
  if (uncut_scale && kwe < kw) {
    for (int e = tid; e < kw * kw; e += kNT) {
      const int i = e / kw, j = e % kw;
      if ((i >= kwe || j >= kwe) && s + i < n && s + j < n)
        wmax = fmaxf(wmax, c_abs2(*hat(s + i, s + j)));
    }
  }
  const float smax = fmaxf(sqrtf(aed_group_max<kNT, kBar>(wmax, red)),
                           TORCWA_SMLNUM_F32);
  const float2 beta = *hat(s, s - 1);

  // ---- single-shift Schur form of the window: warp 0 chases, the other
  // warps apply the previous sweep's rotations to Qm ----
  AED_CLK(const long long clk_q0 = clock64();)
  const int max_it = 3 * kw + 40;
  int mhi = kwe - 1, it = 0;  // warp 0's
  for (int q = 0;; ++q) {
    aed_warp::Sweep& cur = rec[q & 1];
    if (warp == 0) {
      AED_CLK(long long clk_a = clock64();)
      // the window bottom h and the top l of its bottom run, by a vote
      const int c1 = lane + 32;
      const bool al0 = lane < mhi &&
                       sub_alive(W[lane * ld1 + lane],
                                 W[(lane + 1) * ld1 + lane + 1],
                                 W[(lane + 1) * ld1 + lane], 1.f);
      const bool al1 = c1 < mhi &&
                       sub_alive(W[c1 * ld1 + c1], W[(c1 + 1) * ld1 + c1 + 1],
                                 W[(c1 + 1) * ld1 + c1], 1.f);
      const unsigned long long am = vote64(al0, al1);
      const int h = top(am);  // h <= kwe - 1 <= 63
      const int l = top(~am & ((1ull << h) - 1));
      mhi = h;
      if (h <= 0 || it >= max_it) {
        if (lane == 0) {
          cur.nrot = -1;
          s_mhi = h;
          s_it = it;
        }
        AED_CLK(clk[aed_warp::kScan] += clock64() - clk_a;)
      } else {
        const float2 d = W[h * ld1 + h];
        float2 sh = wilkinson(W[(h - 1) * ld1 + h - 1], W[(h - 1) * ld1 + h],
                              W[h * ld1 + h - 1], d, true);
        if (it % 13 == 12)
          sh = c_make(d.x + 0.75f * sqrtf(c_abs2(W[h * ld1 + h - 1])), d.y);
        float2 x = c_sub(W[l * ld1 + l], sh), y = W[(l + 1) * ld1 + l];
        AED_CLK(clk[aed_warp::kScan] += clock64() - clk_a;)
        for (int k = l; k < h; ++k) {
          AED_CLK(long long clk_b = clock64();)
          const Givens g = givens_rounded(x, y);
          const float cr = g.c;
          const float2 sg = g.s;
          AED_CLK(asm volatile("" ::"f"(cr), "f"(sg.x), "f"(sg.y));
                  { const long long t = clock64();
                    clk[aed_warp::kForm] += t - clk_b; clk_b = t; })
          // rows k, k+1 over columns >= k - 1, then columns k, k+1 over
          // rows <= min(k + 2, h), two slots a lane, each phase loading
          // all its pairs before it stores any
          if (lane == 0) {
            cur.c[k - l] = cr;
            cur.s[k - l] = sg;
          }
          const int jb = max(k - 1, 0) + lane;
          float2 u[2], w[2];
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2)
            if (jb + 32 * q2 < kwe) {
              u[q2] = W[k * ld1 + jb + 32 * q2];
              w[q2] = W[(k + 1) * ld1 + jb + 32 * q2];
            }
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2) {
            const int j = jb + 32 * q2;
            if (j < kwe) {
              W[k * ld1 + j] = c_add(c_scale(cr, u[q2]), c_mul(sg, w[q2]));
              W[(k + 1) * ld1 + j] =
                  (j == k - 1 && k > l)
                      ? c_make(0.f, 0.f)
                      : c_sub(c_scale(cr, w[q2]), c_cmul(sg, u[q2]));
            }
          }
          __syncwarp();
          AED_CLK({ const long long t = clock64();
                    clk[aed_warp::kRows] += t - clk_b; clk_b = t; })
          const int imax = min(k + 2, h);
          float2 lv[2], rv[2];
          float2 nl[2] = {c_make(0.f, 0.f), c_make(0.f, 0.f)};
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2)
            if (lane + 32 * q2 <= imax) {
              lv[q2] = W[(lane + 32 * q2) * ld1 + k];
              rv[q2] = W[(lane + 32 * q2) * ld1 + k + 1];
            }
#pragma unroll
          for (int q2 = 0; q2 < 2; ++q2) {
            const int i = lane + 32 * q2;
            if (i <= imax) {
              nl[q2] = c_add(c_scale(cr, lv[q2]), c_cmul(sg, rv[q2]));
              W[i * ld1 + k] = nl[q2];
              W[i * ld1 + k + 1] = c_sub(c_scale(cr, rv[q2]), c_mul(sg, lv[q2]));
            }
          }
          // the next bulge: W[k+1, k] and W[k+2, k] as just computed, from
          // the lanes that computed them
          x = aed_warp::shfl2((k + 1) < 32 ? nl[0] : nl[1], (k + 1) & 31);
          const float2 yv =
              aed_warp::shfl2((k + 2) < 32 ? nl[0] : nl[1], (k + 2) & 31);
          y = k + 2 <= h ? yv : c_make(0.f, 0.f);
          __syncwarp();
          AED_CLK(clk[aed_warp::kCols] += clock64() - clk_b;
                  ++clk[aed_warp::kRot];)
        }
        if (lane == 0) {
          cur.k0 = l;
          cur.nrot = h - l;
        }
        ++it;
      }
      AED_CLK(++clk[aed_warp::kSweeps]; clk_a = clock64();)
      aed_sync<kNT, kBar>();
      AED_CLK(clk[aed_warp::kBar] += clock64() - clk_a;)
    } else {
      if (q > 0) {
        // rows k, k+1 of Qm for the previous sweep's rotations, in
        // ascending k: one column a thread, a chain down the column
        const aed_warp::Sweep& pr = rec[(q - 1) & 1];
        const int k0 = pr.k0, nr = pr.nrot;
        for (int j = tid - 32; j < kwe; j += kNT - 32) {
          float2 a = Qm[k0 * ld1 + j];
          for (int t = 0; t < nr; ++t) {
            const float c = pr.c[t];
            const float2 sg = pr.s[t];
            const float2 b = Qm[(k0 + t + 1) * ld1 + j];
            Qm[(k0 + t) * ld1 + j] = c_add(c_scale(c, a), c_mul(sg, b));
            a = c_sub(c_scale(c, b), c_cmul(sg, a));
          }
          Qm[(k0 + nr) * ld1 + j] = a;
        }
      }
      aed_sync<kNT, kBar>();
    }
    if (cur.nrot < 0) break;  // the last sweep's rotations were applied
  }
  mhi = s_mhi;
  it = s_it;
  AED_CLK(clk[aed_warp::kQr] = clock64() - clk_q0;
          const long long clk_c0 = clock64();)

  // ---- spike, deflatable lanes, undeflated count ku, shifts (warp 0) ----
  if (warp == 0) {
    bool keep[2];
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int i = lane + 32 * q2;
      keep[q2] = false;
      if (i < kwe) {
        const float2 sp = c_mul(beta, Qm[i * ld1]);
        spike[i] = sp;
        const float td = sqrtf(c_abs2(W[i * ld1 + i]));
        const bool d = (sqrtf(c_abs2(sp)) <= defl_mult * TORCWA_EPS_F32 *
                                                 fmaxf(td, smax)) &&
                       (i >= mhi);
        defl[i] = d;
        keep[q2] = !d;
      }
    }
    const int ku = top(vote64(keep[0], keep[1]));
    const int kum1 = max(ku - 1, 0);
    __syncwarp();
    if (exc) {
      for (int i = lane; i < m; i += 32) {
        const int pos = min(max(ku - m + i, 0), kum1);
        const float2 d = W[pos * ld1 + pos];
        shifts[i] = c_make(d.x + 0.75f * sqrtf(c_abs2(spike[pos])), d.y);
      }
    } else {
      // the m lanes closest to the new corner, undeflated lanes first,
      // ties and the lanes >= ku in index order; past kwe the last again
      const float2 cn = W[kum1 * ld1 + kum1];
      for (int q = lane; q < ku; q += 32)
        dist[q] = c_abs2(c_sub(W[q * ld1 + q], cn));
      __syncwarp();
      for (int q = lane; q < kwe; q += 32) {
        int pos = q;
        if (q < ku) {
          const float dq = dist[q];
          pos = 0;
          for (int p = 0; p < ku; ++p)
            pos += (dist[p] < dq) || (dist[p] == dq && p < q);
        }
        if (pos < m) shifts[pos] = W[q * ld1 + q];
      }
      __syncwarp();
      for (int i = kwe + lane; i < m; i += 32) shifts[i] = shifts[kwe - 1];
    }
    if (lane == 0) s_ku = ku;
  }
  aed_sync<kNT, kBar>();
  const int ku = s_ku;

  // ---- the border of Ap and L: W and Qm already fill (1.., 1..) ----
  for (int e = tid; e < K1; e += kNT) {
    Ap[e] = c_make(0.f, 0.f);
    L[e] = c_make(e == 0 ? 1.f : 0.f, 0.f);
    if (e > 0) {
      Ap[e * ld1] = defl[e - 1] ? c_make(0.f, 0.f) : spike[e - 1];
      L[e * ld1] = c_make(0.f, 0.f);
    }
  }
  aed_sync<kNT, kBar>();

  // ---- Householder reduction of rows/columns 1..ku back to Hessenberg ----
  for (int j = 0; j + 2 <= ku; ++j) {
    float sigma = 0.f;
    for (int r = j + 2; r <= ku; ++r) sigma += c_abs2(Ap[r * ld1 + j]);
    const float2 x1 = Ap[(j + 1) * ld1 + j];
    const float xn1 = sqrtf(c_abs2(x1));
    const float2 ph = xn1 > 0.f ? c_scale(1.f / xn1, x1) : c_make(1.f, 0.f);
    const float normx = sqrtf(sigma + xn1 * xn1);
    const float vn2 = 2.f * (sigma + xn1 * xn1 + normx * xn1);
    const float tau = sigma > 0.f ? 2.f / fmaxf(vn2, 1e-30f) : 0.f;
    for (int r = j + 1 + tid; r <= ku; r += kNT)
      v[r] = r == j + 1 ? c_add(x1, c_scale(normx, ph)) : Ap[r * ld1 + j];
    aed_sync<kNT, kBar>();
    if (tau != 0.f) {
      // X <- X - tau v (v^H X) on Ap and L
      for (int idx = tid; idx < 2 * K1; idx += kNT) {
        float2* X = idx < K1 ? Ap : L;
        const int c = idx < K1 ? idx : idx - K1;
        float2 w = c_make(0.f, 0.f);
        for (int r = j + 1; r <= ku; ++r)
          w = c_add(w, c_cmul(v[r], X[r * ld1 + c]));
        w = c_scale(tau, w);
        for (int r = j + 1; r <= ku; ++r)
          X[r * ld1 + c] = c_sub(X[r * ld1 + c], c_mul(v[r], w));
      }
      aed_sync<kNT, kBar>();
      // Ap <- Ap - tau (Ap v) v^H
      for (int r = tid; r < K1; r += kNT) {
        float2 u = c_make(0.f, 0.f);
        for (int c = j + 1; c <= ku; ++c)
          u = c_add(u, c_mul(Ap[r * ld1 + c], v[c]));
        u = c_scale(tau, u);
        for (int c = j + 1; c <= ku; ++c)
          Ap[r * ld1 + c] = c_sub(Ap[r * ld1 + c], c_mulc(u, v[c]));
      }
    }
    aed_sync<kNT, kBar>();
  }

  // ---- the window's own block of H ----
  if (s + ku - 1 < hi) {
    // diagonal block and spike column, the known zeros exact: nothing
    // below the subdiagonal, no subdiagonal in the deflated part
    for (int e = tid; e < kwe * K1; e += kNT) {
      const int r = e / K1 + 1, c = e % K1;
      float2 a = Ap[r * ld1 + c];
      if (c + 2 <= r || (c + 1 == r && r >= ku + 1)) a = c_make(0.f, 0.f);
      *hat(s - 1 + r, s - 1 + c) = a;
    }
  }
  aed_sync<kNT, kBar>();
  AED_CLK(if (tid == 0) {
    const long long t = clock64();
    clk[aed_warp::kAfter] = t - clk_c0;
    clk[aed_warp::kTotal] = t - clk_t0;
    clk[aed_warp::kPasses] = 1;
    for (int i = 0; i < aed_warp::kSlots; ++i)
      atomicAdd(&aed_warp::torcwa_aed_clk[i], clk[i]);
  })
  AedResult res;
  res.s = s;
  res.kwe = kwe;
  res.ku = ku;
  res.mhi = mhi;
  res.it = it;
  return res;
}
