// Aggressive early deflation (AED) on the trailing window of the active block
// [lo, hi] of an upper Hessenberg matrix, worked in shared memory by the
// first kNT threads of a thread block.  Shared by schur_ms.cu (ms_aed, one
// launch of a block of kNT threads per sweep) and schur_qr_baed.cu with
// baed_cluster.cuh (inside the sweep loop of a larger block or of a cluster's
// rank 0, one matrix each); their source comments say which TPU kernels that
// replaces (eig_qr_hbm.py::_mini_schur and the AED block of ::_kernel_hbm,
// attic/eig_qr_pallas_baed.py::_mini_schur_b and the AED block of
// ::_kernel_baed).  ops/schur_ms.py::aed_plain is the plain version.  The
// rules:
//  * the window starts at s = max(hi - kw + 1, lo + 1) and is cut to the
//    active block, kwe = hi - s + 1 rows (rows past hi are never rotated, so
//    the TPU kernels' uncut kw-row window gives the same factor);
//  * a single-shift Schur form of the window with accumulated vectors:
//    Wilkinson shift with the complex branch open, an exceptional shift
//    every 13th iteration, deflation at eps (|d| + |d'|), budget 3 kw + 40;
//    its rotations formed in double and rounded (givens_rounded), as the
//    plain versions form them;
//  * the spike beta Qm[:, 0]; the bottom run of converged lanes (index >=
//    the window's own final bottom) with |spike_i| <= defl_mult eps
//    max(|T_ii|, max|W|) deflates, ku lanes stay.  max|W| is taken over the
//    cut window, or with `uncut_scale` over the kw rows and columns from s
//    that exist (what _kernel_baed's uncut window sees);
//  * shifts: the m undeflated window eigenvalues closest to the new corner
//    T[ku-1, ku-1], ties and the deflated lanes in index order; on an
//    exceptional sweep the perturbed trailing undeflated diagonals;
//  * the bordered matrix [[0, 0], [spike, T]] is reduced back to Hessenberg
//    form on rows and columns 1..ku by Householder reflectors, accumulated
//    into L = reflectors . diag(1, Qm);
//  * where it deflates (s + ku - 1 < hi), the transformed diagonal block and
//    spike column are written back to H with the known zeros exact: nothing
//    below the subdiagonal, no subdiagonal in the deflated part.  The
//    off-window slabs of H and Z are the caller's: P = L[1:, 1:], kwe x kwe.
// How the threads share it:
//  * the window's single-shift QR: warp 0 holds the chase.  The row and
//    column updates of W are two slots a lane with __syncwarp() between
//    them, so no other warp waits for a rotation;
//  * each rotation (c, s) is formed in registers (givens_rounded, in double
//    and rounded).  Without kAhead every lane of warp 0 forms it after the
//    previous rotation's updates, from the two entries that the lanes which
//    computed them shuffle over.  With kAhead (ms_aed, a block of its own)
//    warp 1 forms the rotations one ahead of the chase: from the six entries
//    of rows k-1..k+1 and columns k-1, k that rotation k-1 finds, it computes
//    the two that rotation k needs by rotation k-1's own expressions, forms
//    rotation k and hands it over, while warp 0 still applies rotation k-1
//    to the rest of W.  Two pairs of named barriers of the two warps (a pair,
//    so that a warp's next arrival always meets the other's wait) carry the
//    rotations one way and "rotation k-1 applied" the other, so the forming,
//    ~700 cycles of double-precision latency, is no longer followed by the
//    updates' ~500 cycles of shared-memory round trips but overlaps them;
//  * the deflation scan at the start of each sweep is a warp vote (two
//    ballots over the subdiagonals), the shift every lane's own (with kAhead
//    warps 0 and 1 both scan, and take the same path);
//  * Qm's rows, which nothing in the QR reads back, are deferred: the
//    rotations of a sweep are recorded, and the remaining warps apply them to
//    Qm, one column a thread as a chain, while warp 0 chases the next sweep.
//    All threads meet on the named barrier kBar once a sweep;
//  * the spike test, the undeflated count ku and the shifts (a rank by
//    distance, ties by index: the order of a repeated minimum) by warp 0
//    with votes;
//  * W sits in the bordered matrix Ap and Qm in L at row and column 1 (the
//    leading dimension is kw + 1 throughout, odd, so a warp reading down a
//    column hits distinct banks), so the border is written in place and the
//    AED arrays take 2 (kw + 1)^2 + 2 kw + 1 float2 (68,632 bytes at kw =
//    64);
//  * H is read and written through an accessor, a pointer to entry (i, j)
//    in device memory or in a thread-block cluster's shared memory.
// Each entry of W and Qm receives the plain version's operations in its
// order, with or without kAhead, so the result does not depend on the
// schedule wherever nvcc contracts the same expressions alike (with
// -fmad=false it does).
//
// What bounds it on an H100: the window QR's dependent chain of rotations.
// Without kAhead, ~1190 cycles a rotation at kw = 64, of which forming (c, s)
// in double is ~700 and the two updates' shared-memory round trips ~500;
// with kAhead the chain is the forming and the few products before it.
// Keeping the bulge's entries in registers on warp 0 itself ran slower
// inside schur_qr_baed's 256- and 512-thread CTAs: the registers it takes
// make those kernels spill (PERF.md), so they keep the one-warp schedule.
#pragma once

#include "common.cuh"

constexpr int kAedMaxKw = 64;

struct AedResult {
  int s, kwe;   // window start and rows
  int ku;       // undeflated lanes: the new window bottom is s + ku - 1
  int mhi, it;  // the window QR's final bottom and iterations
};

template <int kNT, int kBar>
__device__ __forceinline__ void aed_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kBar), "n"(kNT) : "memory");
}

// Max over the kNT threads; every one of them gets it.  red: kNT / 32 floats.
template <int kNT, int kBar>
__device__ __forceinline__ float aed_group_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  aed_sync<kNT, kBar>();
  float r = red[0];
  for (int w = 1; w < kNT / 32; ++w) r = fmaxf(r, red[w]);
  aed_sync<kNT, kBar>();
  return r;
}

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

// The named barrier `id` of warps 0 and 1: a warp that arrives goes on, a
// warp that syncs waits for the other's arrival
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

#ifdef TORCWA_AED_CLOCKS
// Cycles of the AED passes by part, read by thread 0 of the AED threads
// with clock64() and summed over a launch, then the cycles of the kernel's
// sweep loop by phase, read by its thread 0 (of rank 0 in a cluster):
// the whole loop, the AED phase (barriers included), the transform, the
// chase, and the sweeps (qr_compare.py --stage schur_qr_baed and --stage
// schur_ms build a library with this defined and read it).  With kAhead,
// "form" is warp 0's wait for the rotation that warp 1 formed.
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

// Rotation k (c, s) = (cr, sg) of the window QR on W, by the 32 lanes of
// one warp: rows k, k+1 over columns >= k - 1 (W[k+1, k-1] set to 0 exactly
// past the sweep's first rotation l), then columns k, k+1 over rows <=
// min(k + 2, h), two slots a lane, each phase loading all its pairs before
// it stores any: the arithmetic of aed_window_warp's one-warp loop.
__device__ __forceinline__ void rotate(float2* W, int ld1, int kwe, int l,
                                       int h, int k, float cr, float2 sg
                                       AED_CLK(, unsigned long long* clk,
                                               long long& clk_b)) {
  const int lane = threadIdx.x & 31;
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
            clk[kRows] += t - clk_b; clk_b = t; })
  const int imax = min(k + 2, h);
  float2 lv[2], rv[2];
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
      W[i * ld1 + k] = c_add(c_scale(cr, lv[q2]), c_cmul(sg, rv[q2]));
      W[i * ld1 + k + 1] = c_sub(c_scale(cr, rv[q2]), c_mul(sg, lv[q2]));
    }
  }
}

// givens_rounded(x, y) bit for bit, with its square roots and quotients
// taken side by side on the warp's lanes instead of one after another:
// lane 0 takes sqrt(|x|^2 + |y|^2), the others sqrt(|x|^2); then lane 0
// the quotient of c, lanes 1 and 2 those of s.  Each is the same IEEE
// double operation on the same operands, so the rounded rotation is the
// same; every lane of the warp gets it.  Called by a whole warp with the
// same x and y.
__device__ __forceinline__ Givens givens_rounded_lanes(float2 x, float2 y) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const double xr = x.x, xi = x.y, yr = y.x, yi = y.y;
  const double ax2 = xr * xr + xi * xi, ay2 = yr * yr + yi * yi;
  const double root = sqrt(lane == 0 ? ax2 + ay2 : ax2);
  const double dn = __shfl_sync(all, root, 0), ax = __shfl_sync(all, root, 1);
  Givens g;
  g.c = 1.f;
  g.s = c_make(0.f, 0.f);
  if (ax2 == 0.0 && ay2 > 0.0) {
    g.c = 0.f;
    g.s = c_make(1.f, 0.f);
  } else if (ax > 0.0 && dn > 0.0) {
    const double den = ax * dn;
    const double num = lane == 0   ? ax
                       : lane == 1 ? xr * yr + xi * yi
                                   : xi * yr - xr * yi;
    const float q = (float)(num / (lane == 0 ? dn : den));
    g.c = __shfl_sync(all, q, 0);
    g.s = c_make(__shfl_sync(all, q, 1), __shfl_sync(all, q, 2));
  }
  return g;
}

// With kAhead, warp 1's part of one sweep of the window QR, rotations l ..
// h - 1: each is formed from (x, y), written to cur and handed to warp 0
// on barrier bar + 1 + (t & 1) (t = k - l).  Before the hand-over it loads
// the six entries of rows k..k+2, columns k, k+1 as rotation k will find
// them (final once warp 0 has applied rotation k - 1, barrier bar + 3 +
// ((t - 1) & 1)); from them it computes W[k+1, k] and W[k+2, k] after
// rotation k with rotate()'s expressions: the next (x, y).
__device__ __forceinline__ void form_ahead(const float2* W, int ld1, int l,
                                           int h, float2 x, float2 y,
                                           Sweep& cur, int bar) {
  const int lane = threadIdx.x & 31;
  for (int k = l; k < h; ++k) {
    const int t = k - l;
    const Givens g = givens_rounded_lanes(x, y);
    if (lane == 0) {
      cur.c[t] = g.c;
      cur.s[t] = g.s;
    }
    if (k + 1 == h) {
      pair_arrive(bar + 1 + (t & 1));
      break;
    }
    if (t > 0) pair_sync(bar + 3 + ((t - 1) & 1));
    const float2 a = W[k * ld1 + k], b = W[k * ld1 + k + 1];
    const float2 c = W[(k + 1) * ld1 + k], d = W[(k + 1) * ld1 + k + 1];
    const float2 e = W[(k + 2) * ld1 + k], f = W[(k + 2) * ld1 + k + 1];
    pair_arrive(bar + 1 + (t & 1));
    // the row update of W[k+1, k] and W[k+1, k+1], then the column update
    // of rows k+1 and k+2 (row k+2 has no row update)
    const float2 c1 = c_sub(c_scale(g.c, c), c_cmul(g.s, a));
    const float2 d1 = c_sub(c_scale(g.c, d), c_cmul(g.s, b));
    x = c_add(c_scale(g.c, c1), c_cmul(g.s, d1));
    y = c_add(c_scale(g.c, e), c_cmul(g.s, f));
  }
}

// With kAhead, warp 0's part: each rotation as warp 1 hands it over,
// applied by rotate(); "applied" goes back where warp 1 waits for it.
__device__ __forceinline__ void chase_behind(float2* W, int ld1, int kwe,
                                             int l, int h, const Sweep& cur,
                                             int bar
                                             AED_CLK(, unsigned long long*
                                                         clk)) {
  for (int k = l; k < h; ++k) {
    const int t = k - l;
    AED_CLK(long long clk_b = clock64();)
    pair_sync(bar + 1 + (t & 1));
    const float cr = cur.c[t];
    const float2 sg = cur.s[t];
    AED_CLK({ const long long now = clock64();
              clk[kForm] += now - clk_b; clk_b = now; })
    rotate(W, ld1, kwe, l, h, k, cr, sg AED_CLK(, clk, clk_b));
    __syncwarp();
    if (k + 2 < h) pair_arrive(bar + 3 + (t & 1));
    AED_CLK(clk[kCols] += clock64() - clk_b; ++clk[kRot];)
  }
}

}  // namespace aed_warp

// Called by threads 0..kNT-1 of the block (kNT >= 64 + 32), all with the
// same arguments and hi > 0; hat(i, j) is a pointer to H[i, j] (n x n),
// read and written by ordinary loads and stores.  sm: aed_warp_smem_elems
// (kw) float2 of shared memory; shifts: m float2.  Every calling thread
// gets the result; L, the shifts and H are complete for the calling
// threads on return.  kAhead: warp 1 forms the rotations ahead of the chase
// (named barriers kBar + 1 .. kBar + 4 of warps 0 and 1), and the window
// QR's rotations are added to *rotations.
template <int kNT, int kBar, bool kAhead = false, typename HA>
__device__ AedResult aed_window_warp(const HA& hat, int n, int lo, int hi,
                                     bool exc, int m, int kw,
                                     float defl_mult, bool uncut_scale,
                                     float2* sm, float2* shifts,
                                     int* rotations = nullptr) {
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

  // ---- single-shift Schur form of the window: warp 0 chases (with kAhead
  // warp 1 forms its rotations), the remaining warps apply the previous
  // sweep's rotations to Qm ----
  AED_CLK(const long long clk_q0 = clock64();)
  const int max_it = 3 * kw + 40;
  int mhi = kwe - 1, it = 0;  // warp 0's (and with kAhead warp 1's)
  int nrot_all = 0;           // warp 0's, with kAhead
  constexpr int kChain = kAhead ? 2 : 1;  // warps of the QR; Qm's follow
  for (int q = 0;; ++q) {
    aed_warp::Sweep& cur = rec[q & 1];
    if (warp == 0 || (kAhead && warp == 1)) {
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
        if ((kAhead ? tid : lane) == 0) {
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
        if constexpr (kAhead) {
          if (warp == 1)
            aed_warp::form_ahead(W, ld1, l, h, x, y, cur, kBar);
          else
            aed_warp::chase_behind(W, ld1, kwe, l, h, cur,
                                   kBar AED_CLK(, clk));
          nrot_all += h - l;
        }
        // without kAhead, warp 0 forms each rotation itself
        for (int k = l; !kAhead && k < h; ++k) {
          AED_CLK(long long clk_b = clock64();)
          const Givens g = givens_rounded(x, y);
          const float cr = g.c;
          const float2 sg = g.s;
          AED_CLK(asm volatile("" ::"f"(cr), "f"(sg.x), "f"(sg.y));
                  { const long long t = clock64();
                    clk[aed_warp::kForm] += t - clk_b; clk_b = t; })
          // rows k, k+1 over columns >= k - 1, then columns k, k+1 over
          // rows <= min(k + 2, h), two slots a lane, each phase loading
          // all its pairs before it stores any (aed_warp::rotate's
          // arithmetic, written out here so that schur_qr_baed.cu's code
          // does not move)
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
        if ((kAhead ? tid : lane) == 0) {
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
        for (int j = tid - 32 * kChain; j < kwe; j += kNT - 32 * kChain) {
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
  if constexpr (kAhead)
    if (tid == 0) *rotations += nrot_all;
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
