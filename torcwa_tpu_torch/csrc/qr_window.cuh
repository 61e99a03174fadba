// The windowed single-shift chase of the batched Schur QR kernels
// (schur_qr.cu: interleaved complex64, two entry points; schur_qr_packed.cu:
// planar re | im rows), with the sweep loop they share.  The matrix is read
// and written through a storage policy (Interleaved or Planar below); the
// rules come from single_shift.cuh.
//
// A lane's ~tens of thousands of rotations are one dependent sequence (each
// (c, s) needs the entries the previous rotation wrote), with O(n) useful
// work each.  A rotation k acts on rows k, k+1 (columns >= k - 1) and
// columns k, k+1 (rows <= k + 2, and all of Z); only the few entries around
// the bulge decide the next rotation.  So the design keeps that part small
// and in one warp, and defers the rest:
//  * one thread block of kThreads per matrix (grid = batch); H (in T) and Z
//    in device memory, L2-resident at the path's size, Z held transposed
//    until the end;
//  * windowed chase: a run's bulge is chased through windows of kW rows,
//    rows [a, a + kW) and columns [a - 1, a + kW) of H staged in shared
//    memory (column a - 1 holds the bulge's x, y).  ONE warp applies the
//    window's rotations there, rows then columns as the per-rotation
//    schedule does, each lane forming (c, s) from x, y in registers,
//    __syncwarp() between the phases and no block barrier; it records each
//    (c, s) and stops where the next rotation's column update would leave
//    the window (k + 2 past its last row).  The next window starts where
//    the bulge then sits, overlapping by the bulge's rows;
//  * deferred chains: every other entry those rotations touch sees one
//    side's rotations only, in ascending k: the row slab right of the
//    window (rows k0..k1+1) the row rotations, the column slab above it
//    (rows < a) and Z's columns k0..k1+1 the column rotations.  So each
//    column of the right slab, each row above the window and each row of Z
//    is one chain: a lane carries one entry and streams the next in, each
//    entry loaded and stored once a window.  A warp takes 32 chains staged
//    in its tile by cp.async: down columns of H and of Z^T (coalesced), or
//    along rows above the window (read along rows, turned in shared memory);
//  * per window: stage it; warp 0 chases it while warps 1..7 run the
//    previous window's chains that no later window waits for; write it back
//    and chain the right slab over the next window's columns, which the
//    next staging reads; the last window's chains end the sweep;
//  * every entry receives the per-rotation schedule's operations in its
//    order, each rounded on its own (rot_rows), so T, Z and the stats do not
//    depend on the window nor on the storage;
//  * the round-off of the chase on the second subdiagonal is zeroed once a
//    sweep.
#pragma once

#include "single_shift.cuh"

namespace qr_window {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows of a chase window: 32 ran 11-12% ahead of 64 at n = 338 and 450
// on an H100, the sizes this route takes (PERF.md)
constexpr int kW = 32;

// Shared memory of a block: the window (kW rows of kW + 1 columns), a tile
// of 32 chains of up to kW entries for each warp, the recorded rotations
// (c, s) of two windows (the one being chased and the one whose chains run
// meanwhile), the deflation flags.  The leading dimension kW + 1 is odd, so
// 32 lanes reading down a column or along their own rows hit distinct banks.
struct Layout {
  static constexpr int kLd = kW + 1;
  static constexpr int kWin = kW * kLd;
  static constexpr int kTile = 32 * kLd;
  static size_t bytes(int n) {
    return (size_t)(kWin + kWarps * kTile + 2 * kW) * sizeof(float2) +
           2 * kW * sizeof(float) + n;
  }
};

// One 4-byte cp.async (see cp_async8 in common.cuh).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Storage of an n x n complex matrix in device memory, row-major: get and
// put entry (i, j), and stage it into shared memory by cp.async.
// Interleaved complex64 (x = real, y = imaginary), leading dimension ld:
struct Interleaved {
  float2* p;
  int ld;
  __device__ __forceinline__ float2 get(int i, int j) const {
    return p[(size_t)i * ld + j];
  }
  __device__ __forceinline__ void put(int i, int j, float2 v) const {
    p[(size_t)i * ld + j] = v;
  }
  __device__ __forceinline__ void stage(float2* dst, int i, int j) const {
    cp_async8(dst, p + (size_t)i * ld + j);
  }
};
// Planar rows [re(0..n) pad | im(0..n) pad] of 2 npad floats: entry (i, j)
// is the floats j and npad + j of row i; each half is read and written
// with 4-byte accesses, so a warp on 32 columns of a row touches one
// 128-byte line of each half.  The padding floats are never written.
struct Planar {
  float* p;
  int npad;
  __device__ __forceinline__ float* at(int i, int j) const {
    return p + (size_t)i * 2 * npad + j;
  }
  __device__ __forceinline__ float2 get(int i, int j) const {
    const float* q = at(i, j);
    return c_make(q[0], q[npad]);
  }
  __device__ __forceinline__ void put(int i, int j, float2 v) const {
    float* q = at(i, j);
    q[0] = v.x;
    q[npad] = v.y;
  }
  __device__ __forceinline__ void stage(float2* dst, int i, int j) const {
    const float* q = at(i, j);
    cp_async4(&dst->x, q);
    cp_async4(&dst->y, q + npad);
  }
};

// One rotation's update of a pair: the per-rotation schedule's
// expressions, each product and sum rounded on its own by intrinsics, which
// nvcc does not fuse into FMAs: so the chase and the chains, at either
// window, compute the same bits whatever it would fuse in each context, the
// same bits as the plain model's element-wise rotation
// (ops/eig_kernels.py::_rotate), and, built with -fmad=false, the same as
// the per-rotation kernels these replaced.  Rows k, k+1 of a column:
// new_k = c h_k + s h_k1, new_k1 = c h_k1 - conj(s) h_k.
__device__ __forceinline__ void rot_rows(float c, float2 s, float2& u,
                                         float2& v) {
  const float2 nu = c_make(
      __fadd_rn(__fmul_rn(c, u.x),
                __fsub_rn(__fmul_rn(s.x, v.x), __fmul_rn(s.y, v.y))),
      __fadd_rn(__fmul_rn(c, u.y),
                __fadd_rn(__fmul_rn(s.x, v.y), __fmul_rn(s.y, v.x))));
  v = c_make(__fsub_rn(__fmul_rn(c, v.x),
                       __fadd_rn(__fmul_rn(s.x, u.x), __fmul_rn(s.y, u.y))),
             __fsub_rn(__fmul_rn(c, v.y),
                       __fsub_rn(__fmul_rn(s.x, u.y), __fmul_rn(s.y, u.x))));
  u = nu;
}
// Columns k, k+1 of a row: new_l = c l + conj(s) r, new_r = c r - s l: the
// row update with conj(s).
__device__ __forceinline__ void rot_cols(float c, float2 s, float2& l,
                                         float2& r) {
  rot_rows(c, c_make(s.x, -s.y), l, r);
}

// Entry q of a register array with a warp-uniform q (kept in registers:
// static indices only).
template <int N>
__device__ __forceinline__ float2 pick(const float2 (&v)[N], int q) {
  float2 r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (q == i) r = v[i];
  return r;
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return c_make(__shfl_sync(0xffffffffu, v.x, src),
                __shfl_sync(0xffffffffu, v.y, src));
}

// Rotations k0..k1 of one bulge in the staged window (rows [a, re),
// columns [a - 1, re), row-major with leading dimension kW + 1), by one
// warp; x, y carry the bulge in and out, and (c, s) of rotation k go to
// rc, rs[k - k0].  hi is the lane's window bottom: past it the next y is
// zero.  Each phase loads all its pairs before it stores any, so a phase
// waits for shared memory once; the next x, y come from the lanes that
// computed them.
__device__ __forceinline__ void chase_window(float2* __restrict__ win,
                                             float* __restrict__ rc,
                                             float2* __restrict__ rs, int a,
                                             int re, int k0, int k1, int hi,
                                             int n, float2& x, float2& y) {
  constexpr int kLd = kW + 1;
  constexpr int kRowIt = (kW + 1 + 31) / 32;  // columns k-1 .. re-1
  constexpr int kColIt = (kW + 31) / 32;      // rows a .. k+2
  const int lane = threadIdx.x & 31;
  for (int k = k0; k <= k1; ++k) {
    const Givens g = givens(x, y);
    const float c = g.c;
    const float2 s = g.s;
    if (lane == 0) {
      rc[k - k0] = c;
      rs[k - k0] = s;
    }
    // rows k, k+1 over columns >= k - 1 (local column j - a + 1)
    float2* rk = win + (k - a) * kLd;
    const int j0 = max(k - 1, 0) - a + 1 + lane, je = re - a + 1;
    float2 u[kRowIt], v[kRowIt];
#pragma unroll
    for (int q = 0; q < kRowIt; ++q)
      if (j0 + 32 * q < je) {
        u[q] = rk[j0 + 32 * q];
        v[q] = rk[j0 + 32 * q + kLd];
      }
#pragma unroll
    for (int q = 0; q < kRowIt; ++q)
      if (j0 + 32 * q < je) {
        rot_rows(c, s, u[q], v[q]);
        rk[j0 + 32 * q] = u[q];
        rk[j0 + 32 * q + kLd] = v[q];
      }
    __syncwarp();
    // columns k, k+1 over rows a .. min(k + 2, n - 1)
    float2* ck = win + (k - a + 1);
    const int ie = min(k + 2, n - 1) - a + 1;
    float2 l[kColIt], r[kColIt];
#pragma unroll
    for (int q = 0; q < kColIt; ++q)
      if (lane + 32 * q < ie) {
        l[q] = ck[(lane + 32 * q) * kLd];
        r[q] = ck[(lane + 32 * q) * kLd + 1];
      }
#pragma unroll
    for (int q = 0; q < kColIt; ++q)
      if (lane + 32 * q < ie) {
        rot_cols(c, s, l[q], r[q]);
        ck[(lane + 32 * q) * kLd] = l[q];
        ck[(lane + 32 * q) * kLd + 1] = r[q];
      }
    // the next bulge: h(k+1, k) and h(k+2, k) as just computed
    const int ix = k + 1 - a, iy = k + 2 - a;
    x = shfl2(pick(l, ix >> 5), ix & 31);
    const float2 yv = shfl2(pick(l, iy >> 5), iy & 31);
    y = (k + 2 <= hi && k + 2 <= n - 1) ? yv : c_make(0.f, 0.f);
    __syncwarp();
  }
}

// The chains down columns j0..j0+31 (< n) of X over rows k0..k0+m-1, one
// lane a column, the window's rotations in ascending k: row rotations on H
// (the slab right of the window), or, with kCols, column rotations on Z^T
// (Z's columns k0..k0+m-1, held transposed so that this read is coalesced
// too).  The column is staged in the warp's tile by cp.async and stored
// straight back; each step loads the next entry before it stores its own.
template <bool kCols, typename S>
__device__ __forceinline__ void down_chains(const S& X, int n, int k0, int m,
                                            int j0,
                                            float2* __restrict__ tile,
                                            const float* __restrict__ rc,
                                            const float2* __restrict__ rs) {
  const int lane = threadIdx.x & 31;
  const int j = j0 + lane;
  __syncwarp();
  if (j < n) {
    float2* __restrict__ col = tile + lane;
    for (int t = 0; t < m; ++t) X.stage(col + t * 32, k0 + t, j);
    cp_async_commit();
    cp_async_wait<0>();
    float2 x = col[0], y = col[32];
#pragma unroll 4
    for (int t = 0; t + 1 < m; ++t) {
      const float2 yn = col[(t + 2 < m ? t + 2 : t + 1) * 32];
      if (kCols)
        rot_cols(rc[t], rs[t], x, y);
      else
        rot_rows(rc[t], rs[t], x, y);
      X.put(k0 + t, j, x);
      x = y;
      y = yn;
    }
    X.put(k0 + m - 1, j, x);
  }
}

// The chains along rows i0..i0+31 (< rows) of H above the window over
// columns k0..k0+m-1: the window's column rotations in ascending k, one lane
// a row.  The rows are staged in the warp's tile by cp.async along rows and
// written back along rows.
template <typename S>
__device__ __forceinline__ void across_chains(const S& E, int rows, int k0,
                                              int m, int i0,
                                              float2* __restrict__ tile,
                                              const float* __restrict__ rc,
                                              const float2* __restrict__ rs) {
  constexpr int kLd = kW + 1;
  constexpr int kQ = (kW + 31) / 32;  // a row's entries a lane
  const int lane = threadIdx.x & 31;
  const int nr = min(32, rows - i0);
  __syncwarp();
  // the row loops run uniformly over the warp, lanes predicated (a loop
  // whose trip count differs by lane costs a reconvergence every row)
  for (int r = 0; r < nr; ++r)
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (lane + 32 * q < m)
        E.stage(tile + r * kLd + lane + 32 * q, i0 + r, k0 + lane + 32 * q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  if (lane < nr) {
    float2* __restrict__ e = tile + lane * kLd;
    float2 l = e[0], r = e[1];
#pragma unroll 4
    for (int t = 0; t + 1 < m; ++t) {
      const float2 rn = e[t + 2 < m ? t + 2 : t + 1];
      rot_cols(rc[t], rs[t], l, r);
      e[t] = l;
      l = r;
      r = rn;
    }
    e[m - 1] = l;
  }
  __syncwarp();
  for (int r = 0; r < nr; ++r)
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (lane + 32 * q < m)
        E.put(i0 + r, k0 + lane + 32 * q, tile[r * kLd + lane + 32 * q]);
}

// A window's chains that wait for no later window: the right slab from
// column jr on (the columns before jr were chained before the next window
// was staged), the rows above the window, all of Z.  They run on warps
// w0.. (nw of them) while warp 0 chases the next window, or on all warps at
// the end of a sweep.
struct Deferred {
  int k0, m;   // the window's first rotation; entries a chain
  int jr;      // first right-slab column still to chain
  int buf;     // which rotation buffer holds the window's (c, s)
};

template <typename S>
__device__ __forceinline__ void deferred_chains(const Deferred& d, const S& H,
                                                const S& Z, int n,
                                                float2* tile, const float* rc,
                                                const float2* rs, int w0,
                                                int nw) {
  const int warp = threadIdx.x >> 5;
  if (warp < w0) return;
  rc += d.buf * kW;
  rs += d.buf * kW;
  const int n_right = (n - d.jr + 31) / 32, n_above = (d.k0 + 31) / 32;
  const int units = n_right + n_above + (n + 31) / 32;
  for (int u = warp - w0; u < units; u += nw) {
    if (u < n_right)
      down_chains<false>(H, n, d.k0, d.m, d.jr + 32 * u, tile, rc, rs);
    else if (u < n_right + n_above)
      across_chains(H, d.k0, d.k0, d.m, 32 * (u - n_right), tile, rc, rs);
    else
      down_chains<true>(Z, n, d.k0, d.m, 32 * (u - n_right - n_above), tile,
                        rc, rs);
  }
}

// The sweeps of one matrix under the rules R, by all kThreads threads of
// the block, in place on H and on Z^T (storage S), smem: Layout::bytes(n)
// of dynamic shared memory.  On return (after a block barrier) hi is the
// final window bottom and it the sweeps taken; rot, the rotations applied,
// is thread 0's.
template <typename R, typename S>
__device__ __forceinline__ void sweeps(const S& H, const S& Z, int n,
                                       int max_iters, void* smem, int& hi,
                                       int& it, int& rot) {
  using Lay = Layout;
  constexpr int kLd = Lay::kLd;
  float2* win = static_cast<float2*>(smem);
  float2* tiles = win + Lay::kWin;
  float2* rs = tiles + kWarps * Lay::kTile;        // two buffers of kW
  float* rc = reinterpret_cast<float*>(rs + 2 * kW);
  unsigned char* alive = reinterpret_cast<unsigned char*>(rc + 2 * kW);
  __shared__ SweepPlan<R> plan;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  float2* tile = tiles + warp * Lay::kTile;

  hi = n - 1;
  it = 0;
  int stall = 0;  // meaningful in thread 0 only, as rot
  rot = 0;
  Deferred dfr{0, 0, 0, 0};
  bool pending = false;
  while (hi > 0 && it < max_iters) {
    // ---- deflation flags, windows and shifts (single_shift.cuh) ----
    plan_sweep<R>([&](int i, int j) { return H.get(i, j); }, hi, it, stall,
                  rot, alive, plan);
    hi = plan.hi0;
    const int nr = plan.nr;

    // ---- one bulge per run, top-most run first, window by window ----
    // Per window: stage it; warp 0 chases it while the other warps run the
    // previous window's deferred chains; write it back and chain the right
    // slab over the next window's columns.  The deferred chains touch no
    // entry of the next window, nor one that a later window's staging or
    // chase reads, and each runs before the next window's chains.
    for (int r = nr - 1; r >= 0; --r) {
      const int lo = plan.lo[r], hr = plan.hi[r];
      float2 x, y;  // the bulge, in warp 0
      for (int a = lo;;) {
        const int re = min(a + kW, n);
        const int k1 = re == n ? hr - 1 : min(hr - 1, a + kW - 3);
        const int c0 = max(a - 1, 0);
        const int wc = re - c0;
        const int nwin = (re - a) * wc;
        const int buf = pending ? 1 - dfr.buf : 0;
        float* rcb = rc + buf * kW;
        float2* rsb = rs + buf * kW;
        for (int e = tid; e < nwin; e += kThreads) {
          const int i = a + e / wc, j = c0 + e % wc;
          win[(i - a) * kLd + (j - a + 1)] = H.get(i, j);
        }
        __syncthreads();
        if (warp == 0) {
          if (a == lo) {
            x = c_sub(win[1], plan.shift[r]);  // h(lo, lo) - shift
            y = win[kLd + 1];                  // h(lo + 1, lo)
          }
          chase_window(win, rcb, rsb, a, re, a, k1, hi, n, x, y);
        } else if (pending) {
          deferred_chains(dfr, H, Z, n, tile, rc, rs, 1, kWarps - 1);
        }
        __syncthreads();
        for (int e = tid; e < nwin; e += kThreads) {
          const int i = a + e / wc, j = c0 + e % wc;
          H.put(i, j, win[(i - a) * kLd + (j - a + 1)]);
        }
        // the right slab over the next window's columns, now
        const bool last = k1 == hr - 1;
        const int jr =
            last ? re
                 : min(re + 32 * ((min(k1 + 1 + kW, n) - re + 31) / 32), n);
        const int m = k1 - a + 2;
        for (int u = warp; re + 32 * u < jr; u += kWarps)
          down_chains<false>(H, n, a, m, re + 32 * u, tile, rcb, rsb);
        __syncthreads();
        dfr = Deferred{a, m, jr, buf};
        pending = true;
        if (last) break;
        a = k1 + 1;
      }
    }
    if (pending) {
      deferred_chains(dfr, H, Z, n, tile, rc, rs, 0, kWarps);
      pending = false;
      __syncthreads();
    }
    // round-off of the chase on the second subdiagonal
    if (nr > 0) {
      for (int j = tid; j < n - 2; j += kThreads)
        H.put(j + 2, j, c_make(0.f, 0.f));
      __syncthreads();
    }
    ++it;
  }
}

}  // namespace qr_window
