// Aggressive early deflation (AED) on the trailing window of the active block
// [lo, hi] of an upper Hessenberg matrix, worked in shared memory by the
// first kNT threads of a thread block.  Shared by schur_ms.cu (one launch of
// a block of kNT threads per sweep) and schur_qr_baed.cu (inside the sweep
// loop of a larger block, one matrix a block); their source comments say
// which TPU kernels that replaces (eig_qr_hbm.py::_mini_schur and the AED
// block of ::_kernel_hbm, attic/eig_qr_pallas_baed.py::_mini_schur_b and the
// AED block of ::_kernel_baed).  The rules:
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
// The phases are separated by the named barrier kBar over kNT threads
// (barrier 0 over the whole block is __syncthreads), so that the other warps
// of a larger block may wait at a block barrier meanwhile.
#pragma once

#include "common.cuh"

constexpr int kAedMaxKw = 64;

// float2 entries of shared memory aed_window needs for a window of kw rows
__host__ __device__ inline size_t aed_smem_elems(int kw) {
  return 2 * (size_t)kw * kw + 2 * (size_t)(kw + 1) * (kw + 1) +
         2 * (size_t)kw + 1;
}
// L in that memory, (kw + 1) x (kw + 1) with leading dimension kw + 1; the
// 2 kw^2 entries before Ap (the window and its Schur vectors) are free again
// once aed_window has returned.
__host__ __device__ inline size_t aed_L_offset(int kw) {
  return 2 * (size_t)kw * kw + (size_t)(kw + 1) * (kw + 1);
}

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

// Called by threads 0..kNT-1 of the block, all with the same arguments and
// hi > 0; H is read and written through ordinary loads and stores (the
// caller may have written it earlier in the same launch).  sm:
// aed_smem_elems(kw) float2 of shared memory; shifts: m float2, shared or
// device memory.  Every calling thread gets the result; L, the shifts and H
// are complete for the calling threads on return (a block barrier makes them
// so for the rest of the block).
template <int kNT, int kBar>
__device__ AedResult aed_window(float2* H, int n, int lo, int hi, bool exc,
                                int m, int kw, float defl_mult,
                                bool uncut_scale, float2* sm, float2* shifts) {
  const int ld = kw, ld1 = kw + 1;
  float2* W = sm;                     // window, then its Schur factor T
  float2* Qm = W + kw * kw;           // T = Qm W Qm^H
  float2* Ap = Qm + kw * kw;          // [[0, 0], [spike, T]], (kw+1)^2
  float2* L = Ap + ld1 * ld1;         // reflectors . diag(1, Qm)
  float2* spike = L + ld1 * ld1;      // kw
  float2* v = spike + kw;             // kw + 1
  __shared__ float red[kNT / 32];
  __shared__ int s_mhi, s_mlo, s_ku;
  __shared__ float2 s_x, s_y;
  __shared__ unsigned char defl[kAedMaxKw];

  const int tid = threadIdx.x;
  const int s = max(hi - kw + 1, lo + 1);
  const int kwe = hi - s + 1;
  const int K1 = kwe + 1;

  float wmax = 0.f;
  for (int e = tid; e < kwe * kwe; e += kNT) {
    const int i = e / kwe, j = e % kwe;
    const float2 h = H[(size_t)(s + i) * n + s + j];
    W[i * ld + j] = h;
    Qm[i * ld + j] = c_make(i == j ? 1.f : 0.f, 0.f);
    wmax = fmaxf(wmax, c_abs2(h));
  }
  if (uncut_scale && kwe < kw) {
    for (int e = tid; e < kw * kw; e += kNT) {
      const int i = e / kw, j = e % kw;
      if ((i >= kwe || j >= kwe) && s + i < n && s + j < n)
        wmax = fmaxf(wmax, c_abs2(H[(size_t)(s + i) * n + s + j]));
    }
  }
  const float smax = fmaxf(sqrtf(aed_group_max<kNT, kBar>(wmax, red)),
                           TORCWA_SMLNUM_F32);
  const float2 beta = H[(size_t)s * n + s - 1];

  // ---- single-shift Schur form of the window, Qm accumulated ----
  const int max_it = 3 * kw + 40;
  int it = 0, mhi = kwe - 1;
  while (true) {
    if (tid == 0) {
      auto alive = [&](int c) {
        return sub_alive(W[c * ld + c], W[(c + 1) * ld + c + 1],
                         W[(c + 1) * ld + c], 1.f);
      };
      int h = mhi;
      while (h > 0 && !alive(h - 1)) --h;
      int l = h;
      while (l > 0 && alive(l - 1)) --l;
      s_mhi = h;
      s_mlo = l;
      if (h > 0) {
        const float2 a = W[(h - 1) * ld + h - 1], b = W[(h - 1) * ld + h];
        const float2 c = W[h * ld + h - 1], d = W[h * ld + h];
        float2 sh = wilkinson(a, b, c, d, true);
        if (it % 13 == 12) sh = c_make(d.x + 0.75f * sqrtf(c_abs2(c)), d.y);
        s_x = c_sub(W[l * ld + l], sh);
        s_y = W[(l + 1) * ld + l];
      }
    }
    aed_sync<kNT, kBar>();
    mhi = s_mhi;
    const int mlo = s_mlo;
    if (mhi <= 0 || it >= max_it) break;
    for (int k = mlo; k < mhi; ++k) {
      const Givens g = givens_rounded(s_x, s_y);
      const float c = g.c;
      const float2 sg = g.s;
      // rows k, k+1 of W (columns >= k-1) and of Qm
      for (int idx = tid; idx < 2 * kwe; idx += kNT) {
        float2* X = idx < kwe ? W : Qm;
        const int j = idx < kwe ? idx : idx - kwe;
        if (idx < kwe && j < k - 1) continue;
        const float2 hk = X[k * ld + j], h1 = X[(k + 1) * ld + j];
        X[k * ld + j] = c_add(c_scale(c, hk), c_mul(sg, h1));
        X[(k + 1) * ld + j] = c_sub(c_scale(c, h1), c_cmul(sg, hk));
        if (idx < kwe && j == k - 1 && k > mlo)
          X[(k + 1) * ld + j] = c_make(0.f, 0.f);
      }
      aed_sync<kNT, kBar>();
      // columns k, k+1 of W, rows <= min(k+2, mhi)
      const int imax = min(k + 2, mhi);
      for (int i = tid; i <= imax; i += kNT) {
        const float2 l = W[i * ld + k], r = W[i * ld + k + 1];
        const float2 nl = c_add(c_scale(c, l), c_cmul(sg, r));
        W[i * ld + k] = nl;
        W[i * ld + k + 1] = c_sub(c_scale(c, r), c_mul(sg, l));
        if (i == k + 1) {
          s_x = nl;
          if (k + 2 > mhi) s_y = c_make(0.f, 0.f);
        }
        if (i == k + 2) s_y = nl;
      }
      aed_sync<kNT, kBar>();
    }
    ++it;
  }

  // ---- spike, deflatable lanes, undeflated count ku ----
  for (int i = tid; i < kwe; i += kNT) {
    const float2 sp = c_mul(beta, Qm[i * ld]);
    spike[i] = sp;
    const float td = sqrtf(c_abs2(W[i * ld + i]));
    defl[i] = (sqrtf(c_abs2(sp)) <= defl_mult * TORCWA_EPS_F32 *
                                        fmaxf(td, smax)) && (i >= mhi);
  }
  aed_sync<kNT, kBar>();
  if (tid == 0) {
    int ku = kwe;
    while (ku > 0 && defl[ku - 1]) --ku;
    s_ku = ku;
    // shifts
    const int kum1 = max(ku - 1, 0);
    if (exc) {
      for (int i = 0; i < m; ++i) {
        const int pos = min(max(ku - m + i, 0), kum1);
        const float2 d = W[pos * ld + pos];
        shifts[i] = c_make(d.x + 0.75f * sqrtf(c_abs2(spike[pos])), d.y);
      }
    } else {
      // the m lanes closest to the new corner, undeflated lanes first,
      // ties and the lanes >= ku in index order
      const float2 cn = W[kum1 * ld + kum1];
      unsigned long long taken = 0ull;
      float2 last = cn;
      for (int i = 0; i < m; ++i) {
        int pick = -1;
        float best = 0.f;
        for (int q = 0; q < ku; ++q) {
          if ((taken >> q) & 1ull) continue;
          const float dq = c_abs2(c_sub(W[q * ld + q], cn));
          if (pick < 0 || dq < best) { pick = q; best = dq; }
        }
        if (pick < 0)
          for (int q = ku; q < kwe; ++q)
            if (!((taken >> q) & 1ull)) { pick = q; break; }
        if (pick >= 0) {
          taken |= 1ull << pick;
          last = W[pick * ld + pick];
        }
        shifts[i] = last;
      }
    }
  }
  aed_sync<kNT, kBar>();
  const int ku = s_ku;

  // ---- bordered matrix and L = diag(1, Qm) ----
  for (int e = tid; e < K1 * K1; e += kNT) {
    const int r = e / K1, c = e % K1;
    float2 a = c_make(0.f, 0.f), l = c_make(r == c ? 1.f : 0.f, 0.f);
    if (r > 0 && c > 0) {
      a = W[(r - 1) * ld + c - 1];
      l = Qm[(r - 1) * ld + c - 1];
    } else if (r > 0) {
      a = defl[r - 1] ? c_make(0.f, 0.f) : spike[r - 1];
      l = c_make(0.f, 0.f);
    }
    Ap[r * ld1 + c] = a;
    L[r * ld1 + c] = l;
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
      H[(size_t)(s - 1 + r) * n + s - 1 + c] = a;
    }
  }
  aed_sync<kNT, kBar>();
  AedResult res;
  res.s = s;
  res.kwe = kwe;
  res.ku = ku;
  res.mhi = mhi;
  res.it = it;
  return res;
}
