// Batched implicit single-shift complex Schur QR: H = Z T Z^H with T upper
// triangular, from an upper Hessenberg H and its accumulated Q.
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_pallas.py::_kernel_acc
// (public entry schur_qr_pallas_acc) and keeps every rule of it:
//  * deflation: subdiagonal k is dead when |h_k+1,k| <= max(kDeflMult eps
//    (|h_kk| + |h_k+1,k+1|), 1e-31); the window bottom only moves up;
//  * up to kRuns independent windows (alive runs) per sweep, one bulge
//    each, bottom-most run first in the shift rules;
//  * Wilkinson shift from each run's trailing 2x2; every kExcEvery-th
//    sweep the bottom run takes the exceptional shift d + 0.75 |sub|;
//  * stall gate: an exactly real discriminant takes the real branch until
//    the window has not shrunk for kCplxStall sweeps (with real eps at
//    normal incidence A = PQ is exactly real, and an eager complex branch
//    costs ~15% more sweeps);
//  * budget max_iters sweeps; stats[b] = (final window bottom, sweeps),
//    window bottom 0 meaning converged.  The wrapper NaN-poisons the
//    diagonal of lanes that did not converge.
// The TPU kernel's deferred-column accumulator W, the Z^T storage and the
// prefix-bucket switch are TPU-shaped and are not carried over: each
// rotation is applied to the rows and columns of H and to Z directly.
//
// Design: one thread block per matrix (grid = batch); H (in T) and Z live
// in device memory (L2-resident at the main-path size); the deflation
// flags, the runs and the rotation carry live in shared memory.  Each
// sweep: all threads compute the deflation flags, thread 0 walks them to
// find the runs and their shifts, then each rotation is two phases (rows
// k, k+1 with threads over columns; columns k, k+1 of H and Z with threads
// over rows) separated by barriers.  The row update covers columns
// >= k - 1 and the column update rows <= k + 2, the only entries that are
// not structurally zero; the round-off the bulge chase leaves on the
// second subdiagonal is zeroed once per sweep.
//
// What bounds it on an H100: latency.  Every rotation is O(n) work behind
// two block barriers and an L2 round trip, and a sweep starts with a
// serial scan by one thread; the ~tens of thousands of rotations per
// matrix are inherently sequential.  The design does nothing yet against
// that beyond keeping the per-rotation work to the non-zero band; multi-
// shift chases and a cluster per matrix are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// The TPU kernel's rules (eig_qr_pallas.py: _NRUNS, _DEFL_MULT, _CPLX_STALL
// and the exceptional-shift period); ops/eig_kernels.py holds the same
// values for the plain version.
constexpr int kRuns = 4;
constexpr float kDeflMult = 4.f;
constexpr int kCplxStall = 30;
constexpr int kExcEvery = 13;

struct Givens {
  float c;
  float2 s;
};

// [[c, s], [-conj(s), c]] [x; y] = [r; 0], c real.
__device__ __forceinline__ Givens givens(float2 x, float2 y) {
  const float ax2 = c_abs2(x), ay2 = c_abs2(y);
  const float dn = sqrtf(ax2 + ay2);
  const float ax = sqrtf(ax2);
  const float safe_dn = dn > 0.f ? dn : 1.f;
  const float safe_ax = ax > 0.f ? ax : 1.f;
  Givens g;
  g.c = dn > 0.f ? ax / safe_dn : 1.f;
  const float den = safe_ax * safe_dn;
  const bool both = (ax > 0.f) && (dn > 0.f);
  g.s.x = both ? (x.x * y.x + x.y * y.y) / den : 0.f;
  g.s.y = both ? (x.y * y.x - x.x * y.y) / den : 0.f;
  if (ax2 == 0.f && ay2 > 0.f) {
    g.c = 0.f;
    g.s = c_make(1.f, 0.f);
  }
  return g;
}

// Eigenvalue of [[a, b], [c, d]] closest to d, with the stall-gated sign
// of the discriminant's imaginary part.
__device__ float2 wilkinson(float2 a, float2 b, float2 c, float2 d,
                            bool stalled) {
  const float trr = a.x + d.x, tri = a.y + d.y;
  const float detr = (a.x * d.x - a.y * d.y) - (b.x * c.x - b.y * c.y);
  const float deti = (a.x * d.y + a.y * d.x) - (b.x * c.y + b.y * c.x);
  const float qr = (trr * trr - tri * tri) - 4.f * detr;
  const float qi = 2.f * trr * tri - 4.f * deti;
  const float qmag = sqrtf(qr * qr + qi * qi);
  const float dscr = sqrtf(fmaxf((qmag + qr) * 0.5f, 0.f));
  const bool cplx_ok = (qi != 0.f) || stalled;
  const float sgn = cplx_ok ? (qi >= 0.f ? 1.f : -1.f) : 0.f;
  const float dsci = sgn * sqrtf(fmaxf((qmag - qr) * 0.5f, 0.f));
  const float l1r = (trr + dscr) * 0.5f, l1i = (tri + dsci) * 0.5f;
  const float l2r = (trr - dscr) * 0.5f, l2i = (tri - dsci) * 0.5f;
  const float e1 = (l1r - d.x) * (l1r - d.x) + (l1i - d.y) * (l1i - d.y);
  const float e2 = (l2r - d.x) * (l2r - d.x) + (l2i - d.y) * (l2i - d.y);
  return e1 < e2 ? c_make(l1r, l1i) : c_make(l2r, l2i);
}

__global__ void __launch_bounds__(kThreads)
schur_qr_kernel(const float2* __restrict__ Hin, const float2* __restrict__ Zin,
                float2* __restrict__ H, float2* __restrict__ Z,
                int* __restrict__ stats, int n, int max_iters) {
  extern __shared__ unsigned char alive[];  // alive[c]: subdiagonal c+1,c
  __shared__ int s_lo[kRuns], s_hi[kRuns];
  __shared__ float2 s_shift[kRuns];
  __shared__ int s_nr, s_hi0;
  __shared__ float2 s_x, s_y;

  const size_t off = (size_t)blockIdx.x * n * n;
  Hin += off;
  Zin += off;
  H += off;
  Z += off;
  const int tid = threadIdx.x;
  const int nn = n * n;
  for (int e = tid; e < nn; e += kThreads) {
    H[e] = Hin[e];
    Z[e] = Zin[e];
  }
  __syncthreads();

  int hi = n - 1, it = 0;
  int stall = 0;  // meaningful in thread 0 only
  while (hi > 0 && it < max_iters) {
    // ---- deflation flags on the live prefix ----
    for (int c = tid; c < hi; c += kThreads) {
      const float d0 = sqrtf(c_abs2(H[(size_t)c * n + c]));
      const float d1 = sqrtf(c_abs2(H[(size_t)(c + 1) * n + c + 1]));
      const float th =
          fmaxf(kDeflMult * TORCWA_EPS_F32 * (d0 + d1), TORCWA_SMLNUM_F32);
      alive[c] = c_abs2(H[(size_t)(c + 1) * n + c]) > th * th;
    }
    __syncthreads();

    // ---- windows and shifts (one thread walks the flags) ----
    if (tid == 0) {
      int h = hi;
      while (h > 0 && !alive[h - 1]) --h;
      stall = h < hi ? 0 : stall + 1;
      s_hi0 = h;
      int nr = 0, top = h;
      for (int r = 0; r < kRuns; ++r) {
        int hr = top;
        if (r > 0) {
          hr = top - 1;
          while (hr > 0 && !alive[hr - 1]) --hr;
        }
        if (hr <= 0) break;
        int lo = hr;
        while (lo > 0 && alive[lo - 1]) --lo;
        const float2 a = H[(size_t)(hr - 1) * n + hr - 1];
        const float2 b = H[(size_t)(hr - 1) * n + hr];
        const float2 c = H[(size_t)hr * n + hr - 1];
        const float2 d = H[(size_t)hr * n + hr];
        float2 sh = wilkinson(a, b, c, d, stall >= kCplxStall);
        if (r == 0 && (it % kExcEvery) == kExcEvery - 1)
          sh = c_make(d.x + 0.75f * sqrtf(c_abs2(c)), d.y);
        s_lo[nr] = lo;
        s_hi[nr] = hr;
        s_shift[nr] = sh;
        ++nr;
        top = lo;
      }
      s_nr = nr;
    }
    __syncthreads();
    hi = s_hi0;
    const int nr = s_nr;

    // ---- one bulge per run, top-most run first ----
    for (int r = nr - 1; r >= 0; --r) {
      const int lo = s_lo[r], hr = s_hi[r];
      if (tid == 0) {
        s_x = c_sub(H[(size_t)lo * n + lo], s_shift[r]);
        s_y = H[(size_t)(lo + 1) * n + lo];
      }
      __syncthreads();
      for (int k = lo; k < hr; ++k) {
        const Givens g = givens(s_x, s_y);
        const float c = g.c;
        const float2 s = g.s;
        // rows k, k+1:  new_k = c h_k + s h_k1 ; new_k1 = c h_k1 - conj(s) h_k
        for (int j = max(k - 1, 0) + tid; j < n; j += kThreads) {
          const float2 hk = H[(size_t)k * n + j];
          const float2 h1 = H[(size_t)(k + 1) * n + j];
          H[(size_t)k * n + j] = c_add(c_scale(c, hk), c_mul(s, h1));
          H[(size_t)(k + 1) * n + j] = c_sub(c_scale(c, h1), c_cmul(s, hk));
        }
        __syncthreads();
        // columns k, k+1:  new_l = c l + conj(s) r ; new_r = c r - s l
        const int imax = min(k + 2, n - 1);
        for (int i = tid; i < n; i += kThreads) {
          if (i <= imax) {
            const float2 l = H[(size_t)i * n + k];
            const float2 rr = H[(size_t)i * n + k + 1];
            const float2 nl = c_add(c_scale(c, l), c_cmul(s, rr));
            H[(size_t)i * n + k] = nl;
            H[(size_t)i * n + k + 1] = c_sub(c_scale(c, rr), c_mul(s, l));
            if (i == k + 1) s_x = nl;
            if (i == k + 2) s_y = (k + 2 <= hi) ? nl : c_make(0.f, 0.f);
          }
          const float2 zl = Z[(size_t)i * n + k];
          const float2 zr = Z[(size_t)i * n + k + 1];
          Z[(size_t)i * n + k] = c_add(c_scale(c, zl), c_cmul(s, zr));
          Z[(size_t)i * n + k + 1] = c_sub(c_scale(c, zr), c_mul(s, zl));
        }
        if (tid == 0 && k + 2 > n - 1) s_y = c_make(0.f, 0.f);
        __syncthreads();
      }
    }
    // round-off of the chase on the second subdiagonal
    if (nr > 0) {
      for (int j = tid; j < n - 2; j += kThreads)
        H[(size_t)(j + 2) * n + j] = c_make(0.f, 0.f);
      __syncthreads();
    }
    ++it;
  }

  for (int e = tid; e < nn; e += kThreads)
    if (e / n > e % n) H[e] = c_make(0.f, 0.f);
  if (tid == 0) {
    stats[2 * blockIdx.x] = hi;
    stats[2 * blockIdx.x + 1] = it;
  }
}

}  // namespace

extern "C" int torcwa_schur_qr_c64(const void* Hin, const void* Zin, void* T,
                                   void* Z, void* stats, int batch, int n,
                                   int max_iters, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  schur_qr_kernel<<<batch, kThreads, (size_t)n, (cudaStream_t)stream>>>(
      (const float2*)Hin, (const float2*)Zin, (float2*)T, (float2*)Z,
      (int*)stats, n, max_iters);
  return (int)cudaGetLastError();
}
