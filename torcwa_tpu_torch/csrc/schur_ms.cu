// Windowed multishift Schur QR with aggressive early deflation (AED) for ONE
// large upper Hessenberg matrix: H = Z T Z^H, H and Z in device memory.
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_hbm.py::_kernel_hbm (public
// entry schur_qr_hbm) with its _mini_schur, and keeps its rules:
//  * band scan: subdiagonal k is dead when |h_k+1,k| <= max(defl_mult eps
//    (|h_kk| + |h_k+1,k+1|), 1e-31); the active block [lo, hi] is the
//    bottom-most alive run at or above the previous window bottom;
//  * AED on the trailing window of at most kw rows: a single-shift Schur
//    form of the window (Wilkinson shift, an exceptional shift every 13th
//    iteration, deflation at eps (|d| + |d'|), budget 3 kw + 40), the spike
//    beta Q[:, 0], the bottom run of converged lanes with |spike_i| <=
//    defl_mult eps max(|T_ii|, max|W|) deflates, the rest is reduced back
//    to Hessenberg form by Householder reflectors;
//  * shifts: the m undeflated window eigenvalues closest to the new corner,
//    deflated lanes last; on an exceptional sweep the perturbed trailing
//    undeflated diagonals; without AED (aed=False) the eigenvalues of the
//    trailing m x m block of the active block instead, ordered by distance
//    to H[hi, hi] (ms_shifts.cuh), and no deflation beyond the band scan's;
//  * chase: m spacing-2 single-shift bulges through overlapping diagonal
//    windows; bulge i sits at row k = t - 2 i at step t and enters at
//    k = lo with (H[lo,lo] - sigma_i, H[lo+1,lo]).
// The sweep loop (nibble rule, stall counter, window schedule, budget) runs
// on the host in ops/schur_ms.py, which launches the functions below once
// or a few times per sweep and reads `info` back once per sweep.
//
// Not carried over, because they exist only for the TPU's compiler: the
// padding to multiples of 128, the (1, T, 128) band layout, the one-hot
// selection matmuls, the split-real pairs and Z^T storage, the deferred
// invariant M = B U^T with its local chase block and parked-bump mask.
// Rotations are applied to H directly, so bulges simply stay in H between
// windows; H, Z and the small unitaries are complex64, row-major.
//
// Design for an H100:
//  * ms_band_scan: one block; two integer max-reductions over the band.
//  * ms_aed: one block, the window W, its Schur vectors, the bordered
//    matrix [spike | T] and the accumulated transform in shared memory
//    (~133 KB at kw = 64).  It writes the transformed diagonal block and
//    spike column back to H itself, with the known zeros exact, and the
//    kwe x kwe transform Lp for the off-diagonal slabs.
//  * ms_trailing_shifts (aed=False): one warp, the m x m block in shared
//    memory; it fills `info` and `shifts` where ms_aed would.
//  * ms_chase: one block per window; a window of up to 169 rows is staged
//    in shared memory for the chase and written back at its end, a wider
//    one is worked in device memory.  At a step the m rotations touch
//    disjoint row pairs and disjoint column pairs and their parameters are
//    known from the step before, so all row rotations (H window and the
//    window's accumulated unitary U) run in parallel, then all column
//    rotations: three barriers per step.  Row rotations cover columns
//    >= max(k - 1, lo) only, so that a bump created by a trailing bulge is
//    never smeared by the bulge ahead of it.
//  * ms_apply_left / ms_apply_right: the small unitary times a slab of H
//    or Z, in place, as a tiled complex GEMM in IEEE f32 FFMA: a block owns
//    a strip of 32 columns (rows), stages it in shared memory, accumulates
//    in registers and writes it back.
//
// What bounds it on an H100: the chase runs in one block, so on one SM's
// path to the L2 cache: worked in device memory a step moves ~m (2 wb x
// 32 B in the row phase + wb x 128 B in the column phase, whose 16-byte
// accesses fetch whole 32-byte sectors), ~0.5 MB at m = 24, wb = 128, and
// takes ~9 us; keeping more loads in flight per thread changed nothing.
// Hence the narrow window staged in shared memory, which leaves U's rows
// (m wb x 32 B a step) as the traffic; a cluster per window is later work.
// AED is the serial mini-Schur in one block; the slab products are the
// only throughput part (~2 n wb^2 complex multiply-adds per window).

#include "ms_aed.cuh"
#include "ms_shifts.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kAedThreads = 128;
constexpr int kChaseThreads = 1024;
constexpr size_t kMaxChaseSmem = 225 * 1024;  // dynamic, beside ~2 KB static
constexpr int kGemmThreads = 256;
constexpr int kMaxM = 64;     // shifts per sweep
constexpr int kMaxKw = kAedMaxKw;  // AED window
constexpr int kMaxW = 256;    // order of a slab transform (chase window)
constexpr int kStrip = 32;    // columns (rows) of a slab per block
constexpr int kKT = 8;        // depth of a staged tile of the transform

// info[]: what the host reads back once per sweep
enum { I_LO = 0, I_HI, I_S, I_KWE, I_HINEW, I_KU, I_HIM, I_MINI_IT, I_COUNT };

// ---------------------------------------------------------------------------
// band scan
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
ms_band_scan(const float2* __restrict__ H, int n, int hi_top, float defl_mult,
             int* __restrict__ info) {
  __shared__ int red[33];
  const int tid = threadIdx.x;
  auto alive = [&](int c) {  // subdiagonal H[c+1, c]
    return sub_alive(H[(size_t)c * n + c], H[(size_t)(c + 1) * n + c + 1],
                     H[(size_t)(c + 1) * n + c], defl_mult);
  };
  int best = 0;
  for (int c = tid; c < hi_top; c += kScanThreads)
    if (alive(c)) best = max(best, c + 1);
  const int hi = block_max_int(best, red);
  best = 0;
  for (int g = tid + 1; g <= hi; g += kScanThreads)
    if (!alive(g - 1)) best = max(best, g);
  const int lo = block_max_int(best, red);
  if (tid == 0) {
    info[I_LO] = lo;
    info[I_HI] = hi;
  }
}

// ---------------------------------------------------------------------------
// aggressive early deflation
// ---------------------------------------------------------------------------

// The AED body is aed_window of ms_aed.cuh (schur_qr_baed.cu runs it too,
// inside its own sweep loop); this launch adds what the host loop needs: the
// kwe x kwe transform Lp for the slab products and the info record.
__global__ void __launch_bounds__(kAedThreads)
ms_aed(float2* __restrict__ H, int n, int* __restrict__ info, int exc, int m,
       int kw, float defl_mult, float2* __restrict__ Lp,
       float2* __restrict__ shifts) {
  extern __shared__ float2 sm[];
  const int tid = threadIdx.x;
  const int lo = info[I_LO], hi = info[I_HI];
  if (hi <= 0) {
    if (tid == 0) {
      info[I_S] = 0; info[I_KWE] = 0; info[I_HINEW] = 0; info[I_KU] = 0;
      info[I_HIM] = 0; info[I_MINI_IT] = 0;
    }
    return;
  }
  const AedResult r = aed_window<kAedThreads, 0>(
      H, n, lo, hi, exc != 0, m, kw, defl_mult, false, sm, shifts);
  const float2* L = sm + aed_L_offset(kw);
  const int kwe = r.kwe, ld1 = kw + 1;
  for (int e = tid; e < kwe * kwe; e += kAedThreads)
    Lp[(e / kwe) * kwe + e % kwe] = L[(e / kwe + 1) * ld1 + e % kwe + 1];
  if (tid == 0) {
    info[I_S] = r.s; info[I_KWE] = kwe; info[I_HINEW] = r.s + r.ku - 1;
    info[I_KU] = r.ku; info[I_HIM] = r.mhi; info[I_MINI_IT] = r.it;
  }
}

// ---------------------------------------------------------------------------
// shifts without AED: eigenvalues of the trailing m x m block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
ms_trailing_shifts(const float2* __restrict__ H, int n, int* __restrict__ info,
                   int exc, int m, float2* __restrict__ shifts) {
  extern __shared__ float2 sm[];
  const int lo = info[I_LO], hi = info[I_HI];
  if (threadIdx.x == 0) {
    info[I_S] = 0; info[I_KWE] = 0; info[I_HINEW] = hi; info[I_KU] = 0;
    info[I_HIM] = 0; info[I_MINI_IT] = 0;
  }
  if (hi <= 0) return;
  float2* B = sm;
  float* dist = (float*)(sm + shift_block_elems(m));
  trailing_shifts_warp(H, n, lo, hi, m, exc != 0, B, dist, shifts);
}

// ---------------------------------------------------------------------------
// bulge chase through one window
// ---------------------------------------------------------------------------

// Hw points at the window's top-left entry, with leading dimension ldh:
// into H itself (ldh = n), or, when `staged`, into a copy of the window
// in shared memory (ldh = wb + 1) that is written back at the end.
__global__ void __launch_bounds__(kChaseThreads)
ms_chase(float2* __restrict__ H, int n, float2* __restrict__ U, int a, int wb,
         int tcur, int t_end, int lo, int hi, int m,
         const float2* __restrict__ shifts, float2* __restrict__ xy,
         int staged) {
  extern __shared__ float2 sm[];
  __shared__ float s_c[kMaxM];
  __shared__ float2 s_s[kMaxM], s_x[kMaxM], s_y[kMaxM];
  __shared__ unsigned char s_act[kMaxM];
  const int tid = threadIdx.x;
  float2* const Hg = H + (size_t)a * n + a;
  float2* const Hw = staged ? sm : Hg;
  const int ldh = staged ? wb + 1 : n;

  for (int e = tid; e < wb * wb; e += kChaseThreads) {
    U[e] = c_make(e / wb == e % wb ? 1.f : 0.f, 0.f);
    if (staged)
      sm[(e / wb) * ldh + e % wb] = Hg[(size_t)(e / wb) * n + e % wb];
  }
  if (tid < m) {
    s_x[tid] = xy[tid];
    s_y[tid] = xy[m + tid];
  }
  __syncthreads();

  for (int t = tcur; t <= t_end; ++t) {
    // ---- the step's rotations ----
    if (tid < m) {
      const int i = tid, k = t - 2 * i;
      const bool valid = lo + 2 * i + 1 <= hi;
      const bool act = valid && k >= lo && k < hi;
      s_act[i] = act;
      if (act) {
        if (k == lo) {
          s_x[i] = c_sub(Hw[(lo - a) * ldh + lo - a], shifts[i]);
          s_y[i] = Hw[(lo + 1 - a) * ldh + lo - a];
        }
        const Givens g = givens(s_x[i], s_y[i]);
        s_c[i] = g.c;
        s_s[i] = g.s;
      }
    }
    __syncthreads();
    // ---- rows k, k+1: the window's columns of H, and U ----
    for (int idx = tid; idx < m * 2 * wb; idx += kChaseThreads) {
      const int i = idx / (2 * wb), jj = idx % (2 * wb);
      if (!s_act[i]) continue;
      const int k = t - 2 * i;
      const float c = s_c[i];
      const float2 sg = s_s[i];
      float2 *pk, *p1;
      bool zap = false;
      if (jj < wb) {
        const int col = a + jj;
        if (col < max(k - 1, lo)) continue;
        pk = Hw + (size_t)(k - a) * ldh + jj;
        p1 = pk + ldh;
        zap = (col == k - 1) && (k > lo);
      } else {
        pk = U + (size_t)(k - a) * wb + (jj - wb);
        p1 = pk + wb;
      }
      const float2 hk = *pk, h1 = *p1;
      *pk = c_add(c_scale(c, hk), c_mul(sg, h1));
      *p1 = zap ? c_make(0.f, 0.f) : c_sub(c_scale(c, h1), c_cmul(sg, hk));
    }
    __syncthreads();
    // ---- columns k, k+1: the window's rows of H up to min(k+2, hi) ----
    for (int idx = tid; idx < m * wb; idx += kChaseThreads) {
      const int i = idx / wb, r = a + idx % wb;
      if (!s_act[i]) continue;
      const int k = t - 2 * i;
      if (r > min(k + 2, hi)) continue;
      const float c = s_c[i];
      const float2 sg = s_s[i];
      float2* p = Hw + (size_t)(r - a) * ldh + k - a;
      const float2 l = p[0], rr = p[1];
      const float2 nl = c_add(c_scale(c, l), c_cmul(sg, rr));
      p[0] = nl;
      p[1] = c_sub(c_scale(c, rr), c_mul(sg, l));
      if (r == k + 1) {
        s_x[i] = nl;
        if (k + 2 > hi) s_y[i] = c_make(0.f, 0.f);
      }
      if (r == k + 2) s_y[i] = nl;
    }
    __syncthreads();
  }
  if (staged)
    for (int e = tid; e < wb * wb; e += kChaseThreads)
      Hg[(size_t)(e / wb) * n + e % wb] = sm[(e / wb) * ldh + e % wb];
  if (tid < m) {
    xy[tid] = s_x[tid];
    xy[m + tid] = s_y[tid];
  }
}

// ---------------------------------------------------------------------------
// slab products with the small unitary P (w x w, leading dimension ldp)
// ---------------------------------------------------------------------------

// X[a:a+w, c0:c1] <- P X[a:a+w, c0:c1]; a block owns kStrip columns.
__global__ void __launch_bounds__(kGemmThreads)
ms_apply_left(float2* __restrict__ X, int ldx, int a, int w, int c0, int c1,
              const float2* __restrict__ P, int ldp) {
  extern __shared__ float2 sm[];
  float2* Xs = sm;                 // [w][kStrip]
  float2* Ps = sm + w * kStrip;    // [kKT][w]: Ps[kk][i] = P[i, k0 + kk]
  const int tid = threadIdx.x, tx = tid % kStrip, ty = tid / kStrip;
  constexpr int kRowGroups = kGemmThreads / kStrip;       // 8
  constexpr int kRows = kMaxW / kRowGroups;               // 32 per thread
  const int cb = c0 + blockIdx.x * kStrip;
  const int col = cb + tx;
  for (int e = tid; e < w * kStrip; e += kGemmThreads) {
    const int k = e / kStrip, j = e % kStrip;
    Xs[e] = cb + j < c1 ? X[(size_t)(a + k) * ldx + cb + j]
                        : c_make(0.f, 0.f);
  }
  float2 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = c_make(0.f, 0.f);
  for (int k0 = 0; k0 < w; k0 += kKT) {
    __syncthreads();
    for (int e = tid; e < w * kKT; e += kGemmThreads) {
      const int i = e / kKT, kk = e % kKT;
      Ps[kk * w + i] = k0 + kk < w ? P[(size_t)i * ldp + k0 + kk]
                                   : c_make(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      if (k0 + kk >= w) break;
      const float2 xv = Xs[(k0 + kk) * kStrip + tx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ty + kRowGroups * r;
        if (i < w) acc[r] = c_add(acc[r], c_mul(Ps[kk * w + i], xv));
      }
    }
  }
  if (col < c1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = ty + kRowGroups * r;
      if (i < w) X[(size_t)(a + i) * ldx + col] = acc[r];
    }
  }
}

// X[r0:r1, a:a+w] <- X[r0:r1, a:a+w] P^H; a block owns kStrip rows.
__global__ void __launch_bounds__(kGemmThreads)
ms_apply_right(float2* __restrict__ X, int ldx, int r0, int r1, int a, int w,
               const float2* __restrict__ P, int ldp) {
  extern __shared__ float2 sm[];
  float2* Xs = sm;                 // [kStrip][w]
  float2* Ps = sm + kStrip * w;    // [kKT][w]: Ps[kk][j] = conj(P[j, k0+kk])
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  constexpr int kRowsPer = kStrip / (kGemmThreads / 32);  // 4 rows per thread
  constexpr int kCols = kMaxW / 32;                       // 8 columns
  const int rb = r0 + blockIdx.x * kStrip;
  for (int e = tid; e < kStrip * w; e += kGemmThreads) {
    const int i = e / w, k = e % w;
    Xs[e] = rb + i < r1 ? X[(size_t)(rb + i) * ldx + a + k]
                        : c_make(0.f, 0.f);
  }
  float2 acc[kRowsPer][kCols];
#pragma unroll
  for (int q = 0; q < kRowsPer; ++q)
#pragma unroll
    for (int r = 0; r < kCols; ++r) acc[q][r] = c_make(0.f, 0.f);
  for (int k0 = 0; k0 < w; k0 += kKT) {
    __syncthreads();
    for (int e = tid; e < w * kKT; e += kGemmThreads) {
      const int j = e / kKT, kk = e % kKT;
      float2 p = c_make(0.f, 0.f);
      if (k0 + kk < w) p = P[(size_t)j * ldp + k0 + kk];
      Ps[kk * w + j] = c_make(p.x, -p.y);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      if (k0 + kk >= w) break;
      float2 xq[kRowsPer];
#pragma unroll
      for (int q = 0; q < kRowsPer; ++q)
        xq[q] = Xs[(ty * kRowsPer + q) * w + k0 + kk];
#pragma unroll
      for (int r = 0; r < kCols; ++r) {
        const int j = tx + 32 * r;
        if (j < w) {
          const float2 pj = Ps[kk * w + j];
#pragma unroll
          for (int q = 0; q < kRowsPer; ++q)
            acc[q][r] = c_add(acc[q][r], c_mul(xq[q], pj));
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsPer; ++q) {
    const int row = rb + ty * kRowsPer + q;
    if (row >= r1) continue;
#pragma unroll
    for (int r = 0; r < kCols; ++r) {
      const int j = tx + 32 * r;
      if (j < w) X[(size_t)row * ldx + a + j] = acc[q][r];
    }
  }
}

size_t gemm_smem(int w) {
  return ((size_t)w * kStrip + (size_t)kKT * w) * sizeof(float2);
}

}  // namespace

extern "C" int torcwa_ms_band_scan_c64(const void* H, int n, int hi_top,
                                       float defl_mult, void* info,
                                       void* stream) {
  ms_band_scan<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)H, n, hi_top, defl_mult, (int*)info);
  return (int)cudaGetLastError();
}

extern "C" int torcwa_ms_aed_c64(void* H, int n, void* info, int exc, int m,
                                 int kw, float defl_mult, void* Lp,
                                 void* shifts, void* stream) {
  if (kw < 1 || kw > kMaxKw || m < 1 || m > kMaxM)
    return (int)cudaErrorInvalidValue;
  const size_t smem = aed_smem_elems(kw) * sizeof(float2);
  cudaError_t err = set_smem(ms_aed, smem);
  if (err != cudaSuccess) return (int)err;
  ms_aed<<<1, kAedThreads, smem, (cudaStream_t)stream>>>(
      (float2*)H, n, (int*)info, exc, m, kw, defl_mult, (float2*)Lp,
      (float2*)shifts);
  return (int)cudaGetLastError();
}

extern "C" int torcwa_ms_trailing_shifts_c64(const void* H, int n, void* info,
                                             int exc, int m, void* shifts,
                                             void* stream) {
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem =
      shift_block_elems(m) * sizeof(float2) + (size_t)m * sizeof(float);
  cudaError_t err = set_smem(ms_trailing_shifts, smem);
  if (err != cudaSuccess) return (int)err;
  ms_trailing_shifts<<<1, 32, smem, (cudaStream_t)stream>>>(
      (const float2*)H, n, (int*)info, exc, m, (float2*)shifts);
  return (int)cudaGetLastError();
}

extern "C" int torcwa_ms_chase_c64(void* H, int n, void* U, int a, int wb,
                                   int tcur, int t_end, int lo, int hi, int m,
                                   const void* shifts, void* xy,
                                   void* stream) {
  if (m < 1 || m > kMaxM || wb < 1 || wb > kMaxW || a < 0 || a + wb > n)
    return (int)cudaErrorInvalidValue;
  // the window fits the 227 KB of shared memory up to wb = 169
  const size_t smem = (size_t)wb * (wb + 1) * sizeof(float2);
  const int staged = smem <= kMaxChaseSmem;
  if (staged) {
    cudaError_t err = set_smem(ms_chase, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ms_chase<<<1, kChaseThreads, staged ? smem : 0, (cudaStream_t)stream>>>(
      (float2*)H, n, (float2*)U, a, wb, tcur, t_end, lo, hi, m,
      (const float2*)shifts, (float2*)xy, staged);
  return (int)cudaGetLastError();
}

extern "C" int torcwa_ms_apply_left_c64(void* X, int ldx, int a, int w, int c0,
                                        int c1, const void* P, int ldp,
                                        void* stream) {
  if (w < 1 || w > kMaxW) return (int)cudaErrorInvalidValue;
  if (c1 <= c0) return 0;
  cudaError_t err = set_smem(ms_apply_left, gemm_smem(w));
  if (err != cudaSuccess) return (int)err;
  ms_apply_left<<<(c1 - c0 + kStrip - 1) / kStrip, kGemmThreads, gemm_smem(w),
                  (cudaStream_t)stream>>>((float2*)X, ldx, a, w, c0, c1,
                                          (const float2*)P, ldp);
  return (int)cudaGetLastError();
}

extern "C" int torcwa_ms_apply_right_c64(void* X, int ldx, int r0, int r1,
                                         int a, int w, const void* P, int ldp,
                                         void* stream) {
  if (w < 1 || w > kMaxW) return (int)cudaErrorInvalidValue;
  if (r1 <= r0) return 0;
  cudaError_t err = set_smem(ms_apply_right, gemm_smem(w));
  if (err != cudaSuccess) return (int)err;
  ms_apply_right<<<(r1 - r0 + kStrip - 1) / kStrip, kGemmThreads,
                   gemm_smem(w), (cudaStream_t)stream>>>(
      (float2*)X, ldx, r0, r1, a, w, (const float2*)P, ldp);
  return (int)cudaGetLastError();
}
