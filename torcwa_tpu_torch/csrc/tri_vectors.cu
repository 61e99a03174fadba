// Eigenvectors of a batch of upper-triangular Schur factors T: the unit
// upper-triangular Y with T Y = Y diag(lambda), lambda = diag(T).
//
// Replaces the TPU kernel torcwa_tpu/ops/eig_qr_pallas.py::_kernel_vec
// (public entry eig_tri_vectors_pallas).  Back substitution from the
// bottom: for every column m and j = m-1 .. 0,
//     y[j, m] = -( sum_{j < l <= m} T[j, l] y[l, m] ) / D[j, m],
// D[j, m] = lambda_j - lambda_m floored in modulus at
// dmin_m = max(eps max(|lambda_m|, ||T||_1), 1e-31) (LAPACK-style pivot
// guard; an exactly zero D becomes dmin_m).  V = Z Y and the column
// normalisation run outside the kernel as a plain batched matmul.
//
// Two kernels, chosen by n in the C entry point (ops/eig_kernels.py:
// tri_vectors_slots mirrors the choice):
//
// * tri_vectors_warp_kernel<kS>, n <= 32 kMaxSlots: a warp per column m,
//   the recurrence by columns, the scheme of tri_vectors_blocked.cu over
//   the whole triangle.  Lane L keeps the running sums s_i of the rows
//   i = L, L + 32, ... < m in registers (kS compile-time slots), seeded
//   with T[i, m] (Y's unit entry), and r_i = conj(D_i) / |D_i|^2 of the
//   floored pivot.  For i = m-1 down to 0 the lane that owns row i forms
//   y_i = -s_i r_i (the plain version divides by |D_i|^2 instead: y_i
//   parts from it by a rounding), writes it and broadcasts it with a
//   shuffle, and every lane adds T[l, i] y_i into its rows l < i: the sums
//   of the row-oriented recurrence, taken in descending l.  Each step
//   loads the next step's column of T while its y is formed, so the chain
//   of a step is one complex product, the shuffle and the sums.  No
//   barrier.  A pre-pass (tri_pack_kernel, a block per matrix and 32
//   columns) writes T's upper triangle packed by columns (column i at
//   i (i + 1) / 2) into scratch, so a warp reads a column of T on
//   consecutive addresses (L2-resident, shared through L1 by the warps of
//   a CTA, which work neighbouring columns of one matrix), and the largest
//   column sum of |T| of each 32 columns, of which the warp takes the
//   largest: ||T||_1.  The grid spans B x n columns over every SM, longest
//   columns first.
// * tri_vectors_kernel, larger n: one thread block per matrix, a thread
//   per column, T's row j staged in shared memory, a block barrier per
//   row j.
//
// What bounds it on an H100: each column's chain of m dependent steps
// (one complex product by one lane, one shuffle, up to m / 32 complex
// FMAs a lane), ~n^3/6 complex multiply-adds in all, a few MFLOP: the
// latency of the longest chain, 337 steps at n = 338, not bandwidth or
// arithmetic (0.11-0.16 ms at B = 1 and 8, n = 338, ~0.3 us a step, on
// an NVIDIA H100 80GB HBM3 at 700 W: PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// the warp kernel: warps a CTA, and register slots of row sums a lane
// (n <= 32 kMaxSlots), compiled in steps of kSlotStep
constexpr int kVWarps = 4;
constexpr int kMaxSlots = 20;
constexpr int kSlotStep = 4;

__global__ void __launch_bounds__(kThreads)
tri_vectors_kernel(const float2* __restrict__ T, float2* __restrict__ Y,
                   int n) {
  extern __shared__ float2 sh[];
  float2* lam = sh;                            // diag(T)
  float2* trow = sh + n;                       // T[j, :]
  float* dmin = reinterpret_cast<float*>(sh + 2 * n);
  __shared__ float red[33];

  const size_t off = (size_t)blockIdx.x * n * n;
  T += off;
  Y += off;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * n; e += kThreads)
    Y[e] = c_make((e / n == e % n) ? 1.f : 0.f, 0.f);

  // ||T||_1 = max column sum of |T|
  float cmax = 0.f;
  for (int m = tid; m < n; m += kThreads) {
    lam[m] = T[(size_t)m * n + m];
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += sqrtf(c_abs2(T[(size_t)i * n + m]));
    cmax = fmaxf(cmax, s);
  }
  const float tnorm = block_reduce<true>(cmax, red);
  for (int m = tid; m < n; m += kThreads)
    dmin[m] = fmaxf(TORCWA_EPS_F32 * fmaxf(sqrtf(c_abs2(lam[m])), tnorm),
                    TORCWA_SMLNUM_F32);
  __syncthreads();

  for (int j = n - 2; j >= 0; --j) {
    for (int l = tid; l < n; l += kThreads) trow[l] = T[(size_t)j * n + l];
    __syncthreads();
    const float2 lj = lam[j];
    for (int m = tid; m < n; m += kThreads) {
      if (m <= j) continue;
      float2 s = c_make(0.f, 0.f);
      for (int l = j + 1; l <= m; ++l)
        s = c_add(s, c_mul(trow[l], Y[(size_t)l * n + m]));
      float2 d = c_sub(lj, lam[m]);
      const float dabs = sqrtf(c_abs2(d));
      const float dm = dmin[m];
      if (dabs < dm) {
        if (dabs > 0.f) d = c_scale(dm / dabs, d);
        else d = c_make(dm, 0.f);
      }
      float dden = c_abs2(d);
      if (!(dden > 0.f)) dden = 1.f;
      Y[(size_t)j * n + m] = c_make(-(s.x * d.x + s.y * d.y) / dden,
                                    -(s.y * d.x - s.x * d.y) / dden);
    }
    __syncthreads();  // trow is overwritten next step
  }
}

__device__ __forceinline__ size_t tri_col(int i) {
  return (size_t)i * (i + 1) / 2;
}

// T's upper triangle packed by columns, tri[tri_col(m) + i] = T[i, m] for
// i <= m, and the largest column sum of |T| over each tile of 32 columns,
// tmax[b * tiles + tile] (||T||_1 is the largest of a matrix's tiles).  A
// block of 32 warps per tile: warp w reads rows w, w + 32, ..., lane L
// column 32 tile + L, and the 32 partial sums of a column are added in
// warp order.
__global__ void __launch_bounds__(1024)
tri_pack_kernel(const float2* __restrict__ T, float2* __restrict__ tri,
                float* __restrict__ tmax, int n) {
  __shared__ float part[32][33];
  const int tiles = (n + 31) / 32;
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = 32 * tile + lane;
  T += (size_t)b * n * n;
  tri += (size_t)b * tri_col(n);
  float s = 0.f;
  if (m < n) {
    for (int i = warp; i < n; i += 32) {
      const float2 t = __ldg(T + (size_t)i * n + m);
      s += sqrtf(c_abs2(t));
      if (i <= m) tri[tri_col(m) + i] = t;
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float c = 0.f;
    for (int w = 0; w < 32; ++w) c += part[w][lane];
    c = warp_max(c);
    if (lane == 0) tmax[(size_t)b * tiles + tile] = c;
  }
}

// The steps i = 32 Q + l, l from lmax down to 0: rows of slot Q; then the
// slots below.  On entry tn holds column i of T (rows 32 q + lane < i,
// q <= Q) for the first step; each step loads the next one's column while
// its own y is formed and broadcast.
template <int Q, int kS>
__device__ __forceinline__ void slots(float2 (&s)[kS], const float2 (&r)[kS],
                                      float2 (&tn)[kS],
                                      const float2* __restrict__ tri,
                                      float2* __restrict__ Y, int n, int m,
                                      int top, int lane) {
  if (32 * Q <= top) {
    const int lmax = min(31, top - 32 * Q);
    for (int l = lmax; l >= 0; --l) {
      const int i = 32 * Q + l;
      float2 tc[Q + 1];
#pragma unroll
      for (int q = 0; q <= Q; ++q) {
        tc[q] = tn[q];
        const int row = 32 * q + lane;
        if (row < i - 1) tn[q] = __ldg(tri + tri_col(i - 1) + row);
      }
      float2 y = c_make(0.f, 0.f);
      if (lane == l) {
        y = c_make(-(s[Q].x * r[Q].x - s[Q].y * r[Q].y),
                   -(s[Q].x * r[Q].y + s[Q].y * r[Q].x));
        Y[(size_t)i * n + m] = y;
      }
      y.x = __shfl_sync(0xffffffffu, y.x, l);
      y.y = __shfl_sync(0xffffffffu, y.y, l);
#pragma unroll
      for (int q = 0; q <= Q; ++q) {
        const int row = 32 * q + lane;
        if (row < i) s[q] = c_add(s[q], c_mul(tc[q], y));
      }
    }
  }
  if constexpr (Q > 0) slots<Q - 1, kS>(s, r, tn, tri, Y, n, m, top, lane);
}

template <int kS>
__global__ void __launch_bounds__(32 * kVWarps)
tri_vectors_warp_kernel(const float2* __restrict__ tri,
                        const float* __restrict__ tmax,
                        float2* __restrict__ Y, int n, int batch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x % batch;
  const int m = n - 1 - ((blockIdx.x / batch) * kVWarps + warp);
  if (m < 0) return;
  const int tiles = (n + 31) / 32;
  tri += (size_t)b * tri_col(n);
  Y += (size_t)b * n * n;
  for (int i = m + lane; i < n; i += 32)
    Y[(size_t)i * n + m] = c_make(i == m ? 1.f : 0.f, 0.f);
  if (m == 0) return;
  const float tnorm =
      warp_max(lane < tiles ? tmax[(size_t)b * tiles + lane] : 0.f);
  const float2 lm = tri[tri_col(m) + m];
  const float dm = fmaxf(TORCWA_EPS_F32 * fmaxf(sqrtf(c_abs2(lm)), tnorm),
                         TORCWA_SMLNUM_F32);
  // s: the row sums, seeded with T[i, m] y_m (y_m = 1); r = conj(D) /
  // |D|^2 of the floored pivot, so that y_i = -s_i r_i; tn: column m - 1
  float2 s[kS], r[kS], tn[kS];
#pragma unroll
  for (int q = 0; q < kS; ++q) {
    const int i = 32 * q + lane;
    s[q] = c_make(0.f, 0.f);
    r[q] = c_make(1.f, 0.f);
    tn[q] = c_make(0.f, 0.f);
    if (i < m) {
      s[q] = tri[tri_col(m) + i];
      float2 dq = c_sub(tri[tri_col(i) + i], lm);
      const float dabs = sqrtf(c_abs2(dq));
      if (dabs < dm) {
        if (dabs > 0.f) dq = c_scale(dm / dabs, dq);
        else dq = c_make(dm, 0.f);
      }
      float dden = c_abs2(dq);
      if (!(dden > 0.f)) dden = 1.f;
      r[q] = c_make(dq.x / dden, -dq.y / dden);
    }
    if (i < m - 1) tn[q] = tri[tri_col(m - 1) + i];
  }
  slots<kS - 1, kS>(s, r, tn, tri, Y, n, m, m - 1, lane);
}

// Register slots the warp kernel takes at n, 0 where n takes the
// one-block kernel.
int slots_of(int n) {
  const int need = (n + 31) / 32;
  if (need > kMaxSlots) return 0;
  return (need + kSlotStep - 1) / kSlotStep * kSlotStep;
}

template <int kS>
int launch_warp(const void* T, void* Y, void* tri, void* tmax, int batch,
                int n, cudaStream_t stream) {
  tri_pack_kernel<<<batch * ((n + 31) / 32), 1024, 0, stream>>>(
      (const float2*)T, (float2*)tri, (float*)tmax, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int grid = batch * ((n + kVWarps - 1) / kVWarps);
  tri_vectors_warp_kernel<kS><<<grid, 32 * kVWarps, 0, stream>>>(
      (const float2*)tri, (const float*)tmax, (float2*)Y, n, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// tri: scratch of batch x n (n + 1) / 2 complex64, tmax: batch x
// ceil(n / 32) floats (both unused where n takes the one-block kernel).
extern "C" int torcwa_tri_vectors_c64(const void* T, void* Y, void* tri,
                                      void* tmax, int batch, int n,
                                      void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (slots_of(n)) {
    case 4: return launch_warp<4>(T, Y, tri, tmax, batch, n, s);
    case 8: return launch_warp<8>(T, Y, tri, tmax, batch, n, s);
    case 12: return launch_warp<12>(T, Y, tri, tmax, batch, n, s);
    case 16: return launch_warp<16>(T, Y, tri, tmax, batch, n, s);
    case 20: return launch_warp<20>(T, Y, tri, tmax, batch, n, s);
    default: break;
  }
  const size_t smem = 2 * (size_t)n * sizeof(float2) + (size_t)n * sizeof(float);
  cudaError_t err = set_smem(tri_vectors_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  tri_vectors_kernel<<<batch, kThreads, smem, s>>>(
      (const float2*)T, (float2*)Y, n);
  return (int)cudaGetLastError();
}

// Register slots of the kernel torcwa_tri_vectors_c64 launches at n (0: the
// one-block kernel).
extern "C" int torcwa_tri_vectors_slots(int n) { return slots_of(n); }
