// Shared helpers of the eig kernels: complex64 arithmetic on interleaved
// float2 (x = real, y = imaginary, the layout of torch.complex64) and
// block-wide reductions, and the deflation test, Givens rotation and
// Wilkinson shift the QR kernels share.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define TORCWA_EPS_F32 1.1920929e-07f
#define TORCWA_SMLNUM_F32 1e-31f

__device__ __forceinline__ float2 c_make(float re, float im) {
  return make_float2(re, im);
}
__device__ __forceinline__ float2 c_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 c_sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 c_scale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}
// a * b
__device__ __forceinline__ float2 c_mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// conj(a) * b
__device__ __forceinline__ float2 c_cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}
// a * conj(b)
__device__ __forceinline__ float2 c_mulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}
__device__ __forceinline__ float c_abs2(float2 a) {
  return a.x * a.x + a.y * a.y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the block; every thread gets the result.  `red` is a
// shared buffer of at least 33 floats.  Contains barriers: call from all
// threads.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < nw ? red[lane] : (kMax ? -INFINITY : 0.f);
    t = kMax ? warp_max(t) : warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();  // red may be reused right after
  return r;
}

// Max of an int over the block; every thread gets the result.  `red` is a
// shared buffer of at least 33 ints.  Contains barriers.
__device__ __forceinline__ int block_max_int(int v, int* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? red[lane] : 0;
    for (int o = 16; o > 0; o >>= 1)
      t = max(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const int r = red[32];
  __syncthreads();
  return r;
}

// Subdiagonal entry `sub` between the diagonal entries d0, d1 is alive
// (not deflated): |sub| > max(mult eps (|d0| + |d1|), 1e-31).
__device__ __forceinline__ bool sub_alive(float2 d0, float2 d1, float2 sub,
                                          float mult) {
  const float th = fmaxf(mult * TORCWA_EPS_F32 *
                             (sqrtf(c_abs2(d0)) + sqrtf(c_abs2(d1))),
                         TORCWA_SMLNUM_F32);
  return c_abs2(sub) > th * th;
}

struct Givens {
  float c;
  float2 s;
};

// The unscaled formula of givens().
__device__ __forceinline__ Givens givens_unscaled(float2 x, float2 y) {
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

// givens_unscaled of x and y scaled by the power of two that brings their
// largest part into [0.5, 1).  Out of line: the chases that wait on
// givens() take it almost never, and inlined it slows them.
static __device__ __noinline__ Givens givens_scaled(float2 x, float2 y) {
  const float mx = fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)),
                         fmaxf(fabsf(y.x), fabsf(y.y)));
  if (!(mx > 0.f)) return givens_unscaled(x, y);
  int e;
  frexpf(mx, &e);
  // 2^-e in two factors: for mx below 2^-128 it overflows a float
  const float f1 = ldexpf(1.f, -e / 2), f2 = ldexpf(1.f, -e - (-e / 2));
  return givens_unscaled(c_scale(f2, c_scale(f1, x)),
                         c_scale(f2, c_scale(f1, y)));
}

// [[c, s], [-conj(s), c]] [x; y] = [r; 0], c real.  Where |x|^2 + |y|^2
// falls below 2^-120, near or past the bottom of float's normal range
// (2^-126), the rotation is formed again by givens_scaled: the scaling is
// exact, and the rotation stays unitary there (unscaled, the squares keep
// a few bits and c^2 + |s|^2 misses 1 by as much as ~1e-2).  The test
// reads the sum the unscaled formula has already formed.
__device__ __forceinline__ Givens givens(float2 x, float2 y) {
  Givens g = givens_unscaled(x, y);
  if (__builtin_expect(c_abs2(x) + c_abs2(y) < 0x1p-120f, 0))
    g = givens_scaled(x, y);
  return g;
}

// The rotation of givens() formed in double precision and rounded to float,
// as the plain versions form the AED window QR's rotations
// (ops/schur_ms.py: _givens_scalar): c^2 + |s|^2 is then 1 to the rounding
// of c and s alone.
__device__ __forceinline__ Givens givens_rounded(float2 x, float2 y) {
  const double xr = x.x, xi = x.y, yr = y.x, yi = y.y;
  const double ax2 = xr * xr + xi * xi, ay2 = yr * yr + yi * yi;
  const double dn = sqrt(ax2 + ay2), ax = sqrt(ax2);
  Givens g;
  g.c = 1.f;
  g.s = c_make(0.f, 0.f);
  if (ax2 == 0.0 && ay2 > 0.0) {
    g.c = 0.f;
    g.s = c_make(1.f, 0.f);
  } else if (ax > 0.0 && dn > 0.0) {
    const double den = ax * dn;
    g.c = (float)(ax / dn);
    g.s = c_make((float)((xr * yr + xi * yi) / den),
                 (float)((xi * yr - xr * yi) / den));
  }
  return g;
}

// Eigenvalue of [[a, b], [c, d]] closest to d, with the stall-gated sign
// of the discriminant's imaginary part.
__device__ __forceinline__ float2 wilkinson(float2 a, float2 b, float2 c,
                                            float2 d, bool stalled) {
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

// One 8-byte copy from device to shared memory that does not pass through
// registers (cp.async, cached in L1); a group is closed by cp_async_commit
// and awaited, all but the newest N groups, by cp_async_wait<N>.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Allow more than 48 KB of dynamic shared memory when a size needs it.
template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
