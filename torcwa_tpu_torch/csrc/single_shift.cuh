// What the batched single-shift QR kernels share: the rule sets of the three
// TPU kernels they replace, and the start of a sweep (deflation flags, the
// alive runs, each run's shift), so that the rule sets cannot drift apart in
// what they have in common.  The kernels differ in how H and Z are stored
// (schur_qr.cu: interleaved complex64, Z plain; schur_qr_packed.cu: planar
// re | im rows, Z transposed), so the matrix is read through an accessor
// `at(i, j)` that returns entry (i, j) of H as a float2.
#pragma once

#include "common.cuh"

constexpr int kExcEvery = 13;

// The TPU kernels' rules; ops/eig_kernels.py and ops/schur_qr_packed.py hold
// the same values for the plain versions.  eig_qr_pallas._kernel_acc (_NRUNS,
// _DEFL_MULT, _CPLX_STALL):
struct AccRules {
  static constexpr int kRuns = 4;
  static constexpr float kDeflMult = 4.f;
  static constexpr int kCplxStall = 30;
};
// eig_qr_pallas._kernel, the v2 QR: one window, multiplier 1, no stall gate
struct V2Rules {
  static constexpr int kRuns = 1;
  static constexpr float kDeflMult = 1.f;
  static constexpr int kCplxStall = 0;
};
// attic/eig_qr_pallas_packed._kernel_packed: _kernel_acc's windows and stall
// gate with the deflation threshold eps (|d| + |d'|) (multiplier 1)
struct PackedRules {
  static constexpr int kRuns = 4;
  static constexpr float kDeflMult = 1.f;
  static constexpr int kCplxStall = 30;
};

// The runs of one sweep, bottom-most first, in shared memory.
template <typename R>
struct SweepPlan {
  int lo[R::kRuns], hi[R::kRuns];
  float2 shift[R::kRuns];
  int nr;   // runs of this sweep
  int hi0;  // the window bottom after this sweep's deflation scan
};

// The largest i < from with (alive[i] != 0) == want, or -1: 32 flags a
// step down from `from`, by the calling warp (the result is warp-uniform).
__device__ __forceinline__ int last_flag(const unsigned char* alive, int from,
                                         bool want) {
  const int lane = threadIdx.x & 31;
  for (int base = from - 32; base > -32; base -= 32) {
    const int i = base + lane;
    const unsigned hit =
        __ballot_sync(0xffffffffu, i >= 0 && (alive[i] != 0) == want);
    if (hit) return base + 31 - __clz(hit);
  }
  return -1;
}

// Start of sweep `it` on the window [0, hi]: all threads compute the
// deflation flags alive[c] (subdiagonal c+1, c) on the live prefix, warp 0
// scans them for the new window bottom, up to R::kRuns alive runs and their
// Wilkinson shifts (the bottom run takes the exceptional shift d + 0.75 |sub|
// every kExcEvery-th sweep; an exactly real discriminant takes the complex
// branch only after R::kCplxStall sweeps without progress).  `stall` and
// `rot` (rotations this lane will have applied) are warp 0's, the same in
// each of its lanes.  Contains barriers: call from all threads; the plan is
// complete on return.
template <typename R, typename At>
__device__ __forceinline__ void plan_sweep(At at, int hi, int it, int& stall,
                                           int& rot, unsigned char* alive,
                                           SweepPlan<R>& plan) {
  const int tid = threadIdx.x;
  for (int c = tid; c < hi; c += blockDim.x) {
    const float d0 = sqrtf(c_abs2(at(c, c)));
    const float d1 = sqrtf(c_abs2(at(c + 1, c + 1)));
    const float th =
        fmaxf(R::kDeflMult * TORCWA_EPS_F32 * (d0 + d1), TORCWA_SMLNUM_F32);
    alive[c] = c_abs2(at(c + 1, c)) > th * th;
  }
  __syncthreads();
  if (tid < 32) {
    const int h = last_flag(alive, hi, true) + 1;
    stall = h < hi ? 0 : stall + 1;
    if (tid == 0) plan.hi0 = h;
    int nr = 0, top = h;
    for (int r = 0; r < R::kRuns; ++r) {
      const int hr = r > 0 ? last_flag(alive, top - 1, true) + 1 : top;
      if (hr <= 0) break;
      const int lo = last_flag(alive, hr, false) + 1;
      const float2 a = at(hr - 1, hr - 1);
      const float2 b = at(hr - 1, hr);
      const float2 c = at(hr, hr - 1);
      const float2 d = at(hr, hr);
      float2 sh = wilkinson(a, b, c, d, stall >= R::kCplxStall);
      if (r == 0 && (it % kExcEvery) == kExcEvery - 1)
        sh = c_make(d.x + 0.75f * sqrtf(c_abs2(c)), d.y);
      if (tid == 0) {
        plan.lo[nr] = lo;
        plan.hi[nr] = hr;
        plan.shift[nr] = sh;
      }
      rot += hr - lo;
      ++nr;
      top = lo;
    }
    if (tid == 0) plan.nr = nr;
  }
  __syncthreads();
}
