// Windowed multishift Schur QR with aggressive early deflation (AED) for a
// batch of large upper Hessenberg matrices, each on its own: H = Z T Z^H, H
// and Z in device memory.
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
// or a few times per sweep and reads `info` back once per sweep.  The lanes
// of a batch (its matrices) go through the loop in lock step: each launch
// covers every lane that takes that step of the sweep, one block (or one
// lane's strips of the slab products) a lane, as listed in the launch's
// lane table (Lanes), which carries the host's per-lane decisions by value
// among the launch's parameters.  So the lanes' serial kernels run side by
// side on as many SMs and one read of `info` a sweep serves them all; a
// lane's blocks do what its own launch would do, operation for operation.
// Lanes that need another template, or more than kMaxLanes of them, take
// launches of their own, so each entry point reports in *launches the
// kernels it launched.
//
// Not carried over, because they exist only for the TPU's compiler: the
// padding to multiples of 128, the (1, T, 128) band layout, the one-hot
// selection matmuls, the split-real pairs and Z^T storage, the deferred
// invariant M = B U^T with its local chase block and parked-bump mask.
// Rotations are applied to H directly, so bulges simply stay in H between
// windows; H, Z and the small unitaries are complex64, row-major.
//
// Design for an H100:
//  * ms_band_scan: one block a lane; two integer max-reductions over the
//    band.
//  * ms_aed: one block of four warps a lane, the window W in the bordered
//    matrix [spike | T] and its Schur vectors in the accumulated transform,
//    in shared memory (68,632 bytes at kw = 64; aed_warp.cuh).  Warp 0 chases
//    the window's single-shift QR, warp 1 forms each rotation one ahead of
//    it, warps 2-3 apply a sweep's rotations to the Schur vectors a sweep
//    behind.  It writes the transformed diagonal block and spike column
//    back to H itself, with the known zeros exact, the kwe x kwe transform
//    Lp for the off-diagonal slabs, and adds the window QR's rotations to a
//    running count in `info`.
//  * ms_trailing_shifts (aed=False): one warp a lane, the m x m block in
//    shared memory; it fills `info` and `shifts` where ms_aed would.
//  * ms_chase: one block per window and lane; a window of up to 169 rows is
//    staged in shared memory for the chase and written back at its end, a
//    wider one is worked in device memory.  At a step the m rotations touch
//    disjoint row pairs and disjoint column pairs and their parameters are
//    known from the step before, so all row rotations of the H window run
//    in parallel, then all column rotations: three barriers per step.  A
//    warp takes a bulge and its lanes the contiguous run of the row pair
//    (column pair) the rotation touches, a few pairs loaded before any is
//    stored, so that an element costs a few adds of index arithmetic and
//    no thread waits on elements it does not rotate.  Row rotations cover
//    columns >= max(k - 1, lo) only, so that a bump created by a trailing
//    bulge is never smeared by the bulge ahead of it.
//    The step loop rotates H alone and records each rotation (c, s) in
//    shared memory; the window's accumulated unitary U, the product of
//    those row rotations in order, is formed after the last step by all
//    threads, a column and a share of each step's bulges a thread, one
//    barrier a step (columns of U are independent under row rotations),
//    with the row phase's expressions in the chase's order: the bits U
//    gets when a step loop carries it.
//  * ms_apply_slabs: the small unitary P times the slabs of H and Z it
//    transforms, in place, one launch per applied window or AED transform
//    (left on H's columns right of the window, right on H's rows above it
//    and on all of Z's), in IEEE f32 FFMA: a block owns a strip of 32
//    columns (rows) of one slab, stages all of it in shared memory before
//    it writes any of it, takes P in double-buffered tiles by cp.async and
//    keeps a register tile of up to 8 x 4 outputs a thread.
//
// What bounds it on an H100: the chase runs in one block a lane, so on one
// SM a lane.
// Worked in device memory a step moves ~m (2 wb x 32 B in the row phase +
// wb x 128 B in the column phase, whose 16-byte accesses fetch whole
// 32-byte sectors), ~0.5 MB at m = 24, wb = 128; hence the narrow window
// staged in shared memory, where the step loop touches nothing else and a
// step is bound by its three barriers and the latency of its dependent
// shared-memory loads.  U is formed once per window after the loop (steps
// x m row pairs of wb elements), a sizeable share of a window at wb =
// 128, where all threads with a barrier a step beat one thread per column
// without barriers.  AED is the serial mini-Schur in one
// block, a chain of rotations whose forming in double precision sets its
// pace.  The slab products are the only throughput part (~2 n wb^2
// complex multiply-adds per window, 0.86 GFLOP at n = 3362, wb = 128: 13
// us at the 67 TFLOP/s FFMA rate), ~200 strips of 32 at that size, 1.5
// a streaming multiprocessor.

#include <algorithm>

#include "aed_warp.cuh"
#include "ms_shifts.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kAedThreads = 128;
constexpr int kChaseThreads = 1024;
constexpr int kChaseWarps = kChaseThreads / 32;
constexpr int kStepBatch = 4;  // rotated pairs a lane loads before it stores
constexpr size_t kMaxChaseSmem = 225 * 1024;  // dynamic, beside ~2 KB static
constexpr int kMaxM = 64;     // shifts per sweep
constexpr int kMaxKw = kAedMaxKw;  // AED window
constexpr int kMaxW = 256;    // order of a slab transform (chase window)

// A launch's lanes: entry e works on matrix v[e][0] of the batch with the
// kernel's own parameters in v[e][1..]; the host fills the table and it
// travels by value among the launch's parameters (read in place, never
// copied to local memory: __grid_constant__), so no copy precedes a launch.
// A batch's matrices (H, Z) and each lane's scratch follow one another in
// memory.  The C entry points take the entries from a host array and
// launch kMaxLanes of them at a time.
constexpr int kMaxLanes = 32;
constexpr int kLaneFields = 8;
struct Lanes {
  int count;
  int v[kMaxLanes][kLaneFields];
};

// info[]: what the host reads back once per sweep (the first five), and
// the AED window QR's rotations summed over the launches (ops/schur_ms.py
// mirrors I_ROT and I_COUNT)
enum { I_LO = 0, I_HI, I_S, I_KWE, I_HINEW, I_KU, I_HIM, I_MINI_IT, I_ROT,
       I_COUNT };

// ---------------------------------------------------------------------------
// band scan
// ---------------------------------------------------------------------------

// block e: lane v[e][0], its active block at or above hi_top = v[e][1]
__global__ void __launch_bounds__(kScanThreads)
ms_band_scan(const float2* __restrict__ Hb, int n,
             const __grid_constant__ Lanes lanes, float defl_mult,
             int* __restrict__ info_b) {
  __shared__ int red[33];
  const int tid = threadIdx.x, lane = lanes.v[blockIdx.x][0];
  const int hi_top = lanes.v[blockIdx.x][1];
  const float2* const H = Hb + (size_t)lane * n * n;
  int* const info = info_b + lane * I_COUNT;
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

// The AED body is aed_window_warp of aed_warp.cuh with its rotations formed
// ahead of the chase (schur_qr_baed.cu runs it with the one-warp schedule,
// inside its own sweep loop); this launch adds what the host loop needs: the
// kwe x kwe transform Lp for the slab products and the info record.  Block
// e: lane v[e][0], an exceptional sweep where v[e][1] != 0; a lane's Lp
// takes kw x kw elements, its shifts m.
__global__ void __launch_bounds__(kAedThreads)
ms_aed(float2* __restrict__ Hb, int n, int* __restrict__ info_b,
       const __grid_constant__ Lanes lanes, int m, int kw, float defl_mult,
       float2* __restrict__ Lp_b, float2* __restrict__ shifts_b) {
  extern __shared__ float2 sm[];
  const int tid = threadIdx.x, lane = lanes.v[blockIdx.x][0];
  const int exc = lanes.v[blockIdx.x][1];
  float2* const H = Hb + (size_t)lane * n * n;
  int* const info = info_b + lane * I_COUNT;
  float2* const Lp = Lp_b + (size_t)lane * kw * kw;
  float2* const shifts = shifts_b + (size_t)lane * m;
  const int lo = info[I_LO], hi = info[I_HI];
  if (hi <= 0) {
    if (tid == 0) {
      info[I_S] = 0; info[I_KWE] = 0; info[I_HINEW] = 0; info[I_KU] = 0;
      info[I_HIM] = 0; info[I_MINI_IT] = 0;
    }
    return;
  }
  auto hat = [&](int i, int j) { return H + (size_t)i * n + j; };
  const AedResult r = aed_window_warp<kAedThreads, 0, true>(
      hat, n, lo, hi, exc != 0, m, kw, defl_mult, false, sm, shifts,
      info + I_ROT);
  const float2* L = sm + aed_warp_L_offset(kw);
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

// block e: lane v[e][0], an exceptional sweep where v[e][1] != 0
__global__ void __launch_bounds__(32)
ms_trailing_shifts(const float2* __restrict__ Hb, int n,
                   int* __restrict__ info_b,
                   const __grid_constant__ Lanes lanes, int m,
                   float2* __restrict__ shifts_b) {
  extern __shared__ float2 sm[];
  const int lane = lanes.v[blockIdx.x][0], exc = lanes.v[blockIdx.x][1];
  const float2* const H = Hb + (size_t)lane * n * n;
  int* const info = info_b + lane * I_COUNT;
  float2* const shifts = shifts_b + (size_t)lane * m;
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

// One rotation G = [[c, s], [-conj(s), c]] on the pair (xk, x1) from the
// left, as (top, bottom): the H chase's row phase and the window unitary's
// formation share it, so U gets the same bits whichever of the two
// accumulates it.
__device__ __forceinline__ float2 rot_top(float c, float2 sg, float2 xk,
                                          float2 x1) {
  return c_add(c_scale(c, xk), c_mul(sg, x1));
}
__device__ __forceinline__ float2 rot_bottom(float c, float2 sg, float2 xk,
                                             float2 x1) {
  return c_sub(c_scale(c, x1), c_cmul(sg, xk));
}

// The window unitary U (wb x wb, leading dimension wb, in shared or device
// memory) from the rotations the chase recorded: rc / rs hold step t's
// rotation of bulge i at (t - tcur) m + i.  A column of U is independent
// of the others under row rotations and the rotations of a step touch
// disjoint row pairs, so thread (j, g) forms column j for the bulges
// i = g mod G of each step, G = kChaseThreads / wb groups side by side,
// a barrier between steps; a thread issues the loads of up to kFormBatch
// rotations before it stores any.  Call from all threads.
constexpr int kFormBatch = 4;

__device__ __forceinline__ void form_window_unitary(
    float2* U, int tid, int a, int wb, int tcur, int t_end, int lo, int hi,
    int m, const float* rc, const float2* rs) {
  for (int e = tid; e < wb * wb; e += kChaseThreads)
    U[e] = c_make(e / wb == e % wb ? 1.f : 0.f, 0.f);
  __syncthreads();
  const int G = kChaseThreads / wb, j = tid % wb, g = tid / wb;
  // bulge i is valid where lo + 2 i + 1 <= hi
  const int i_valid = hi > lo ? min(m, (hi - lo - 1) / 2 + 1) : 0;
  for (int t = tcur; t <= t_end; ++t) {
    // bulge i is active where lo <= t - 2 i < hi
    const int i0 = max(0, (t - hi + 2) / 2);
    const int i1 = min(i_valid, (t - lo) / 2 + 1);
    const float* c_t = rc + (size_t)(t - tcur) * m;
    const float2* s_t = rs + (size_t)(t - tcur) * m;
    if (g < G)
      for (int ib = i0 + g; ib < i1; ib += G * kFormBatch) {
        float2 uk[kFormBatch], u1[kFormBatch];
#pragma unroll
        for (int q = 0; q < kFormBatch; ++q) {
          const int k = t - 2 * (ib + G * q);
          if (ib + G * q < i1) {
            uk[q] = U[(size_t)(k - a) * wb + j];
            u1[q] = U[(size_t)(k + 1 - a) * wb + j];
          }
        }
#pragma unroll
        for (int q = 0; q < kFormBatch; ++q) {
          const int i = ib + G * q, k = t - 2 * i;
          if (i < i1) {
            const float c = c_t[i];
            const float2 sg = s_t[i];
            U[(size_t)(k - a) * wb + j] = rot_top(c, sg, uk[q], u1[q]);
            U[(size_t)(k + 1 - a) * wb + j] = rot_bottom(c, sg, uk[q], u1[q]);
          }
        }
      }
    __syncthreads();
  }
}

// Hw points at the window's top-left entry, with leading dimension ldh:
// into H itself (ldh = n), or, when kStaged, into a copy of the window in
// shared memory (ldh = wb + 1) that is written back at the end.  The step
// loop rotates H alone and records each step's rotations in shared memory
// after the window (rs, then rc); U is formed from them at the end, in the
// window's shared memory when staged, else in U itself.  kStaged is a
// template parameter so that the staged kernel's accesses compile to
// shared-memory instructions.  Block e: lane v[e][0], the window (a, wb,
// tcur, t_end) = v[e][1..4] on the active block (lo, hi) = v[e][5..6]; a
// lane's U lies us elements after the one before, its shifts m, its carries
// 2m.
template <bool kStaged>
__global__ void __launch_bounds__(kChaseThreads)
ms_chase(float2* __restrict__ Hb, int n, float2* __restrict__ Ub, size_t us,
         const __grid_constant__ Lanes lanes, int m,
         const float2* __restrict__ shifts_b, float2* __restrict__ xy_b) {
  extern __shared__ float2 sm[];
  __shared__ float2 s_x[kMaxM], s_y[kMaxM];
  __shared__ unsigned char s_act[kMaxM];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* const p = lanes.v[blockIdx.x];
  const int a = p[1], wb = p[2], tcur = p[3], t_end = p[4], lo = p[5],
            hi = p[6];
  float2* const H = Hb + (size_t)p[0] * n * n;
  float2* const U = Ub + (size_t)p[0] * us;
  const float2* const shifts = shifts_b + (size_t)p[0] * m;
  float2* const xy = xy_b + (size_t)p[0] * 2 * m;
  float2* const Hg = H + (size_t)a * n + a;
  float2* const Hw = kStaged ? sm : Hg;
  const int ldh = kStaged ? wb + 1 : n;
  const int nsteps = max(t_end - tcur + 1, 0);
  float2* const rs = sm + (kStaged ? (size_t)wb * ldh : 0);
  float* const rc = (float*)(rs + (size_t)nsteps * m);

  if (kStaged)
    for (int e = tid; e < wb * wb; e += kChaseThreads)
      sm[(e / wb) * ldh + e % wb] = Hg[(size_t)(e / wb) * n + e % wb];
  if (tid < m) {
    s_x[tid] = xy[tid];
    s_y[tid] = xy[m + tid];
  }
  __syncthreads();

  for (int t = tcur; t <= t_end; ++t) {
    float* const c_t = rc + (size_t)(t - tcur) * m;
    float2* const s_t = rs + (size_t)(t - tcur) * m;
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
        c_t[i] = g.c;
        s_t[i] = g.s;
      }
    }
    __syncthreads();
    // ---- rows k, k+1: the window's columns >= max(k - 1, lo) of H; a
    // warp per bulge, its lanes along the rows ----
    for (int i = warp; i < m; i += kChaseWarps) {
      if (!s_act[i]) continue;
      const int k = t - 2 * i;
      const float c = c_t[i];
      const float2 sg = s_t[i];
      float2* const rk = Hw + (size_t)(k - a) * ldh;
      const int zap = k > lo ? k - 1 - a : -1;  // H[k+1, k-1] becomes 0
      for (int j0 = max(max(k - 1, lo) - a, 0) + lane; j0 < wb;
           j0 += 32 * kStepBatch) {
        float2 hk[kStepBatch], h1[kStepBatch];
#pragma unroll
        for (int q = 0; q < kStepBatch; ++q) {
          const int jj = j0 + 32 * q;
          if (jj < wb) {
            hk[q] = rk[jj];
            h1[q] = rk[jj + ldh];
          }
        }
#pragma unroll
        for (int q = 0; q < kStepBatch; ++q) {
          const int jj = j0 + 32 * q;
          if (jj < wb) {
            rk[jj] = rot_top(c, sg, hk[q], h1[q]);
            rk[jj + ldh] = jj == zap ? c_make(0.f, 0.f)
                                     : rot_bottom(c, sg, hk[q], h1[q]);
          }
        }
      }
    }
    __syncthreads();
    // ---- columns k, k+1: the window's rows of H up to min(k+2, hi); a
    // warp per bulge, its lanes down the columns ----
    for (int i = warp; i < m; i += kChaseWarps) {
      if (!s_act[i]) continue;
      const int k = t - 2 * i;
      const float c = c_t[i];
      const float2 sg = s_t[i];
      float2* const ck = Hw + (k - a);
      const int r_end = min(min(k + 2, hi) - a + 1, wb);
      for (int r0 = lane; r0 < r_end; r0 += 32 * kStepBatch) {
        float2 l[kStepBatch], rr[kStepBatch];
#pragma unroll
        for (int q = 0; q < kStepBatch; ++q) {
          const int r = r0 + 32 * q;
          if (r < r_end) {
            l[q] = ck[(size_t)r * ldh];
            rr[q] = ck[(size_t)r * ldh + 1];
          }
        }
#pragma unroll
        for (int q = 0; q < kStepBatch; ++q) {
          const int r = r0 + 32 * q;
          if (r < r_end) {
            const float2 nl = c_add(c_scale(c, l[q]), c_cmul(sg, rr[q]));
            ck[(size_t)r * ldh] = nl;
            ck[(size_t)r * ldh + 1] =
                c_sub(c_scale(c, rr[q]), c_mul(sg, l[q]));
            if (a + r == k + 1) {
              s_x[i] = nl;
              if (k + 2 > hi) s_y[i] = c_make(0.f, 0.f);
            }
            if (a + r == k + 2) s_y[i] = nl;
          }
        }
      }
    }
    __syncthreads();
  }
  if (tid < m) {
    xy[tid] = s_x[tid];
    xy[m + tid] = s_y[tid];
  }
  if (!kStaged) {
    form_window_unitary(U, tid, a, wb, tcur, t_end, lo, hi, m, rc, rs);
    return;
  }
  for (int e = tid; e < wb * wb; e += kChaseThreads)
    Hg[(size_t)(e / wb) * n + e % wb] = sm[(e / wb) * ldh + e % wb];
  __syncthreads();  // the window's shared memory now holds U
  form_window_unitary(sm, tid, a, wb, tcur, t_end, lo, hi, m, rc, rs);
  for (int e = tid; e < wb * wb; e += kChaseThreads) U[e] = sm[e];
}

// ---------------------------------------------------------------------------
// slab products with the small unitary P (w x w, leading dimension ldp)
// ---------------------------------------------------------------------------

// One in-place product with P over a range of strips:
//   left:  X[a:a+w, lo:hi] <- P X[a:a+w, lo:hi], a block owns kSlabStrip
//          columns;
//   right: X[lo:hi, a:a+w] <- X[lo:hi, a:a+w] P^H, a block owns kSlabStrip
//          rows.
struct Slab {
  float2* X;
  int ldx, left, lo, hi;
};

constexpr int kSlabThreads = 256;
constexpr int kSlabStrip = 32;                    // columns (rows) a block owns
constexpr int kSlabLd = kSlabStrip + 1;           // of the staged strip
constexpr int kSlabPer = 4;                       // strip entries a thread
constexpr int kSlabTx = kSlabStrip / kSlabPer;    // 8
constexpr int kSlabTy = kSlabThreads / kSlabTx;   // 32; P's rows ty + 32 r
constexpr int kSlabKT = 16;                       // depth of a tile of P

// The three slab products of a transform P (w x w, leading dimension ldp)
// at row a of each lane in one launch (the sizes of a block's strip follow
// RT; the host launches the lanes of each RT apart):
//   X[a:a+w, a+w:n] <- P X[a:a+w, a+w:n]   (H, left)
//   X[0:a, a:a+w]   <- X[0:a, a:a+w] P^H   (H, right)
//   Z[0:nz, a:a+w]  <- Z[0:nz, a:a+w] P^H  (Z, right).
// Entry e: lane v[e][0], (a, w, ldp) = v[e][1..3], its blocks from v[e][4],
// v[e][5..7] on the three slabs in turn; a lane's P lies ps elements after
// the one before, its H n ldh, its Z nz ldz.  A block stages its whole
// strip (w x kSlabStrip, k-major) before it writes any of it, so the
// products are in place; P comes in tiles of kSlabKT columns,
// double-buffered with cp.async, zero past row w.  Thread (tx, ty) keeps a
// register tile of RT rows i = ty + 32 r of P by kSlabPer strip entries j =
// tx + 8 c: each value it loads from shared memory feeds RT or kSlabPer
// complex multiply-adds.  Every output sums over k in ascending order.
template <int RT>
__global__ void __launch_bounds__(kSlabThreads)
ms_apply_slabs(float2* __restrict__ Hb, int ldh, float2* __restrict__ Zb,
               int ldz, int n, int nz, const float2* __restrict__ Pb,
               size_t ps, const __grid_constant__ Lanes lanes) {
  extern __shared__ float2 sm[];
  constexpr int kRows = RT * kSlabTy;
  int ent = 0;  // the lane entry whose blocks hold this one
  while ((int)blockIdx.x >= lanes.v[ent][4] + lanes.v[ent][5] +
                                lanes.v[ent][6] + lanes.v[ent][7])
    ++ent;
  const int* const p = lanes.v[ent];
  const int a = p[1], w = p[2], ldp = p[3], nb0 = p[5], nb1 = p[6];
  float2* const H = Hb + (size_t)p[0] * n * ldh;
  const float2* const P = Pb + (size_t)p[0] * ps;
  const Slab s0 = {H, ldh, 1, a + w, n}, s1 = {H, ldh, 0, 0, a},
             s2 = {Zb + (size_t)p[0] * nz * ldz, ldz, 0, 0, nz};
  float2* const Xs = sm;                          // Xs[k kSlabLd + j]
  float2* const Pt = sm + (size_t)w * kSlabLd;    // [2][kSlabKT][kRows]
  const int b0 = (int)blockIdx.x - p[4];
  const Slab sl = b0 < nb0 ? s0 : (b0 < nb0 + nb1 ? s1 : s2);
  const int b = b0 < nb0 ? b0 : (b0 < nb0 + nb1 ? b0 - nb0 : b0 - nb0 - nb1);
  const int tid = threadIdx.x, tx = tid % kSlabTx, ty = tid / kSlabTx;
  const int j0 = sl.lo + b * kSlabStrip;
  const int ntiles = (w + kSlabKT - 1) / kSlabKT;

  // Pt[q][kk][i] = P[i, k0 + kk]
  auto stage_p = [&](int tile) {
    float2* dst = Pt + (tile & 1) * kSlabKT * kRows;
    const int k0 = tile * kSlabKT;
    for (int e = tid; e < kSlabKT * w; e += kSlabThreads) {
      const int i = e / kSlabKT, kk = e % kSlabKT;
      if (k0 + kk < w)
        cp_async8(dst + kk * kRows + i, P + (size_t)i * ldp + k0 + kk);
    }
  };
  for (int e = tid; e < 2 * kSlabKT * (kRows - w); e += kSlabThreads)
    Pt[(e / (kRows - w)) * kRows + w + e % (kRows - w)] = c_make(0.f, 0.f);
  for (int e = tid; e < w * kSlabStrip; e += kSlabThreads) {
    // coalesced along the slab's rows: j fastest when left, k when right
    const int k = sl.left ? e / kSlabStrip : e % w;
    const int j = sl.left ? e % kSlabStrip : e / w;
    float2* dst = Xs + k * kSlabLd + j;
    if (j0 + j >= sl.hi)
      *dst = c_make(0.f, 0.f);
    else if (sl.left)
      cp_async8(dst, sl.X + (size_t)(a + k) * sl.ldx + j0 + j);
    else
      cp_async8(dst, sl.X + (size_t)(j0 + j) * sl.ldx + a + k);
  }
  stage_p(0);
  cp_async_commit();

  float2 acc[RT][kSlabPer];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < kSlabPer; ++c) acc[r][c] = c_make(0.f, 0.f);
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      stage_p(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float2* pt = Pt + (tile & 1) * kSlabKT * kRows;
    const int k0 = tile * kSlabKT;
#pragma unroll
    for (int kk = 0; kk < kSlabKT; ++kk) {
      if (k0 + kk >= w) break;
      float2 xv[kSlabPer], pv[RT];
#pragma unroll
      for (int c = 0; c < kSlabPer; ++c)
        xv[c] = Xs[(k0 + kk) * kSlabLd + tx + kSlabTx * c];
#pragma unroll
      for (int r = 0; r < RT; ++r) pv[r] = pt[kk * kRows + ty + kSlabTy * r];
      if (sl.left) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < kSlabPer; ++c)
            acc[r][c] = c_add(acc[r][c], c_mul(pv[r], xv[c]));
      } else {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float2 pc = c_make(pv[r].x, -pv[r].y);
#pragma unroll
          for (int c = 0; c < kSlabPer; ++c)
            acc[r][c] = c_add(acc[r][c], c_mul(xv[c], pc));
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = ty + kSlabTy * r;
    if (i >= w) continue;
#pragma unroll
    for (int c = 0; c < kSlabPer; ++c) {
      const int j = j0 + tx + kSlabTx * c;
      if (j >= sl.hi) continue;
      if (sl.left)
        sl.X[(size_t)(a + i) * sl.ldx + j] = acc[r][c];
      else
        sl.X[(size_t)j * sl.ldx + a + i] = acc[r][c];
    }
  }
}

// The error of the launch just made, and one more in *launches if it went.
cudaError_t counted(int* launches) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

// The `count` entries of `rec` (`fields` ints each, from the host) whose
// key(entry) is k, for k = 0 .. nkeys - 1 in turn, kMaxLanes of them a
// launch(k, table); a kind of entry that none has launches nothing.
template <class Key, class Launch>
cudaError_t over_lanes(const int* rec, int count, int fields, int nkeys,
                       Key key, Launch launch) {
  if (count < 0 || fields < 1 || fields > kLaneFields)
    return cudaErrorInvalidValue;
  for (int k = 0; k < nkeys; ++k) {
    Lanes t;
    t.count = 0;
    for (int e = 0; e <= count; ++e) {
      if (t.count == kMaxLanes || (e == count && t.count > 0)) {
        const cudaError_t err = launch(k, t);
        if (err != cudaSuccess) return err;
        t.count = 0;
      }
      if (e == count || key(rec + (size_t)e * fields) != k) continue;
      for (int f = 0; f < kLaneFields; ++f)
        t.v[t.count][f] = f < fields ? rec[(size_t)e * fields + f] : 0;
      ++t.count;
    }
  }
  return cudaSuccess;
}

int one_kind(const int*) { return 0; }

}  // namespace

// rec: (lane, hi_top) a lane
extern "C" int torcwa_ms_band_scan_c64(const void* H, int n, const int* rec,
                                       int count, float defl_mult, void* info,
                                       int* launches, void* stream) {
  *launches = 0;
  return (int)over_lanes(rec, count, 2, 1, one_kind,
                         [&](int, const Lanes& t) {
    ms_band_scan<<<t.count, kScanThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)H, n, t, defl_mult, (int*)info);
    return counted(launches);
  });
}

// rec: (lane, exc) a lane
extern "C" int torcwa_ms_aed_c64(void* H, int n, void* info, const int* rec,
                                 int count, int m, int kw, float defl_mult,
                                 void* Lp, void* shifts, int* launches,
                                 void* stream) {
  *launches = 0;
  if (kw < 1 || kw > kMaxKw || m < 1 || m > kMaxM)
    return (int)cudaErrorInvalidValue;
  const size_t smem = aed_warp_smem_elems(kw) * sizeof(float2);
  cudaError_t err = set_smem(ms_aed, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)over_lanes(rec, count, 2, 1, one_kind,
                         [&](int, const Lanes& t) {
    ms_aed<<<t.count, kAedThreads, smem, (cudaStream_t)stream>>>(
        (float2*)H, n, (int*)info, t, m, kw, defl_mult, (float2*)Lp,
        (float2*)shifts);
    return counted(launches);
  });
}

// rec: (lane, exc) a lane
extern "C" int torcwa_ms_trailing_shifts_c64(const void* H, int n, void* info,
                                             const int* rec, int count, int m,
                                             void* shifts, int* launches,
                                             void* stream) {
  *launches = 0;
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  const size_t smem =
      shift_block_elems(m) * sizeof(float2) + (size_t)m * sizeof(float);
  cudaError_t err = set_smem(ms_trailing_shifts, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)over_lanes(rec, count, 2, 1, one_kind,
                         [&](int, const Lanes& t) {
    ms_trailing_shifts<<<t.count, 32, smem, (cudaStream_t)stream>>>(
        (const float2*)H, n, (int*)info, t, m, (float2*)shifts);
    return counted(launches);
  });
}

namespace {

// The shared memory of a chase window: the recorded rotations always, at
// most (wb - 2) steps of m, 195 KB at wb = 256, m = 64; the window joins
// them there when both fit (wb = 128: 129 KB + at most 46 KB).
size_t chase_list_bytes(const int* p, int m) {
  return (size_t)max(p[4] - p[3] + 1, 0) * m * (sizeof(float2) + sizeof(float));
}
size_t chase_window_bytes(const int* p) {
  return (size_t)p[2] * (p[2] + 1) * sizeof(float2);
}
bool chase_staged(const int* p, int m) {
  return chase_window_bytes(p) + chase_list_bytes(p, m) <= kMaxChaseSmem;
}

}  // namespace

// rec: (lane, a, wb, tcur, t_end, lo, hi) a lane; a lane's U takes us
// elements.  The staged and the unstaged lanes are launched apart.
extern "C" int torcwa_ms_chase_c64(void* H, int n, void* U, long long us,
                                   const int* rec, int count, int m,
                                   const void* shifts, void* xy,
                                   int* launches, void* stream) {
  *launches = 0;
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  for (int e = 0; e < count; ++e) {
    const int* p = rec + (size_t)e * 7;
    if (p[2] < 1 || p[2] > kMaxW || p[1] < 0 || p[1] + p[2] > n ||
        chase_list_bytes(p, m) > kMaxChaseSmem)
      return (int)cudaErrorInvalidValue;
  }
  return (int)over_lanes(
      rec, count, 7, 2, [&](const int* p) { return (int)chase_staged(p, m); },
      [&](int staged, const Lanes& t) {
        size_t smem = 0;
        for (int e = 0; e < t.count; ++e)
          smem = std::max(smem, (staged ? chase_window_bytes(t.v[e]) : 0) +
                                    chase_list_bytes(t.v[e], m));
        auto kernel = staged ? ms_chase<true> : ms_chase<false>;
        cudaError_t err = set_smem(kernel, smem);
        if (err != cudaSuccess) return err;
        kernel<<<t.count, kChaseThreads, smem, (cudaStream_t)stream>>>(
            (float2*)H, n, (float2*)U, (size_t)us, t, m,
            (const float2*)shifts, (float2*)xy);
        return counted(launches);
      });
}

namespace {

template <int RT>
cudaError_t launch_slabs(float2* H, int ldh, float2* Z, int ldz, int n,
                         int nz, const float2* P, size_t ps, Lanes t,
                         int* launches, cudaStream_t stream) {
  int blocks = 0, w = 0;
  for (int e = 0; e < t.count; ++e) {
    int* p = t.v[e];
    const int a = p[1], we = p[2];
    auto strips = [](int rows) { return (max(rows, 0) + kSlabStrip - 1) /
                                        kSlabStrip; };
    p[4] = blocks;
    p[5] = strips(n - a - we);
    p[6] = strips(a);
    p[7] = strips(nz);
    blocks += p[5] + p[6] + p[7];
    w = max(w, we);
  }
  if (blocks == 0) return cudaSuccess;
  const size_t smem = ((size_t)w * kSlabLd + 2 * kSlabKT * RT * kSlabTy) *
                      sizeof(float2);
  cudaError_t err = set_smem(ms_apply_slabs<RT>, smem);
  if (err != cudaSuccess) return err;
  ms_apply_slabs<RT><<<blocks, kSlabThreads, smem, stream>>>(
      H, ldh, Z, ldz, n, nz, P, ps, t);
  return counted(launches);
}

}  // namespace

// rec: (lane, a, w, ldp) a lane: the products of its transform P (w x w) at
// row a, one launch for the lanes of one register tile (RT = ceil(w / 32)):
// left on H's columns right of the window, right on H's rows above it and
// on Z's nz rows.  H is (., n, n) with leading dimension ldh, Z (., nz, n)
// with ldz, a lane's P lies ps elements after the one before.
extern "C" int torcwa_ms_apply_slabs_c64(void* H, int ldh, void* Z, int ldz,
                                         int n, int nz, const void* P,
                                         long long ps, const int* rec,
                                         int count, int* launches,
                                         void* stream) {
  *launches = 0;
  for (int e = 0; e < count; ++e) {
    const int* p = rec + (size_t)e * 4;
    if (p[2] < 1 || p[2] > kMaxW || p[1] < 0 || p[1] + p[2] > n)
      return (int)cudaErrorInvalidValue;
  }
  float2 *Hc = (float2*)H, *Zc = (float2*)Z;
  const float2* Pc = (const float2*)P;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)over_lanes(
      rec, count, 4, kMaxW / kSlabTy + 1,
      [](const int* p) { return (p[2] + kSlabTy - 1) / kSlabTy; },
      [&](int rt, const Lanes& t) {
        auto go = [&](auto slabs) {
          return slabs(Hc, ldh, Zc, ldz, n, nz, Pc, ps, t, launches, st);
        };
        switch (rt) {
          case 1: return go(launch_slabs<1>);
          case 2: return go(launch_slabs<2>);
          case 3: return go(launch_slabs<3>);
          case 4: return go(launch_slabs<4>);
          case 5: return go(launch_slabs<5>);
          case 6: return go(launch_slabs<6>);
          case 7: return go(launch_slabs<7>);
          default: return go(launch_slabs<8>);
        }
      });
}
