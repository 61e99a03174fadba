// Batched implicit single-shift complex Schur QR on a PACKED planar layout:
// H = Z T Z^H with T upper triangular, H and Z^T stored as rows
// [re(0..n) pad | im(0..n) pad] of 2 npad floats.
//
// Replaces the TPU kernel
// torcwa_tpu/ops/attic/eig_qr_pallas_packed.py::_kernel_packed (public entry
// schur_qr_pallas_packed) and keeps its rules, which are _kernel_acc's
// iteration (schur_qr.cu) under one other constant:
//  * deflation: subdiagonal k is dead when |h_k+1,k| <= max(eps (|h_kk| +
//    |h_k+1,k+1|), 1e-31) (multiplier 1, where _kernel_acc takes 4); the
//    window bottom only moves up;
//  * up to 4 independent windows (alive runs) per sweep, one bulge each;
//  * Wilkinson shift from each run's trailing 2x2; every 13th sweep the
//    bottom run takes the exceptional shift d + 0.75 |sub|;
//  * stall gate: an exactly real discriminant takes the real branch until the
//    window has not shrunk for 30 sweeps;
//  * budget max_iters sweeps; stats[b] = (final window bottom, sweeps,
//    rotations applied), bottom 0 meaning converged.  The wrapper NaN-poisons
//    the diagonal of lanes that did not converge.
// What makes it this kernel and not schur_qr.cu is the storage, which is kept
// as the design: the wrapper packs H and Z^T into planar rows whose imaginary
// half starts at float npad, n rounded up to 32 floats, so that both halves of
// a row start on a 128-byte line (the TPU's reason for its pad was the
// 128-lane vector register); the kernel rotates those rows in place by the
// packed rotation algebra of the TPU kernel,
//     nk = c hk + sr h1 + si (S swap(h1)),  n1 = c h1 - sr hk + si (S swap(hk))
// with S = (-1 | +1) over the two halves and swap exchanging them: a thread
// owns one column j of a row pair and reads and writes the floats j and
// npad + j of both rows, which is that algebra for the lane pair (j, npad + j).
// Then a row rotation of H and the rotation of Z (two rows of Z^T) are
// contiguous 4-byte accesses, where schur_qr.cu rotates two columns of Z at
// stride n, one 32-byte sector for every 16 bytes used; only H's own column
// pair (rows <= k + 2) stays strided.  The padding floats [n, npad) of each
// half are never written and stay zero.
// Not carried over, because they serve the TPU's matrix unit and compiler:
// the deferred-column accumulator W with its once-per-sweep products H W^T
// and W Z^T (on one SM ~16 n^3 flops a sweep against ~20 n^2 for rotating
// directly), the prefix-bucket switch, the carried rows and the single roll
// per step, the chunking of the batch.
//
// Design: one thread block of 512 threads per matrix (grid = batch), in place
// on the packed H and Z^T in device memory (L2-resident at the main-path
// size); flags, runs and the rotation carry in shared memory.  The start of a
// sweep is plan_sweep of single_shift.cuh, shared with schur_qr.cu.  A
// rotation is two phases behind block barriers: (1) rows k, k+1 of H (columns
// >= k - 1) and of Z^T (all columns), threads over columns; (2) columns k,
// k+1 of H (rows <= k + 2), threads over rows.
//
// What bounds it on an H100: latency, as schur_qr.cu: every rotation is O(n)
// work behind two block barriers and two dependent round trips to the L2
// cache, tens of thousands of rotations per matrix, one SM per matrix.  The
// design removes the strided half of the traffic and does nothing else about
// it yet.

#include "single_shift.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
schur_qr_packed_kernel(float* __restrict__ Hp, float* __restrict__ Ztp,
                       int* __restrict__ stats, int n, int npad,
                       int max_iters) {
  using R = PackedRules;
  extern __shared__ unsigned char alive[];  // alive[c]: subdiagonal c+1,c
  __shared__ SweepPlan<R> plan;
  __shared__ float2 s_x, s_y;

  const int ld = 2 * npad;
  Hp += (size_t)blockIdx.x * n * ld;
  Ztp += (size_t)blockIdx.x * n * ld;
  const int tid = threadIdx.x;
  // entry (i, j) of a packed matrix: its two floats
  auto get = [&](const float* X, int i, int j) {
    const float* p = X + (size_t)i * ld + j;
    return c_make(p[0], p[npad]);
  };
  auto put = [&](float* X, int i, int j, float2 v) {
    float* p = X + (size_t)i * ld + j;
    p[0] = v.x;
    p[npad] = v.y;
  };

  int hi = n - 1, it = 0;
  int stall = 0, rot = 0;  // meaningful in thread 0 only
  while (hi > 0 && it < max_iters) {
    // ---- deflation flags, windows and shifts (single_shift.cuh) ----
    plan_sweep<R>([&](int i, int j) { return get(Hp, i, j); }, hi, it, stall,
                  rot, alive, plan);
    hi = plan.hi0;
    const int nr = plan.nr;

    // ---- one bulge per run, top-most run first ----
    for (int r = nr - 1; r >= 0; --r) {
      const int lo = plan.lo[r], hr = plan.hi[r];
      if (tid == 0) {
        s_x = c_sub(get(Hp, lo, lo), plan.shift[r]);
        s_y = get(Hp, lo + 1, lo);
      }
      __syncthreads();
      for (int k = lo; k < hr; ++k) {
        const Givens g = givens(s_x, s_y);
        const float c = g.c;
        const float2 s = g.s;
        // rows k, k+1 of H, columns >= k - 1:
        //   new_k = c h_k + s h_k1 ; new_k1 = c h_k1 - conj(s) h_k
        // rows k, k+1 of Z^T (columns k, k+1 of Z), all columns:
        //   new_k = c z_k + conj(s) z_k1 ; new_k1 = c z_k1 - s z_k
        const int j0 = max(k - 1, 0), nh = n - j0;
        for (int idx = tid; idx < nh + n; idx += kThreads) {
          if (idx < nh) {
            const int j = j0 + idx;
            const float2 hk = get(Hp, k, j), h1 = get(Hp, k + 1, j);
            put(Hp, k, j, c_add(c_scale(c, hk), c_mul(s, h1)));
            put(Hp, k + 1, j, c_sub(c_scale(c, h1), c_cmul(s, hk)));
          } else {
            const int j = idx - nh;
            const float2 zk = get(Ztp, k, j), z1 = get(Ztp, k + 1, j);
            put(Ztp, k, j, c_add(c_scale(c, zk), c_cmul(s, z1)));
            put(Ztp, k + 1, j, c_sub(c_scale(c, z1), c_mul(s, zk)));
          }
        }
        __syncthreads();
        // columns k, k+1 of H, rows <= k + 2:
        //   new_l = c l + conj(s) r ; new_r = c r - s l
        const int imax = min(k + 2, n - 1);
        for (int i = tid; i <= imax; i += kThreads) {
          const float2 l = get(Hp, i, k), rr = get(Hp, i, k + 1);
          const float2 nl = c_add(c_scale(c, l), c_cmul(s, rr));
          put(Hp, i, k, nl);
          put(Hp, i, k + 1, c_sub(c_scale(c, rr), c_mul(s, l)));
          if (i == k + 1) s_x = nl;
          if (i == k + 2) s_y = (k + 2 <= hi) ? nl : c_make(0.f, 0.f);
        }
        if (tid == 0 && k + 2 > n - 1) s_y = c_make(0.f, 0.f);
        __syncthreads();
      }
    }
    // round-off of the chase on the second subdiagonal
    if (nr > 0) {
      for (int j = tid; j < n - 2; j += kThreads)
        put(Hp, j + 2, j, c_make(0.f, 0.f));
      __syncthreads();
    }
    ++it;
  }

  for (int e = tid; e < n * n; e += kThreads)
    if (e / n > e % n) put(Hp, e / n, e % n, c_make(0.f, 0.f));
  if (tid == 0) {
    stats[3 * blockIdx.x] = hi;
    stats[3 * blockIdx.x + 1] = it;
    stats[3 * blockIdx.x + 2] = rot;
  }
}

}  // namespace

// Hp (packed H in, T out) and Ztp (packed Q^T in, Z^T out): batch x n x
// 2 npad float32, in place; npad >= n, a multiple of 32; stats takes three
// 32-bit integers per matrix.
extern "C" int torcwa_schur_qr_packed_f32(void* Hp, void* Ztp, void* stats,
                                          int batch, int n, int npad,
                                          int max_iters, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (npad < n || npad % 32 != 0) return (int)cudaErrorInvalidValue;
  schur_qr_packed_kernel<<<batch, kThreads, (size_t)n,
                           (cudaStream_t)stream>>>(
      (float*)Hp, (float*)Ztp, (int*)stats, n, npad, max_iters);
  return (int)cudaGetLastError();
}
