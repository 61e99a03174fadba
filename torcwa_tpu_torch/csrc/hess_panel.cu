// The column loop of one panel of the blocked (compact-WY) Hessenberg
// reduction, in one launch.
//
// Replaces no TPU kernel: the JAX package's blocked reduction
// (torcwa_tpu/ops/hess_blocked.py) is plain XLA, and so was the port's
// (ops/hess_blocked.py, whose loop stays as the plain version for CPU
// tensors).  It was added because on the card that loop issued some thirty
// small launches a column, and the host's launch rate, not the card, set
// the time of the whole stage (PERF.md, PR 17: 527 of a 535 ms stage at
// n = 882).
//
// Per panel at column k0, width p, trailing block At = A[k0:, k0:] of size
// t, it forms V (t, p), Y = At V (t, p) and the upper triangular T (p, p)
// of Q_p = I - V T V^H column by column, as the plain loop does:
//   u = At[:, jj] - Y (T conj(V[jj, :]))
//   c = u - V (T^H (V^H u)),  x = c[jj+1:]
//   v = x + phase(x_0) ||x|| e_1,  beta = 2 / ||v||^2 (0 for x = 0)
//   T[:jj, jj] = -beta T (V[jj+1:, :]^H v),  T[jj, jj] = beta
//   V[jj+1:, jj] = v,  Y[:, jj] = At[:, jj+1:] v
// The panel-end update stays three GEMMs in the caller.
//
// Design: one persistent grid of at most one block per SM (a cooperative
// launch, so every block is resident), the blocks joined by a barrier on a
// counter in device memory (a release add, an acquire wait).  Block g owns the rows [g R, (g+1) R) of At, V
// and Y; each keeps its own copy of T in shared memory, and its rows of V
// and Y there too where they fit.  A column takes two grid barriers:
//   1. every block forms w = T conj(V[jj, :]) from its copy of T, then u on
//      its rows, and writes its partial sum of V^H u;
//   2. every block adds the partials, forms z = T^H (V^H u) and c = u - V z
//      on its rows (written to device memory), and writes its partials of
//      V[jj+1:, :]^H x and ||x||^2, with x's head from the block that owns
//      its row, in one vector: since v differs from x in its head alone,
//      V^H v = V^H x + conj(V[jj+1, :]) phase(x_0) ||x||, so one reduction
//      gives the norm, the phase and T's column;
//   3. every block adds those partials, forms beta, v's head and T[:, jj],
//      writes its rows of v into V, stages v whole in shared memory (from
//      c) and forms Y[:, jj] = At[:, jj+1:] v on its rows, a warp per
//      (row, stretch of the row).  Nothing after it reads another block's
//      work of this column before the next barrier, so the next column's
//      first phase follows with no barrier.
// Sums over the blocks are taken in a fixed order: the bits do not depend
// on the timing.
//
// What bounds it on an H100: latency.  A column of the first panel at
// n = 882 took ~25k cycles in a clock64() build (NVIDIA H100 80GB HBM3,
// 700 W): the two grid barriers ~2.3k each, the two sums over the blocks'
// partials ~3.5k each (L2 round trips), the three products with T ~1.7k
// each, the GEMV ~3.3k, the rest ~4k.  The GEMV reads n^3/3 complex64 in
// all; the trailing block of n = 1922 (29.5 MB) stays in the 50 MB L2, that
// of n = 3362 does not, and there the GEMV streams from device memory
// (~65k of ~97k cycles a column).  Blocks of kMinRows = 16 rows or more
// (one block per SM at most) were the fastest of 8, 12, 16, 24 and 32.
// IEEE float32 on CUDA cores throughout.
//
// The C entry point picks the blocks, the rows a block and where V, Y and
// the staged v live, from t and p alone; ops/hess_blocked.py mirrors the
// choice (hess_panel_plan) and hess_panel_info reads it back.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the widest panel: a thread (m, q) of kSplit threads per output m of the
// p-long products with T
constexpr int kMaxPanel = 128;
constexpr int kSplit = kThreads / kMaxPanel;
// the fewest rows of the trailing block a block takes
constexpr int kMinRows = 16;
// loads in flight per lane: a block's partials in the sums over the
// blocks, a row of At in the GEMV
constexpr int kUnroll = 8;
// threads that share one output's sum over the blocks, at most
constexpr int kMaxShare = 16;
// dynamic shared memory a block may use on an H100 (227 KB)
constexpr size_t kSmemPerBlock = 232448;

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

struct Plan {
  int blocks, rows, vy_smem, stage;
  size_t smem;
};

// Row stride of the copy of T in shared memory: even, so that the threads
// of a warp that read T[m, m + k] (stride ld + 1) or T[k, m] (stride 1),
// one m a lane, hit distinct banks.
__host__ __device__ __forceinline__ int t_ld(int p) { return (p | 1) + 1; }

// Bytes of dynamic shared memory of a block: T padded to t_ld(p) columns,
// five p-vectors (V's row jj, V's row jj + 1, w, z, T's new column's right
// side) and one of p + 1 (the reduced sums), kThreads partial sums, u, c
// and At's next column on the block's rows, the GEMV's partial sums, and,
// where chosen, the block's rows of V and Y and the staged v (t entries).
// ops/hess_blocked.py mirrors the count.
size_t plan_smem(int t, int p, int rows, bool vy_smem, bool stage) {
  size_t f2 = (size_t)p * t_ld(p) + 6 * (size_t)p + 1 + kThreads +
              3 * (size_t)rows + (size_t)(rows > kWarps ? rows : kWarps);
  if (vy_smem) f2 += 2 * (size_t)rows * p;
  if (stage) f2 += (size_t)t;
  return f2 * sizeof(float2);
}

// The grid at trailing size t and panel width p on a card of `sms` SMs:
// kMinRows rows a block, or as many more as keep to one block per SM (the
// last block takes what is left); V and Y rows in shared memory where
// they fit beside T and the staged v, else in device memory; v staged
// where it fits, else read from L2 in the GEMV.
Plan plan(int t, int p, int sms) {
  Plan q;
  q.rows = (t + sms - 1) / sms;
  if (q.rows < kMinRows) q.rows = kMinRows;
  q.blocks = (t + q.rows - 1) / q.rows;
  q.vy_smem = plan_smem(t, p, q.rows, true, true) <= kSmemPerBlock;
  q.stage = q.vy_smem || plan_smem(t, p, q.rows, false, true) <= kSmemPerBlock;
  q.smem = plan_smem(t, p, q.rows, q.vy_smem, q.stage);
  return q;
}

struct Args {
  const float2* A;  // At[0, 0]: At[i, j] = A[i * lda + j], read only
  float2* V;        // (t, p)
  float2* Y;        // (t, p)
  float2* T;        // (p, p)
  float2* c;        // (t): c of the current column, by the rows' owners
  float2* part1;    // (blocks, p + 1): partial V^H u
  float2* part2;    // (blocks, p + 1): partial V[jj+1:, :]^H x, then
                    // ||x||^2 and x's head (its owner's alone)
  unsigned* bar;    // the grid barrier's counter, 0 at the launch
  int lda, t, p, cols, rows, vy_smem, stage;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block's writes before it are visible to every block after it:
// the block's arrival is a release, its wait an acquire, at the scope of
// the card.  The counter only grows: the k-th barrier of the launch waits
// for k * gridDim.x arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    while (ld_acquire(bar) < target) {
    }
  }
  __syncthreads();
}

// out[m] = red[m] + red[n + m] + ... + red[(k - 1) n + m] for m < n, in
// that order; barriers on both sides.
__device__ __forceinline__ void combine(const float2* red, float2* out,
                                       int n, int k) {
  __syncthreads();
  const int m = threadIdx.x;
  if (m < n) {
    float2 acc = red[m];
    for (int q = 1; q < k; ++q) acc = c_add(acc, red[q * n + m]);
    out[m] = acc;
  }
  __syncthreads();
}

// x += T[m, l] y[l] (or conj(T[l, m]) y[l] with kAdjoint) over l < n, by
// the kSplit threads of output m, into red[q * n + m]; then added into
// out[m] (combine).  T is upper triangular: l >= m (l <= m).
template <bool kAdjoint>
__device__ __forceinline__ void t_times(const float2* Ts, int ld,
                                        const float2* y, float2* red,
                                        float2* out, int n) {
  const int m = threadIdx.x % kMaxPanel, q = threadIdx.x / kMaxPanel;
  if (m < n) {
    float2 acc = c_make(0.f, 0.f);
    if (kAdjoint)
      for (int l = q; l <= m; l += kSplit)
        acc = c_add(acc, c_cmul(Ts[l * ld + m], y[l]));
    else
      for (int l = m + q; l < n; l += kSplit)
        acc = c_add(acc, c_mul(Ts[m * ld + l], y[l]));
    red[q * n + m] = acc;
  }
  combine(red, out, n, kSplit);
}

// Sum over the blocks of part[b * stride + l] for l < n, into out: the
// blocks cut into k consecutive runs, a thread per (run, l) adding its run
// in block order (its loads in flight together), the k run sums added in
// run order (combine).
__device__ __forceinline__ void reduce_blocks(const float2* part, int stride,
                                              float2* red, float2* out, int n,
                                              int nblocks) {
  int k = kThreads / n;
  if (k > kMaxShare) k = kMaxShare;
  const int run = (nblocks + k - 1) / k;
  const int l = threadIdx.x % n, q = threadIdx.x / n;
  if (q < k) {
    float2 acc = c_make(0.f, 0.f);
    const int b1 = min(nblocks, (q + 1) * run);
    for (int b = q * run; b < b1; b += kUnroll) {
      float2 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (b + u < b1) x[u] = __ldcg(part + (size_t)(b + u) * stride + l);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (b + u < b1) acc = c_add(acc, x[u]);
    }
    red[q * n + l] = acc;
  }
  combine(red, out, n, k);
}

// Dot product of a row of At with v over the columns j0, j0 + stride, ...
// < j1; v in shared memory (kStage) or read from L2.
template <bool kStage>
__device__ __forceinline__ float2 row_dot(const float2* __restrict__ arow,
                                          const float2* v, int j0, int j1,
                                          int stride) {
  float sx = 0.f, sy = 0.f;
  int j = j0;
  for (; j + (kUnroll - 1) * stride < j1; j += kUnroll * stride) {
    float2 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = __ldg(arow + j + u * stride);
      y[u] = kStage ? v[j + u * stride] : __ldcg(v + j + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sx += x[u].x * y[u].x - x[u].y * y[u].y;
      sy += x[u].x * y[u].y + x[u].y * y[u].x;
    }
  }
  for (; j < j1; j += stride) {
    const float2 x = __ldg(arow + j), y = kStage ? v[j] : __ldcg(v + j);
    sx += x.x * y.x - x.y * y.y;
    sy += x.x * y.y + x.y * y.x;
  }
  return c_make(sx, sy);
}

__global__ void __launch_bounds__(kThreads, 1) hess_panel_kernel(Args a) {
  extern __shared__ float2 sm[];
  const int p = a.p, t = a.t, R = a.rows, G = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  const int nr = max(0, min(R, t - row0));
  const int ld = t_ld(p), ps = p + 1;
  const float2* At = a.A + (size_t)row0 * a.lda;   // the block's rows
  float2* Ts = sm;                        // T, row m at Ts[m * ld]
  float2* vrow = Ts + (size_t)p * ld;     // conj(V[jj, :])
  float2* vnext = vrow + p;               // V[jj + 1, :], read in phase 2
  float2* w = vnext + p;                  // T conj(V[jj, :]), T's column
  float2* z = w + p;                      // T^H (V^H u)
  float2* s = z + p;                      // the reduced sums (p + 1)
  float2* rhs = s + p + 1;                // V[jj+1:, :]^H v
  float2* red = rhs + p;                  // kThreads partial sums
  float2* uo = red + kThreads;            // u on the block's rows
  float2* co = uo + R;                    // c on the block's rows
  float2* anext = co + R;                 // At[:, jj] on the block's rows
  float2* yp = anext + R;                 // the GEMV's partial sums
  float2* rest = yp + (R > kWarps ? R : kWarps);
  float2 *Vb, *Yb;                        // the block's rows of V and Y
  if (a.vy_smem) {
    Vb = rest;
    Yb = Vb + (size_t)R * p;
    rest = Yb + (size_t)R * p;
  } else {
    Vb = a.V + (size_t)row0 * p;
    Yb = a.Y + (size_t)row0 * p;
  }
  float2* vs = rest;                      // v staged, by row of At
  // the GEMV's tasks: (row, stretch of the row), nch stretches a row
  const int nch = nr > 0 && nr < kWarps ? kWarps / nr : 1;

  for (int e = tid; e < p * ld; e += kThreads) Ts[e] = c_make(0.f, 0.f);
  for (int e = tid; e < nr * p; e += kThreads) {
    Vb[e] = c_make(0.f, 0.f);
    Yb[e] = c_make(0.f, 0.f);
    if (a.vy_smem) a.V[(size_t)row0 * p + e] = c_make(0.f, 0.f);
  }
  if (tid < nr) anext[tid] = __ldg(At + (size_t)tid * a.lda);
  __syncthreads();

  float2 vhead = c_make(0.f, 0.f);        // V[jj, jj - 1], every thread
  unsigned epoch = 0;

  for (int jj = 0; jj < a.cols; ++jj) {
    // --- 1. w = T conj(V[jj, :]), u on the rows, partial V^H u ---------
    if (tid < jj) {
      const float2 v = tid == jj - 1 ? vhead : vnext[tid];
      vrow[tid] = c_make(v.x, -v.y);
    }
    __syncthreads();
    t_times<false>(Ts, ld, vrow, red, w, jj);
    for (int i = warp; i < nr; i += kWarps) {
      float sx = 0.f, sy = 0.f;
      for (int l = lane; l < jj; l += 32) {
        const float2 y = Yb[(size_t)i * p + l], ww = w[l];
        sx += y.x * ww.x - y.y * ww.y;
        sy += y.x * ww.y + y.y * ww.x;
      }
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) uo[i] = c_sub(anext[i], c_make(sx, sy));
    }
    if (jj > 0) {
      __syncthreads();
      const int m = tid % kMaxPanel, q = tid / kMaxPanel;
      if (m < jj) {
        float2 acc = c_make(0.f, 0.f);
        for (int i = q; i < nr; i += kSplit)
          acc = c_add(acc, c_cmul(Vb[(size_t)i * p + m], uo[i]));
        red[q * jj + m] = acc;
      }
      combine(red, s, jj, kSplit);
      if (tid < jj) a.part1[(size_t)blockIdx.x * ps + tid] = s[tid];
      grid_barrier(a.bar, ++epoch * G);

      // --- 2. z = T^H (V^H u), c = u - V z, partials for x -------------
      // V[jj + 1, :jj] is complete since this column's barrier: read it
      // now, for phase 3 and the next column's phase 1
      float2 vn = c_make(0.f, 0.f);
      if (tid < jj) vn = __ldcg(a.V + (size_t)(jj + 1) * p + tid);
      reduce_blocks(a.part1, ps, red, s, jj, G);
      if (tid < jj) vnext[tid] = vn;
      t_times<true>(Ts, ld, s, red, z, jj);
    }
    for (int i = warp; i < nr; i += kWarps) {
      float sx = 0.f, sy = 0.f;
      for (int l = lane; l < jj; l += 32) {
        const float2 v = Vb[(size_t)i * p + l], zz = z[l];
        sx += v.x * zz.x - v.y * zz.y;
        sy += v.x * zz.y + v.y * zz.x;
      }
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        const float2 cv = c_sub(uo[i], c_make(sx, sy));
        co[i] = cv;
        a.c[row0 + i] = cv;
      }
    }
    __syncthreads();
    // x = c on the rows > jj: partial V^H x (l < jj), ||x||^2 (jj), and
    // x's head (jj + 1) from the block that owns its row
    {
      const int n1 = jj + 1;
      const int m = tid % kMaxPanel, q = tid / kMaxPanel;
      const int i0 = max(0, jj + 1 - row0);
      if (m < n1) {
        float2 acc = c_make(0.f, 0.f);
        for (int i = i0 + q; i < nr; i += kSplit) {
          const float2 cv = co[i];
          acc = c_add(acc, m < jj ? c_cmul(Vb[(size_t)i * p + m], cv)
                                  : c_make(c_abs2(cv), 0.f));
        }
        red[q * n1 + m] = acc;
      }
      combine(red, s, n1, kSplit);
      float2* part = a.part2 + (size_t)blockIdx.x * ps;
      if (tid < n1) part[tid] = s[tid];
      if (tid == n1) {
        const int i = jj + 1 - row0;
        part[n1] = i >= 0 && i < nr ? co[i] : c_make(0.f, 0.f);
      }
    }
    grid_barrier(a.bar, ++epoch * G);

    // --- 3. beta, T[:, jj], v into V, Y[:, jj] = At[:, jj+1:] v --------
    float2 an = c_make(0.f, 0.f);
    if (tid < nr) an = __ldg(At + (size_t)tid * a.lda + jj + 1);
    reduce_blocks(a.part2, ps, red, s, jj + 2, G);
    const float xnorm = sqrtf(s[jj].x);
    const float2 alpha = s[jj + 1];
    const float aabs = hypotf(alpha.x, alpha.y);
    const float2 ph = aabs > 0.f ? c_make(alpha.x / aabs, alpha.y / aabs)
                                 : c_make(1.f, 0.f);
    const float2 hs = c_scale(xnorm, ph);      // v's head less x's
    const float vnorm2 = 2.f * xnorm * (xnorm + aabs);
    const float beta = vnorm2 > 0.f ? 2.f / vnorm2 : 0.f;
    if (tid < jj) rhs[tid] = c_add(s[tid], c_cmul(vnext[tid], hs));
    if (tid < nr) anext[tid] = an;
    if (a.stage)
      for (int j = jj + 1 + tid; j < t; j += kThreads)
        vs[j] = __ldcg(a.c + j);
    __syncthreads();
    t_times<false>(Ts, ld, rhs, red, w, jj);
    if (tid < jj) Ts[tid * ld + jj] = c_scale(-beta, w[tid]);
    if (tid == jj) Ts[jj * ld + jj] = c_make(beta, 0.f);
    for (int i = tid; i < nr; i += kThreads) {
      const int gi = row0 + i;
      float2 v = c_make(0.f, 0.f);
      if (gi > jj) v = gi == jj + 1 ? c_add(co[i], hs) : co[i];
      Vb[(size_t)i * p + jj] = v;
      if (a.vy_smem) a.V[(size_t)gi * p + jj] = v;
    }
    vhead = c_add(alpha, hs);
    // Y[:, jj] on the block's rows: a warp per (row, stretch) sums x (c's
    // entries past jj) against the row, and v's head term is added apart
    for (int task = warp; task < nr * nch; task += kWarps) {
      const int i = task / nch, j0 = jj + 1 + (task % nch) * 32 + lane;
      const float2* arow = At + (size_t)i * a.lda;
      const float2 d = a.stage ? row_dot<true>(arow, vs, j0, t, 32 * nch)
                               : row_dot<false>(arow, a.c, j0, t, 32 * nch);
      const float sx = warp_sum(d.x), sy = warp_sum(d.y);
      if (lane == 0) yp[task] = c_make(sx, sy);
    }
    __syncthreads();
    for (int i = tid; i < nr; i += kThreads) {
      float2 y = yp[i * nch];
      for (int ch = 1; ch < nch; ++ch) y = c_add(y, yp[i * nch + ch]);
      Yb[(size_t)i * p + jj] = c_add(y, c_mul(anext[i], hs));
    }
    __syncthreads();
  }

  if (a.vy_smem)
    for (int e = tid; e < nr * p; e += kThreads)
      a.Y[(size_t)row0 * p + e] = Yb[e];
  if (blockIdx.x == 0)
    for (int e = tid; e < p * p; e += kThreads)
      a.T[e] = Ts[(e / p) * ld + e % p];
}

}  // namespace

// out: blocks, rows, shared memory bytes, V and Y rows in shared memory
// (1) or device memory (0), v staged (1) or read from L2 (0), at trailing
// size t and panel width p on this card.
extern "C" int torcwa_hess_panel_info(int t, int p, void* out) {
  if (t < 1 || p < 1 || p > kMaxPanel) return (int)cudaErrorInvalidValue;
  const Plan q = plan(t, p, sm_count());
  int* o = (int*)out;
  o[0] = q.blocks;
  o[1] = q.rows;
  o[2] = (int)q.smem;
  o[3] = q.vy_smem;
  o[4] = q.stage;
  return 0;
}

// Columns [0, cols) of the panel whose trailing block starts at A (row
// stride lda, t x t): V, Y (t, p) and T (p, p), row-major, complex64.
// scratch holds t + 2 * blocks * (p + 1) + 1 complex64 (c, the two partial
// vectors, the barrier's counter), blocks as torcwa_hess_panel_info gives.
extern "C" int torcwa_hess_panel_c64(const void* A, int lda, int t, int p,
                                     int cols, void* V, void* Y, void* T,
                                     void* scratch, void* stream) {
  if (t < 3 || p < 1 || p > kMaxPanel || cols < 1 || cols > p ||
      cols > t - 2 || lda < t)
    return (int)cudaErrorInvalidValue;
  const Plan q = plan(t, p, sm_count());
  cudaError_t err = set_smem(hess_panel_kernel, q.smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.A = (const float2*)A;
  a.V = (float2*)V;
  a.Y = (float2*)Y;
  a.T = (float2*)T;
  a.c = (float2*)scratch;
  a.part1 = a.c + t;
  a.part2 = a.part1 + (size_t)q.blocks * (p + 1);
  a.bar = (unsigned*)(a.part2 + (size_t)q.blocks * (p + 1));
  a.lda = lda;
  a.t = t;
  a.p = p;
  a.cols = cols;
  a.rows = q.rows;
  a.vy_smem = q.vy_smem;
  a.stage = q.stage;
  const cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)hess_panel_kernel,
                                    dim3(q.blocks), dim3(kThreads), args,
                                    q.smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
