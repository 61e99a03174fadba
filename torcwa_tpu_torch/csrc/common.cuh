// Shared helpers of the eig kernels: complex64 arithmetic on interleaved
// float2 (x = real, y = imaginary, the layout of torch.complex64) and
// block-wide reductions.  Every kernel takes one thread block per matrix.
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

// Allow more than 48 KB of dynamic shared memory when a size needs it.
template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
