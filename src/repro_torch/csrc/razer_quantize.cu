// RaZeR dynamic activation fake-quant for Hopper (sm_90a).  Build with
// --fmad=false and without --use_fast_math: the output must match the plain
// PyTorch version bit for bit.
//
// Replaces the Pallas TPU kernel `razer_act_qdq_pallas`
// (src/repro/kernels/razer_quantize.py:103, block helper `_qdq_block`).
//
// For each 16-element block along the last dim of x (M, K):
//   1. scale = absmax / 6 rounded to the nearest positive E4M3 value, ties
//      to the lower one; a nonzero block whose scale rounds to 0 gets 2^-9;
//   2. x / scale rounded to the FP4 grid (ties to the lower value);
//   3. each special-value candidate grid FP4 u {v} is tried in order, and a
//      candidate replaces the best so far only on a strictly smaller block
//      SSE, summed left to right over the 16 columns;
//   4. the chosen values times the scale, in the input dtype.
//
// The scale grid and the candidate grids with their midpoints come from the
// wrapper, computed exactly as the plain version computes them; every
// rounding is "count the midpoints below x", which equals
// searchsorted(mids, x, side="left").  The E4M3 binade is found by that
// search, never from log2, which can land in the wrong binade next to a
// power of two.
//
// What bounds it on this card: it reads x once and writes y once, with a few
// dozen compares per element, so it is bound by those bytes; at decode sizes
// (a few rows) by launch latency and its dependent chain.  Design: one thread
// per element and a half-warp per block of 16, so the chain per thread is one
// element's work; absmax by a shuffle reduction (max is exact in any order),
// the block SSE by shuffling the 16 squares to every lane and adding them in
// column order; the tables in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 16;
constexpr int MAX_CAND = 5;  // the base grid plus up to four special values
constexpr int MAX_SCALE = 128;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
razer_act_qdq_kernel(const T* __restrict__ x, T* __restrict__ y, long long n_elems,
                     const float* __restrict__ scale_vals, const float* __restrict__ scale_mids,
                     int n_scale, const float* __restrict__ cand_vals,
                     const float* __restrict__ cand_mids, int n_cand) {
  __shared__ float s_scale_vals[MAX_SCALE];
  __shared__ float s_scale_mids[MAX_SCALE];
  __shared__ float s_cand_vals[MAX_CAND * BLOCK];
  __shared__ float s_cand_mids[MAX_CAND * BLOCK];
  for (int i = threadIdx.x; i < n_scale; i += blockDim.x) {
    s_scale_vals[i] = scale_vals[i];
    if (i < n_scale - 1) s_scale_mids[i] = scale_mids[i];
  }
  for (int i = threadIdx.x; i < n_cand * BLOCK; i += blockDim.x) {
    s_cand_vals[i] = cand_vals[i];
    s_cand_mids[i] = cand_mids[i];
  }
  __syncthreads();

  // one thread per element, the 16 lanes of a half-warp per quant block; a
  // half-warp past the end computes on zeros so every shuffle has all lanes
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool valid = i < n_elems;
  const float v = valid ? to_f32(x[i]) : 0.0f;

  float absmax = fabsf(v);
#pragma unroll
  for (int off = BLOCK / 2; off > 0; off >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off, BLOCK));

  // scale: lower_bound over the sorted midpoints
  const float raw = absmax / 6.0f;
  int lo = 0, hi = n_scale - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_scale_mids[mid] < raw) lo = mid + 1; else hi = mid;
  }
  float scale = s_scale_vals[lo];
  if (scale == 0.0f && absmax > 0.0f) scale = s_scale_vals[1];
  const float s = v / (scale == 0.0f ? 1.0f : scale);

  float best = 0.0f;
  float best_err = 0.0f;
  for (int c = 0; c < n_cand; ++c) {
    const float* mids = s_cand_mids + c * BLOCK;  // padded with +inf
    int idx = 0;
#pragma unroll
    for (int j = 0; j < BLOCK; ++j) idx += mids[j] < s ? 1 : 0;
    const float q = s_cand_vals[c * BLOCK + idx];
    const float d = q - s;
    const float d2 = d * d;
    // every lane sums the block's 16 squares in column order 0..15
    float err = __shfl_sync(0xffffffffu, d2, 0, BLOCK);
#pragma unroll
    for (int j = 1; j < BLOCK; ++j) err = err + __shfl_sync(0xffffffffu, d2, j, BLOCK);
    if (c == 0 || err < best_err) {
      best_err = err;
      best = q;
    }
  }
  if (valid) store(y + i, best * scale);
}

}  // namespace

// x, y: (M, K) bf16 (is_bf16 = 1) or f32, contiguous, K % 16 == 0.
// scale_vals (n_scale) and scale_mids (n_scale - 1): the positive E4M3 grid.
// cand_vals / cand_mids: (n_cand, 16) candidate grids, candidate 0 the plain
// FP4 grid, mids padded with +inf.  Returns cudaGetLastError().
extern "C" int razer_act_qdq_launch(const void* x, void* y, int is_bf16, long long n_elems,
                                    const void* scale_vals, const void* scale_mids, int n_scale,
                                    const void* cand_vals, const void* cand_mids, int n_cand,
                                    void* stream) {
  if (n_cand > MAX_CAND || n_scale > MAX_SCALE) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (int)((n_elems + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sv = static_cast<const float*>(scale_vals);
  const float* sm = static_cast<const float*>(scale_mids);
  const float* cv = static_cast<const float*>(cand_vals);
  const float* cm = static_cast<const float*>(cand_mids);
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  if (is_bf16) {
    razer_act_qdq_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n_elems, sv, sm,
        n_scale, cv, cm, n_cand);
  } else {
    razer_act_qdq_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n_elems, sv, sm, n_scale, cv, cm,
        n_cand);
  }
  return static_cast<int>(cudaGetLastError());
}
