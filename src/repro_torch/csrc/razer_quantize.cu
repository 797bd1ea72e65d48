// RaZeR dynamic activation fake-quant for Hopper (sm_90a), K2.
//
// Replaces the Pallas TPU kernel `razer_act_qdq_pallas`
// (src/repro/kernels/razer_quantize.py:103, block helper `_qdq_block`).
//
// For each 16-element block along the last dim of x (M, K), the arithmetic
// of razer_act_qdq.cuh (shared with the packed GEMM's fused x path, so both
// return the plain version's bits): an E4M3 block scale from the absmax,
// FP4 rounding with ties to the lower value, each special value tried in
// order and taken only on a strictly smaller block SSE summed left to
// right, the chosen values times the scale in the input dtype.  The tables
// come from the wrapper, computed from the same numpy grids the plain
// version rounds onto.
//
// What bounds it on this card: it reads x once and writes y once, with a few
// dozen compares per element, so it is bound by those bytes; at decode sizes
// (a few rows) by launch latency.  That launch is what the GEMM's fused x
// path removes at decode-sized M (kernels/razer_matmul.py launch_plan);
// this kernel serves the larger M, where quantizing x once beats doing it
// again in every column block of the GEMM.  Design: a quad of threads per
// block of 16, four consecutive values a thread, the tables in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "razer_act_qdq.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
razer_act_qdq_kernel(const T* __restrict__ x, T* __restrict__ y, long long n_elems, const float* __restrict__ table,
                     int n_sv) {
  __shared__ __align__(16) float tab[razer_act::TABLE];
  for (int i = threadIdx.x; i < razer_act::TABLE; i += blockDim.x) tab[i] = table[i];
  __syncthreads();

  // thread i holds elements 4i .. 4i + 3; n_elems is a multiple of 16, so a
  // quad is wholly in or past the end
  const long long i0 = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x);
  if (i0 >= n_elems) return;
  const int lane = threadIdx.x & 31;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_f32(x[i0 + j]);
  razer_act::qdq_quad(v, tab, n_sv, lane & 3, razer_act::quad_mask(lane));
#pragma unroll
  for (int j = 0; j < 4; ++j) store(y + i0 + j, v[j]);
}

}  // namespace

// x, y: (M, K) bf16 (is_bf16 = 1) or f32, contiguous, K % 16 == 0.  table:
// the razer_act_qdq.cuh table (float32, razer_act::TABLE entries) with
// n_sv <= 4 special values.  Returns cudaGetLastError().
extern "C" int razer_act_qdq_launch(const void* x, void* y, int is_bf16, long long n_elems, const void* table,
                                    int n_sv, void* stream) {
  if (n_sv < 0 || n_sv > razer_act::MAX_SV || n_elems % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = n_elems / 4;
  const int grid = (int)((quads + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* tab = static_cast<const float*>(table);
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  if (is_bf16) {
    razer_act_qdq_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n_elems, tab, n_sv);
  } else {
    razer_act_qdq_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(x), static_cast<float*>(y),
                                                          n_elems, tab, n_sv);
  }
  return static_cast<int>(cudaGetLastError());
}
