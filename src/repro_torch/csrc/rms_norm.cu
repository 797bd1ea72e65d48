// RMSNorm with the (1 + gamma) gain, for Hopper (sm_90a), K10.
//
// No Pallas counterpart: the JAX package computes it in jnp
// (src/repro/models/layers.py:29, `rms_norm`).  This kernel exists for the
// port's own invariant: a row's bits must not depend on how many rows the
// call holds.  A library reduction picks its split of the row by the
// tensor's shape, so a prompt prefilled alone and the same prompt inside a
// batch could get means one f32 ulp apart, a bf16 output a step apart, and
// under W4A4 a different activation block scale.  Here every row is summed
// in one fixed order whatever the batch.
//
//   y[r, :] = (x[r, :] * rsqrt(sum_i x[r, i]^2 * (1 / d) + eps)) * (1 + gamma)   (f32, out in x's dtype)
//
// The sum: thread t of the block adds x[r, t], x[r, t + 256], ... in that
// order, the warps reduce by a fixed xor butterfly, and warp 0 adds the 8
// warp sums in warp order.  The mean is the sum times 1/d, as torch.mean
// computes it.
//
// What bounds it on this card: it reads each row once (plus gamma) and
// writes it once, a few operations an element: bound by those bytes, and at
// decode sizes (a few rows) by the launch.  Design: one block of 256 threads
// per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(THREADS) rms_norm_kernel(const void* __restrict__ x, const void* __restrict__ gamma,
                                                           void* __restrict__ y, int d, int x_bf16, int g_bf16,
                                                           float inv_d, float eps) {
  __shared__ float warp_sum[THREADS / 32];
  __shared__ float row_scale;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float ss = 0.0f;
  for (int i = tid; i < d; i += THREADS) {
    const float v = load(x, row + i, x_bf16);
    ss = __fmaf_rn(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (lane == 0) warp_sum[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float total = warp_sum[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) total = __fadd_rn(total, warp_sum[w]);
    row_scale = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
  }
  __syncthreads();
  const float r = row_scale;
  for (int i = tid; i < d; i += THREADS) {
    const float v = __fmul_rn(__fmul_rn(load(x, row + i, x_bf16), r), __fadd_rn(1.0f, load(gamma, i, g_bf16)));
    if (x_bf16)
      static_cast<__nv_bfloat16*>(y)[row + i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(y)[row + i] = v;
  }
}

}  // namespace

// x, y: (rows, d) contiguous, bf16 (x_bf16 = 1) or f32; gamma (d,) bf16
// (g_bf16 = 1) or f32.  Returns cudaErrorInvalidValue on arguments it does
// not take, else cudaGetLastError() after the launch.
extern "C" int rms_norm_launch(const void* x, const void* gamma, void* y, long long rows, int d, int x_bf16,
                               int g_bf16, float eps, void* stream) {
  if (rows < 0 || rows > 0x7fffffffLL || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  rms_norm_kernel<<<static_cast<unsigned>(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, gamma, y, d, x_bf16, g_bf16, 1.0f / static_cast<float>(d), eps);
  return static_cast<int>(cudaGetLastError());
}
