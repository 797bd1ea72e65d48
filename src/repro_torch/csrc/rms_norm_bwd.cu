// The backward of RMSNorm with the (1 + gamma) gain, for Hopper (sm_90a):
// K10's backward.
//
// No Pallas counterpart: the JAX package differentiates its jnp `rms_norm`
// (src/repro/models/layers.py:29) with XLA's autodiff.  The port's forward
// is a ctypes kernel (K10), which autograd cannot see through, so a train
// step needs this kernel for the gradients of every norm's input and gain.
//
//   y = x * r * (1 + gamma),   r = rsqrt(sum_i x_i^2 * (1 / d) + eps)
//   dx_i    = r * (1 + gamma_i) * dy_i - x_i * r^3 / d * sum_k dy_k (1 + gamma_k) x_k
//   dgamma  = sum over rows of dy * x * r                                        (all in f32)
//
// r is summed exactly as K10 sums it (thread t adds x[t], x[t + 256], ...;
// a fixed xor butterfly; warp 0 adds the 8 warp sums in warp order), so it
// is K10's r bit for bit.
//
// dgamma is a sum over rows.  Pass 1 (`rms_norm_bwd_rows_kernel`) runs a
// fixed number of blocks that depends on the row count alone; block b
// takes rows b, b + G, b + 2G, ... in that order and sums its dy * x * r in
// shared memory, where each column belongs to one thread, then writes its
// partial row.  Pass 2 (`rms_norm_bwd_gamma_kernel`) adds the G partials of
// each column in block order.  No float atomics: a step's bits repeat.
//
// What bounds it on this card: it reads x and dy once and writes dx once
// (plus gamma, dgamma and the partials), a few operations an element: bound
// by those bytes.  Design: one block of 256 threads per row at a time, the
// partials in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 256;  // pass 1's blocks: min(rows, this), whatever the card

__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Block sum of one value a thread in K10's order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* warp_sum, float* total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float t = warp_sum[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) t = __fadd_rn(t, warp_sum[w]);
    *total = t;
  }
  __syncthreads();
  return *total;
}

__global__ void __launch_bounds__(THREADS) rms_norm_bwd_rows_kernel(
    const void* __restrict__ x, const void* __restrict__ gamma, const void* __restrict__ dy, void* __restrict__ dx,
    float* __restrict__ partial, long long rows, int d, int x_bf16, int g_bf16, float inv_d, float eps) {
  extern __shared__ float acc[];  // this block's dgamma partial, d columns
  __shared__ float warp_sum[THREADS / 32];
  __shared__ float total;
  const int tid = threadIdx.x;
  for (int i = tid; i < d; i += THREADS) acc[i] = 0.0f;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * d;
    float ss = 0.0f;
    for (int i = tid; i < d; i += THREADS) {
      const float v = load(x, row + i, x_bf16);
      ss = __fmaf_rn(v, v, ss);
    }
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss, warp_sum, &total), inv_d), eps));
    float dot = 0.0f;
    for (int i = tid; i < d; i += THREADS) {
      const float g = __fmul_rn(load(dy, row + i, x_bf16), __fadd_rn(1.0f, load(gamma, i, g_bf16)));
      dot = __fmaf_rn(g, load(x, row + i, x_bf16), dot);
    }
    __syncthreads();  // warp_sum is reused
    const float c = __fmul_rn(__fmul_rn(block_sum(dot, warp_sum, &total), __fmul_rn(rs, __fmul_rn(rs, rs))), inv_d);
    for (int i = tid; i < d; i += THREADS) {
      const float xv = load(x, row + i, x_bf16), dyv = load(dy, row + i, x_bf16);
      const float g = __fmul_rn(dyv, __fadd_rn(1.0f, load(gamma, i, g_bf16)));
      store(dx, row + i, __fsub_rn(__fmul_rn(g, rs), __fmul_rn(xv, c)), x_bf16);
      acc[i] = __fmaf_rn(dyv, __fmul_rn(xv, rs), acc[i]);  // column i is this thread's alone
    }
    __syncthreads();
  }
  for (int i = tid; i < d; i += THREADS) partial[static_cast<size_t>(blockIdx.x) * d + i] = acc[i];
}

__global__ void rms_norm_bwd_gamma_kernel(const float* __restrict__ partial, void* __restrict__ dgamma, int blocks,
                                          int d, int g_bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s = __fadd_rn(s, partial[static_cast<size_t>(b) * d + i]);
  store(dgamma, i, s, g_bf16);
}

}  // namespace

// The number of pass-1 blocks (and partial rows) for `rows` rows: the
// wrapper allocates the (blocks, d) f32 partials.
extern "C" int rms_norm_bwd_blocks(long long rows) {
  return static_cast<int>(rows < MAX_BLOCKS ? rows : MAX_BLOCKS);
}

// x, dy, dx: (rows, d) contiguous, bf16 (x_bf16 = 1; dy and dx in x's
// dtype) or f32; gamma, dgamma (d,) bf16 (g_bf16 = 1) or f32; partial
// (rms_norm_bwd_blocks(rows), d) f32.  Returns cudaErrorInvalidValue on
// arguments it does not take, else cudaGetLastError() after the launches.
extern "C" int rms_norm_bwd_launch(const void* x, const void* gamma, const void* dy, void* dx, void* dgamma,
                                   void* partial, long long rows, int d, int x_bf16, int g_bf16, float eps,
                                   void* stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (rows < 1 || d < 1 || smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(rms_norm_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = rms_norm_bwd_blocks(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rms_norm_bwd_rows_kernel<<<blocks, THREADS, smem, s>>>(x, gamma, dy, dx, static_cast<float*>(partial), rows, d,
                                                          x_bf16, g_bf16, 1.0f / static_cast<float>(d), eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_bwd_gamma_kernel<<<(d + THREADS - 1) / THREADS, THREADS, 0, s>>>(static_cast<const float*>(partial), dgamma,
                                                                           blocks, d, g_bf16);
  return static_cast<int>(cudaGetLastError());
}
