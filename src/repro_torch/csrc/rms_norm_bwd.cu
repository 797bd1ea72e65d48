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
// a fixed xor butterfly; the 8 warp sums added in warp order), so it is
// K10's r bit for bit.
//
// dgamma is a sum over rows.  Pass 1 (`rms_norm_bwd_rows_kernel`) runs a
// fixed number of blocks that depends on the row count alone; block b
// takes rows b, b + G, b + 2G, ... in that order and sums its dy * x * r in
// shared memory, where each column belongs to one thread, then writes its
// partial row.  Pass 2 (`rms_norm_bwd_gamma_kernel`) adds the G partials of
// each column in a fixed order: 8 groups of consecutive blocks, each summed
// in block order, then the groups in order.  No float atomics: a step's
// bits repeat.
//
// What bounds it on this card: it reads x and dy once and writes dx once
// (plus gamma, dgamma and the G x d f32 partials, written once and read
// once: 6.5 MB at G 264, d 3072), a few operations an element: bound by
// those bytes.  Design:
//  * each row is read from device memory once: its x and dy land in shared
//    memory by 16-byte cp.async copies and serve all three uses (r, the dot
//    product, dx and the partial);
//  * a ring of up to three row stages: a block's next two rows are in
//    flight while it computes one (264 blocks, two an SM at d 3072);
//  * r and the dot product share one pass and one block reduction; 1 +
//    gamma is computed once a block into shared memory; the kernel is
//    built for each dtype, so shared memory is read as such;
//  * rows whose bytes are not a multiple of 16 (or a base not 16-byte
//    aligned), or too wide for one stage, are read from device memory in
//    each use instead (nst 0): the same arithmetic, the same bits;
//  * a partial row too wide for shared memory (d > 58096) is summed in
//    place in `partial`, each column by its own thread: the same bits.
// Tried and set aside (tools/backward_timing.py times what stays): 16-byte
// or column-pair passes for the dot product, dx and the partial (bank
// conflicts on the f32 partial, or no gain), and 396 or 528 blocks (the
// gamma pass grows by what the rows pass saves).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "razer_matmul_tile.cuh"  // cp.async

namespace {

using razer_tile::cp_async16;
using razer_tile::cp_async_commit;
using razer_tile::cp_async_wait;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 264;     // pass 1's blocks: min(rows, this), whatever the card (two an H100 SM)
constexpr int MAX_STAGES = 3;       // rows staged in shared memory at once, the one computed among them
constexpr size_t SMEM_MAX = 232448 - 64;  // dynamic shared memory a block can have on an H100, beside
                                          // the kernel's 64 static bytes
constexpr size_t SMEM_TWO = 113 * 1024;  // at most this, two blocks fit an SM
constexpr int GAMMA_COLS = 32, GAMMA_GROUPS = 8;  // pass 2's block: 32 columns x 8 groups of partials

__device__ __forceinline__ float load(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The block sums of two values a thread, each in K10's order (xor
// butterfly, then the 8 warp sums in warp order); every thread gets both.
// `warp_sum` (16 floats) is free again after the caller's next barrier.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  if (lane == 0) warp_sum[warp] = a, warp_sum[THREADS / 32 + warp] = b;
  __syncthreads();
  a = warp_sum[0], b = warp_sum[THREADS / 32];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) {
    a = __fadd_rn(a, warp_sum[w]);
    b = __fadd_rn(b, warp_sum[THREADS / 32 + w]);
  }
}

// the shared memory of pass 1: the partial (d f32) if `part`, 1 + gamma (d
// f32) if `gain`, `nst` stages of an x row and a dy row (each padded to 16
// bytes)
__host__ __device__ inline size_t rows_smem(int d, int es, int nst, int gain, int part = 1) {
  const size_t dp = (static_cast<size_t>(d) + 3) & ~static_cast<size_t>(3);
  const size_t rb = (static_cast<size_t>(d) * es + 15) & ~static_cast<size_t>(15);
  return dp * 4 * (part + gain) + static_cast<size_t>(nst) * 2 * rb;
}

__device__ __forceinline__ float tof(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// Pass 1, for x and dy of one dtype T (bf16 or f32).  Thread t takes
// columns t, t + 256, ... in every use (r's sum in K10's order, the dot
// product, dx, the partial), whether the row is staged or read from device
// memory, so the bits do not depend on the staging.
template <typename T, bool PART>
__global__ void __launch_bounds__(THREADS) rms_norm_bwd_rows_kernel(
    const T* __restrict__ x, const void* __restrict__ gamma, const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ partial, long long rows, int d, int g_bf16, float inv_d, float eps, int nst, int gain) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float warp_sum[2 * THREADS / 32];
  const int tid = threadIdx.x;
  const size_t dp = (static_cast<size_t>(d) + 3) & ~static_cast<size_t>(3);
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T), rb = (row_bytes + 15) & ~static_cast<size_t>(15);
  // this block's dgamma partial, d columns: in shared memory (PART), else in place in `partial`
  float* acc = PART ? reinterpret_cast<float*>(smem) : partial + static_cast<size_t>(blockIdx.x) * d;
  float* g1 = reinterpret_cast<float*>(smem) + (PART ? dp : 0);  // 1 + gamma, where `gain`
  uint8_t* ring = reinterpret_cast<uint8_t*>(g1 + (gain ? dp : 0));
  for (int i = tid; i < d; i += THREADS) {
    acc[i] = 0.0f;
    if (gain) g1[i] = __fadd_rn(1.0f, load(gamma, i, g_bf16));
  }
  const long long mine = (rows - blockIdx.x + gridDim.x - 1) / gridDim.x;  // rows b, b + G, ...
  auto issue = [&](long long k) {  // this block's k-th row into stage k % nst: a group, empty past the last
    if (k < mine) {
      const size_t off = static_cast<size_t>(blockIdx.x + k * gridDim.x) * row_bytes;
      uint8_t* st = ring + static_cast<size_t>(k % nst) * 2 * rb;
      for (size_t c = tid; c < row_bytes / 16; c += THREADS) {
        cp_async16(st + 16 * c, reinterpret_cast<const uint8_t*>(x) + off + 16 * c, true);
        cp_async16(st + rb + 16 * c, reinterpret_cast<const uint8_t*>(dy) + off + 16 * c, true);
      }
    }
    cp_async_commit();
  };
  auto one_plus_gamma = [&](int i) { return gain ? g1[i] : __fadd_rn(1.0f, load(gamma, i, g_bf16)); };
  for (int k = 0; k < nst - 1; ++k) issue(k);
  __syncthreads();  // acc and g1 are set
  for (long long k = 0; k < mine; ++k) {
    const size_t row = static_cast<size_t>(blockIdx.x + k * gridDim.x) * d;
    const T *xr = x + row, *dyr = dy + row;
    if (nst) {
      issue(k + nst - 1);
      if (nst == 3)
        cp_async_wait<2>();
      else if (nst == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // everyone's copies of row k have landed
      xr = reinterpret_cast<const T*>(ring + static_cast<size_t>(k % nst) * 2 * rb);
      dyr = reinterpret_cast<const T*>(ring + static_cast<size_t>(k % nst) * 2 * rb + rb);
    }
    float ss = 0.0f, dot = 0.0f;
    for (int i = tid; i < d; i += THREADS) {
      const float v = tof(xr[i]);
      ss = __fmaf_rn(v, v, ss);
      dot = __fmaf_rn(__fmul_rn(tof(dyr[i]), one_plus_gamma(i)), v, dot);
    }
    block_sum2(ss, dot, warp_sum);
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(ss, inv_d), eps));
    const float c = __fmul_rn(__fmul_rn(dot, __fmul_rn(rs, __fmul_rn(rs, rs))), inv_d);
    for (int i = tid; i < d; i += THREADS) {
      const float xv = tof(xr[i]), dyv = tof(dyr[i]);
      put(dx + row + i, __fsub_rn(__fmul_rn(__fmul_rn(dyv, one_plus_gamma(i)), rs), __fmul_rn(xv, c)));
      acc[i] = __fmaf_rn(dyv, __fmul_rn(xv, rs), acc[i]);  // column i is this thread's alone
    }
    __syncthreads();  // the stage and warp_sum are read: both may be refilled
  }
  if (PART)
    for (int i = tid; i < d; i += THREADS) partial[static_cast<size_t>(blockIdx.x) * d + i] = acc[i];
}

// Column blockIdx.x * 32 + threadIdx.x: group threadIdx.y sums its run of
// consecutive blocks' partials in block order, then the 8 groups add in order.
__global__ void __launch_bounds__(GAMMA_COLS * GAMMA_GROUPS) rms_norm_bwd_gamma_kernel(
    const float* __restrict__ partial, void* __restrict__ dgamma, int blocks, int d, int g_bf16) {
  __shared__ float part[GAMMA_GROUPS][GAMMA_COLS];
  const int i = blockIdx.x * GAMMA_COLS + threadIdx.x, per = (blocks + GAMMA_GROUPS - 1) / GAMMA_GROUPS;
  float s = 0.0f;
  if (i < d) {
    const int b1 = min(blocks, (threadIdx.y + 1) * per);
    for (int b = threadIdx.y * per; b < b1; ++b) s = __fadd_rn(s, partial[static_cast<size_t>(b) * d + i]);
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < d) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int g = 1; g < GAMMA_GROUPS; ++g) t = __fadd_rn(t, part[g][threadIdx.x]);
    store(dgamma, i, t, g_bf16);
  }
}

// Pass 1 for x and dy of dtype T, its partial row in shared memory where
// `part` (which the kernel then addresses as such), else in `partial`.
template <typename T>
cudaError_t launch_rows(const void* x, const void* gamma, const void* dy, void* dx, float* partial, long long rows,
                        int d, int g_bf16, float inv_d, float eps, int nst, int gain, bool part, int blocks,
                        size_t smem, cudaStream_t s) {
  const auto kernel = part ? rms_norm_bwd_rows_kernel<T, true> : rms_norm_bwd_rows_kernel<T, false>;
  kernel<<<blocks, THREADS, smem, s>>>(static_cast<const T*>(x), gamma, static_cast<const T*>(dy),
                                       static_cast<T*>(dx), partial, rows, d, g_bf16, inv_d, eps, nst, gain);
  return cudaGetLastError();
}

}  // namespace

// The number of pass-1 blocks (and partial rows) for `rows` rows: the
// wrapper allocates the (blocks, d) f32 partials.
extern "C" int rms_norm_bwd_blocks(long long rows) {
  return static_cast<int>(rows < MAX_BLOCKS ? rows : MAX_BLOCKS);
}

// x, dy, dx: (rows, d) contiguous, bf16 (x_bf16 = 1; dy and dx in x's
// dtype) or f32; gamma, dgamma (d,) bf16 (g_bf16 = 1) or f32; partial
// (rms_norm_bwd_blocks(rows), d) f32.  Takes any d.  Returns
// cudaErrorInvalidValue on arguments it does not take, else
// cudaGetLastError() after the launches.
extern "C" int rms_norm_bwd_launch(const void* x, const void* gamma, const void* dy, void* dx, void* dgamma,
                                   void* partial, long long rows, int d, int x_bf16, int g_bf16, float eps,
                                   void* stream) {
  const int es = x_bf16 ? 2 : 4;
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  // stage rows where they can be copied in 16-byte pieces: the most stages, then the cached gain, that fit
  // two blocks an SM, else one; the partial row in shared memory where it fits
  const bool aligned = (static_cast<size_t>(d) * es) % 16 == 0 &&
                       ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  const int part = rows_smem(d, es, 0, 0) <= SMEM_MAX;
  int nst = 0, gain = rows_smem(d, es, 0, 1) <= SMEM_MAX;
  const size_t limits[2] = {SMEM_TWO, SMEM_MAX};
  for (int li = 0; li < 2 && aligned && !nst; ++li)
    for (int st = MAX_STAGES; st >= 1 && !nst; --st)
      if (rows_smem(d, es, st, 1) <= limits[li]) nst = st, gain = 1;
  static unsigned configured = 0;  // devices whose shared-memory limits are raised, as a bit set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(rms_norm_bwd_rows_kernel<__nv_bfloat16, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_MAX));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rms_norm_bwd_rows_kernel<float, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_MAX));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1u << dev;
  }
  const int blocks = rms_norm_bwd_blocks(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = rows_smem(d, es, nst, gain, part);
  const float inv_d = 1.0f / static_cast<float>(d);
  e = (x_bf16 ? launch_rows<__nv_bfloat16> : launch_rows<float>)(x, gamma, dy, dx, static_cast<float*>(partial), rows,
                                                                   d, g_bf16, inv_d, eps, nst, gain, part, blocks,
                                                                   smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_bwd_gamma_kernel<<<(d + GAMMA_COLS - 1) / GAMMA_COLS, dim3(GAMMA_COLS, GAMMA_GROUPS), 0, s>>>(
      static_cast<const float*>(partial), dgamma, blocks, d, g_bf16);
  return static_cast<int>(cudaGetLastError());
}
