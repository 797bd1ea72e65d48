// RaZeR packed-weight GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `razer_matmul_pallas`
// (src/repro/kernels/razer_matmul.py:112, tile decode `_decode_weight_tile`).
//
//   y[M, N] (f32) = x[M, K] @ dequant(codes[K/2, N], scale_meta[K/16, N])
//
// The tensor scale is not applied here: the Python wrapper multiplies it in
// the epilogue, as the JAX wrapper does.
//
// What bounds it on this card: at decode (M = batch, a handful of rows) every
// weight byte is used M times, far below the ~295 operations per byte where
// the H100 turns compute bound, so the kernel is bound by the 4.5-bit weight
// bytes it streams from HBM.  At prefill (M = batch x bucket) it does
// 2*M*K*N operations on SIMT FMA units.
//
// Design:
//  * one block owns a BM x BN output tile and loops over its share of K in
//    BK-deep steps; each step decodes the (BK/2, BN) code tile and the
//    (BK/16, BN) scale/meta tile into shared memory, reading the bytes once,
//    coalesced along N;
//  * decode goes through two small tables in shared memory (16 FP4 values,
//    code 8 -> the block's special value, and 64 E3M3 scales); value x scale
//    is rounded to bf16, which is exact for the repo's SV sets, so the tile
//    equals the plain version's weights divided by the tensor scale;
//  * x is rounded to bf16 as the TPU kernel does; products of two bf16
//    values are exact in f32, so the f32 FMAs differ from the plain version
//    only in summation order;
//  * rows past M are zero in the x tile (the M padding lives in the kernel),
//    and the row tile shrinks from 16 to 4 rows when M <= 4;
//  * decode-sized M gives too few output tiles to fill 132 SMs, so K is split
//    over gridDim.z; each split writes its partial tile and a second kernel
//    sums the splits in a fixed order (deterministic, no atomics).
//  wgmma, TMA and a pipelined ring of tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;  // 4; a tile has ROW_GROUPS * ROWS rows

__constant__ float kFp4[16] = {0.0f,  0.5f,  1.0f,  1.5f,  2.0f,  3.0f,  4.0f,  6.0f,
                               -0.0f, -0.5f, -1.0f, -1.5f, -2.0f, -3.0f, -4.0f, -6.0f};

__constant__ float kE3M3[64] = {
    0.0f,  0.03125f, 0.0625f, 0.09375f, 0.125f, 0.15625f, 0.1875f, 0.21875f,
    0.25f, 0.28125f, 0.3125f, 0.34375f, 0.375f, 0.40625f, 0.4375f, 0.46875f,
    0.5f,  0.5625f,  0.625f,  0.6875f,  0.75f,  0.8125f,  0.875f,  0.9375f,
    1.0f,  1.125f,   1.25f,   1.375f,   1.5f,   1.625f,   1.75f,   1.875f,
    2.0f,  2.25f,    2.5f,    2.75f,    3.0f,   3.25f,    3.5f,    3.75f,
    4.0f,  4.5f,     5.0f,    5.5f,     6.0f,   6.5f,     7.0f,    7.5f,
    8.0f,  9.0f,     10.0f,   11.0f,    12.0f,  13.0f,    14.0f,   15.0f,
    16.0f, 18.0f,    20.0f,   22.0f,    24.0f,  26.0f,    28.0f,   30.0f};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_bf16(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_bf16(const float* p) { return bf16_round(*p); }

// ROWS output rows per thread: 4 (BM = 16) in general, 1 (BM = 4) when M is
// at most 4, so that decode does not spend three quarters of its FMAs on
// padding rows.
template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS)
razer_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                    const uint8_t* __restrict__ scale_meta, float* __restrict__ out,
                    int M, int K, int N, int k_tiles_per_split, float m0, float m1) {
  constexpr int BM = ROW_GROUPS * ROWS;
  __shared__ float w_tile[BK][BN];
  __shared__ float x_tile[BM][BK + 1];
  __shared__ float fp4[16];
  __shared__ float e3m3[64];

  const int tid = threadIdx.x;
  if (tid < 16) fp4[tid] = kFp4[tid];
  if (tid < 64) e3m3[tid] = kE3M3[tid];

  const int col = tid % BN;
  const int row_group = tid / BN;
  const int n = blockIdx.x * BN + col;
  const int m_base = blockIdx.y * BM;
  const int kt_begin = blockIdx.z * k_tiles_per_split;
  const int kt_end = min(kt_begin + k_tiles_per_split, K / BK);

  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.0f;

  __syncthreads();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    // decode the (BK/2, BN) code bytes: this thread takes byte rows
    // row_group, row_group + 4, ... of its column
#pragma unroll
    for (int j = 0; j < BK / 2 / ROW_GROUPS; ++j) {
      const int br = row_group + ROW_GROUPS * j;
      float w_lo = 0.0f, w_hi = 0.0f;
      if (n < N) {
        const uint8_t byte = codes[(size_t)(k0 / 2 + br) * N + n];
        const uint8_t meta = scale_meta[(size_t)(k0 / 16 + br / 8) * N + n];
        const float scale = e3m3[meta & 0x3F];
        const float mag = (meta & 0x80) ? m1 : m0;  // select bit
        const float sv = (meta & 0x40) ? -mag : mag;  // sign bit
        const int lo = byte & 0xF;
        const int hi = byte >> 4;
        w_lo = (lo == 8 ? sv : fp4[lo]) * scale;
        w_hi = (hi == 8 ? sv : fp4[hi]) * scale;
      }
      w_tile[2 * br][col] = bf16_round(w_lo);
      w_tile[2 * br + 1][col] = bf16_round(w_hi);
    }
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK;
      const int c = idx % BK;
      const int m = m_base + r;
      x_tile[r][c] = (m < M) ? load_bf16(x + (size_t)m * K + k0 + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float w = w_tile[kk][col];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        acc[i] = fmaf(x_tile[row_group + ROW_GROUPS * i][kk], w, acc[i]);
    }
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int m = m_base + row_group + ROW_GROUPS * i;
    if (m < M && n < N) dst[(size_t)m * N + n] = acc[i];
  }
}

// out[i] = sum over s of partial[s][i], in order s = 0, 1, ...
__global__ void sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  long long count, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = partial[i];
    for (int k = 1; k < splits; ++k) s += partial[(size_t)k * count + i];
    out[i] = s;
  }
}

}  // namespace

// x: (M, K) bf16 (x_is_bf16 = 1) or f32, row-major; codes (K/2, N) and
// scale_meta (K/16, N) uint8; out (M, N) f32.  With splits > 1, partial
// holds (splits, M, N) f32 scratch.  K must be a multiple of 64.  Row tiles
// are 4 rows when M <= 4, else 16.
// Returns cudaGetLastError() after the launches.
extern "C" int razer_matmul_launch(const void* x, int x_is_bf16, const void* codes,
                                   const void* scale_meta, void* partial, void* out, int M,
                                   int K, int N, int splits, int k_tiles_per_split, float m0,
                                   float m1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(partial) : static_cast<float*>(out);
  const int bm = M <= ROW_GROUPS ? ROW_GROUPS : 4 * ROW_GROUPS;
  dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, splits);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const uint8_t* s = static_cast<const uint8_t*>(scale_meta);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* xf = static_cast<const float*>(x);
  if (x_is_bf16 && bm == ROW_GROUPS) {
    razer_matmul_kernel<__nv_bfloat16, 1><<<grid, THREADS, 0, st>>>(xb, c, s, dst, M, K, N, k_tiles_per_split, m0, m1);
  } else if (x_is_bf16) {
    razer_matmul_kernel<__nv_bfloat16, 4><<<grid, THREADS, 0, st>>>(xb, c, s, dst, M, K, N, k_tiles_per_split, m0, m1);
  } else if (bm == ROW_GROUPS) {
    razer_matmul_kernel<float, 1><<<grid, THREADS, 0, st>>>(xf, c, s, dst, M, K, N, k_tiles_per_split, m0, m1);
  } else {
    razer_matmul_kernel<float, 4><<<grid, THREADS, 0, st>>>(xf, c, s, dst, M, K, N, k_tiles_per_split, m0, m1);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long long count = (long long)M * N;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                             static_cast<float*>(out), count, splits);
  return static_cast<int>(cudaGetLastError());
}
