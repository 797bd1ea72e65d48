// Single-query decode attention over a RaZeR-packed KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `razer_kv_attention_pallas`
// (src/repro/kernels/razer_kv_attention.py:101, tile decode `_dequant_tile`).
//
//   out[b, h, :] = softmax(q[b, h] . K[b, :cur_len[b], h / G] / sqrt(hd))
//                  @ V[b, :cur_len[b], h / G]                     (f32)
//
// K and V arrive in the 4.5-bit wire format: (B, S, KVH, hd/2) code bytes,
// low nibble first, and (B, S, KVH, hd/16) meta bytes = SV sign << 7 | E4M3
// scale code (bias 7, subnormals 2^-6 * m/8); code 8 decodes to +-5.
//
// What bounds it on this card: each cache byte is read once and used by the
// G = H / KVH query rows of its head, a few operations per byte, so it is
// bound by the cache bytes up to cur_len (and, at small batch, by launch
// latency and the B * KVH blocks it has to spread over 132 SMs).
//
// Design: one block per (b, kv head) holding its G query rows.  It walks the
// sequence in chunks of SC positions and stops at cur_len[b]: positions past
// it would add exactly 0 to the online softmax, so reading them is wasted.
// Per chunk it dequantizes the K and V tiles into shared memory through two
// small tables (16 FP4 values, 128 E4M3 scales), computes the G x SC scores,
// masks positions >= cur_len with -1e30, and folds the chunk into the running
// max, sum and weighted V sum (expf).  The output is acc / max(l, 1e-30).  A
// split-S second pass for long caches is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SC = 32;
constexpr int THREADS = 128;
constexpr int MAX_G = 8;
constexpr int MAX_D_PER_THREAD = 2;  // hd <= 256

__constant__ float kFp4[16] = {0.0f,  0.5f,  1.0f,  1.5f,  2.0f,  3.0f,  4.0f,  6.0f,
                               -0.0f, -0.5f, -1.0f, -1.5f, -2.0f, -3.0f, -4.0f, -6.0f};

__constant__ float kE4M3[128] = {
    0.0f,     0.001953125f, 0.00390625f, 0.005859375f, 0.0078125f, 0.009765625f, 0.01171875f,
    0.013671875f, 0.015625f, 0.017578125f, 0.01953125f, 0.021484375f, 0.0234375f, 0.025390625f,
    0.02734375f, 0.029296875f, 0.03125f, 0.03515625f, 0.0390625f, 0.04296875f, 0.046875f,
    0.05078125f, 0.0546875f, 0.05859375f, 0.0625f, 0.0703125f, 0.078125f, 0.0859375f, 0.09375f,
    0.1015625f, 0.109375f, 0.1171875f, 0.125f, 0.140625f, 0.15625f, 0.171875f, 0.1875f,
    0.203125f, 0.21875f, 0.234375f, 0.25f, 0.28125f, 0.3125f, 0.34375f, 0.375f, 0.40625f,
    0.4375f, 0.46875f, 0.5f, 0.5625f, 0.625f, 0.6875f, 0.75f, 0.8125f, 0.875f, 0.9375f, 1.0f,
    1.125f, 1.25f, 1.375f, 1.5f, 1.625f, 1.75f, 1.875f, 2.0f, 2.25f, 2.5f, 2.75f, 3.0f, 3.25f,
    3.5f, 3.75f, 4.0f, 4.5f, 5.0f, 5.5f, 6.0f, 6.5f, 7.0f, 7.5f, 8.0f, 9.0f, 10.0f, 11.0f,
    12.0f, 13.0f, 14.0f, 15.0f, 16.0f, 18.0f, 20.0f, 22.0f, 24.0f, 26.0f, 28.0f, 30.0f, 32.0f,
    36.0f, 40.0f, 44.0f, 48.0f, 52.0f, 56.0f, 60.0f, 64.0f, 72.0f, 80.0f, 88.0f, 96.0f, 104.0f,
    112.0f, 120.0f, 128.0f, 144.0f, 160.0f, 176.0f, 192.0f, 208.0f, 224.0f, 240.0f, 256.0f,
    288.0f, 320.0f, 352.0f, 384.0f, 416.0f, 448.0f, 480.0f};

__global__ void __launch_bounds__(THREADS)
razer_kv_attention_kernel(const float* __restrict__ q, const uint8_t* __restrict__ k_codes,
                          const uint8_t* __restrict__ k_meta, const uint8_t* __restrict__ v_codes,
                          const uint8_t* __restrict__ v_meta, const int* __restrict__ cur_len,
                          float* __restrict__ out, int S, int KVH, int G, int hd, float scale) {
  extern __shared__ float smem[];
  __shared__ float fp4[16];
  __shared__ float e4m3[128];
  __shared__ float m_run[MAX_G], l_run[MAX_G], alpha[MAX_G];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / KVH;
  const int kh = blockIdx.x % KVH;
  const int H = KVH * G;
  const int half = hd / 2;
  const int nblk = hd / 16;
  const int kstride = hd + 1;  // padded rows: the score loop reads K by position

  float* q_s = smem;                 // (G, hd)
  float* k_s = q_s + G * hd;         // (SC, hd + 1)
  float* v_s = k_s + SC * kstride;   // (SC, hd)
  float* p_s = v_s + SC * hd;        // (G, SC)

  if (tid < 16) fp4[tid] = kFp4[tid];
  if (tid < 128) e4m3[tid] = kE4M3[tid];
  if (tid < G) {
    m_run[tid] = -1e30f;
    l_run[tid] = 0.0f;
  }
  const float* qb = q + ((size_t)b * H + (size_t)kh * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) q_s[i] = qb[i];

  float acc[MAX_D_PER_THREAD][MAX_G];
#pragma unroll
  for (int dd = 0; dd < MAX_D_PER_THREAD; ++dd)
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[dd][g] = 0.0f;

  const int len = min(cur_len[b], S);
  for (int s0 = 0; s0 < len; s0 += SC) {
    __syncthreads();  // the previous chunk is done with k_s / v_s / p_s
    for (int i = tid; i < SC * half; i += THREADS) {
      const int p = i / half;
      const int j = i % half;
      const int pos = s0 + p;
      float k_lo = 0.0f, k_hi = 0.0f, v_lo = 0.0f, v_hi = 0.0f;
      if (pos < S) {
        const size_t row = ((size_t)b * S + pos) * KVH + kh;
        const uint8_t kb = k_codes[row * half + j];
        const uint8_t km = k_meta[row * nblk + j / 8];
        const uint8_t vb = v_codes[row * half + j];
        const uint8_t vm = v_meta[row * nblk + j / 8];
        const float ks = e4m3[km & 0x7F], ksv = (km & 0x80) ? -5.0f : 5.0f;
        const float vs = e4m3[vm & 0x7F], vsv = (vm & 0x80) ? -5.0f : 5.0f;
        k_lo = ((kb & 0xF) == 8 ? ksv : fp4[kb & 0xF]) * ks;
        k_hi = ((kb >> 4) == 8 ? ksv : fp4[kb >> 4]) * ks;
        v_lo = ((vb & 0xF) == 8 ? vsv : fp4[vb & 0xF]) * vs;
        v_hi = ((vb >> 4) == 8 ? vsv : fp4[vb >> 4]) * vs;
      }
      k_s[p * kstride + 2 * j] = k_lo;
      k_s[p * kstride + 2 * j + 1] = k_hi;
      v_s[p * hd + 2 * j] = v_lo;
      v_s[p * hd + 2 * j + 1] = v_hi;
    }
    __syncthreads();
    for (int i = tid; i < G * SC; i += THREADS) {
      const int g = i / SC;
      const int p = i % SC;
      float sc = -1e30f;
      if (s0 + p < len) {
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot = fmaf(q_s[g * hd + d], k_s[p * kstride + d], dot);
        sc = dot * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    if (tid < G) {
      float* row = p_s + tid * SC;
      const float m_prev = m_run[tid];
      float m_new = m_prev;
      for (int p = 0; p < SC; ++p) m_new = fmaxf(m_new, row[p]);
      float sum = 0.0f;
      for (int p = 0; p < SC; ++p) {
        const float e = expf(row[p] - m_new);
        row[p] = e;
        sum += e;
      }
      const float a = expf(m_prev - m_new);
      l_run[tid] = l_run[tid] * a + sum;
      m_run[tid] = m_new;
      alpha[tid] = a;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < MAX_D_PER_THREAD; ++dd) {
      const int d = tid + dd * THREADS;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            float s = 0.0f;
            for (int p = 0; p < SC; ++p) s = fmaf(p_s[g * SC + p], v_s[p * hd + d], s);
            acc[dd][g] = acc[dd][g] * alpha[g] + s;
          }
        }
      }
    }
  }
  __syncthreads();
  float* ob = out + ((size_t)b * H + (size_t)kh * G) * hd;
#pragma unroll
  for (int dd = 0; dd < MAX_D_PER_THREAD; ++dd) {
    const int d = tid + dd * THREADS;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) ob[(size_t)g * hd + d] = acc[dd][g] / fmaxf(l_run[g], 1e-30f);
    }
  }
}

}  // namespace

// q (B, KVH * G, hd) f32; caches (B, S, KVH, hd/2 | hd/16) uint8; cur_len
// (B,) int32 on the device; out (B, KVH * G, hd) f32.  G <= 8, hd a multiple
// of 16 and <= 256.  Returns cudaGetLastError().
extern "C" int razer_kv_attention_launch(const void* q, const void* k_codes, const void* k_meta,
                                         const void* v_codes, const void* v_meta,
                                         const void* cur_len, void* out, int B, int S, int KVH,
                                         int G, int hd, void* stream) {
  if (G < 1 || G > MAX_G || hd % 16 != 0 || hd > THREADS * MAX_D_PER_THREAD)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)SC * (hd + 1) +
                                       (size_t)SC * hd + (size_t)G * SC);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(razer_kv_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf((float)hd);
  razer_kv_attention_kernel<<<B * KVH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
      static_cast<const uint8_t*>(k_meta), static_cast<const uint8_t*>(v_codes),
      static_cast<const uint8_t*>(v_meta), static_cast<const int*>(cur_len),
      static_cast<float*>(out), S, KVH, G, hd, scale);
  return static_cast<int>(cudaGetLastError());
}
