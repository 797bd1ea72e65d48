// The decode-attention body shared by the contiguous kernel (K3,
// razer_kv_attention.cu) and the paged kernels (K4 and K5,
// paged_kv_attention.cu): one block of THREADS threads attends the G query
// rows of one kv head against the first `len` positions of a RaZeR-packed
// KV cache, and writes their G output rows.
//
// The kernels differ only in where position p's packed row lives: K3 at
// (b, p) of a contiguous (B, S, KVH, .) cache, K4/K5 at slot p % ps of the
// physical page page_table[b, p / ps] of the pool.  Each passes that mapping
// as a functor; everything else -- the tile decode, the scores, the online
// softmax and the order of every floating-point operation -- is this one
// function, written with explicit fmaf so that the compiler cannot contract
// it differently in the two kernels.  So K4, given a page table that maps a
// sequence onto its pages, returns the bits K3 returns on the same bytes,
// and K5's query t returns the bits K4 returns at length cur_len + t + 1.
//
// Wire format: per (position, kv head) hd/2 code bytes, low nibble first,
// and hd/16 meta bytes = SV sign << 7 | E4M3 scale code (bias 7, subnormals
// 2^-6 * m/8); code 8 decodes to +-5.
//
// Per chunk of SC positions: decode the K and V tiles into shared memory
// through two small tables (16 FP4 values, 128 E4M3 scales), reading only
// positions < len (the rest are zeros and masked), compute the G x SC
// scores, mask positions >= len with -1e30, and fold the chunk into the
// running max, sum and weighted V sum (expf).  The output is
// acc / max(l, 1e-30).  A masked position adds exactly 0 to every sum, so
// the loop stops at len.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace razer_kv {

constexpr int SC = 32;
constexpr int THREADS = 128;
constexpr int MAX_G = 8;
constexpr int MAX_D_PER_THREAD = 2;  // hd <= 256

namespace {  // each including source (its own shared library) has its own tables

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

}  // namespace

// Dynamic shared memory (floats) the body needs for G query rows of width hd.
__host__ __device__ inline size_t smem_floats(int G, int hd) {
  return (size_t)G * hd + (size_t)SC * (hd + 1) + (size_t)SC * hd + (size_t)G * SC;
}

// qb: the G query rows (G, hd) f32 of this block; ob: its G output rows.
// row_of(p) is the index of position p's (kv head's) row in the codes
// (rows, hd/2) and meta (rows, hd/16) arrays; it is called for p < len only.
template <class RowOf>
__device__ __forceinline__ void attend(const float* __restrict__ qb,
                                       const uint8_t* __restrict__ k_codes,
                                       const uint8_t* __restrict__ k_meta,
                                       const uint8_t* __restrict__ v_codes,
                                       const uint8_t* __restrict__ v_meta, int len, RowOf row_of,
                                       float* __restrict__ ob, int G, int hd, float scale) {
  extern __shared__ float smem[];
  __shared__ float fp4[16];
  __shared__ float e4m3[128];
  __shared__ float m_run[MAX_G], l_run[MAX_G], alpha[MAX_G];

  const int tid = threadIdx.x;
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
  for (int i = tid; i < G * hd; i += THREADS) q_s[i] = qb[i];

  float acc[MAX_D_PER_THREAD][MAX_G];
#pragma unroll
  for (int dd = 0; dd < MAX_D_PER_THREAD; ++dd)
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[dd][g] = 0.0f;

  for (int s0 = 0; s0 < len; s0 += SC) {
    __syncthreads();  // the previous chunk is done with k_s / v_s / p_s
    for (int i = tid; i < SC * half; i += THREADS) {
      const int p = i / half;
      const int j = i % half;
      const int pos = s0 + p;
      float k_lo = 0.0f, k_hi = 0.0f, v_lo = 0.0f, v_hi = 0.0f;
      if (pos < len) {
        const size_t row = row_of(pos);
        const uint8_t kb = k_codes[row * half + j];
        const uint8_t km = k_meta[row * nblk + j / 8];
        const uint8_t vb = v_codes[row * half + j];
        const uint8_t vm = v_meta[row * nblk + j / 8];
        const float ks = e4m3[km & 0x7F], ksv = (km & 0x80) ? -5.0f : 5.0f;
        const float vs = e4m3[vm & 0x7F], vsv = (vm & 0x80) ? -5.0f : 5.0f;
        k_lo = __fmul_rn((kb & 0xF) == 8 ? ksv : fp4[kb & 0xF], ks);
        k_hi = __fmul_rn((kb >> 4) == 8 ? ksv : fp4[kb >> 4], ks);
        v_lo = __fmul_rn((vb & 0xF) == 8 ? vsv : fp4[vb & 0xF], vs);
        v_hi = __fmul_rn((vb >> 4) == 8 ? vsv : fp4[vb >> 4], vs);
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
        sc = __fmul_rn(dot, scale);
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
        const float e = expf(__fsub_rn(row[p], m_new));
        row[p] = e;
        sum = __fadd_rn(sum, e);
      }
      const float a = expf(__fsub_rn(m_prev, m_new));
      l_run[tid] = fmaf(l_run[tid], a, sum);
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
            acc[dd][g] = fmaf(acc[dd][g], alpha[g], s);
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int dd = 0; dd < MAX_D_PER_THREAD; ++dd) {
    const int d = tid + dd * THREADS;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) ob[(size_t)g * hd + d] = __fdiv_rn(acc[dd][g], fmaxf(l_run[g], 1e-30f));
    }
  }
}

}  // namespace razer_kv
