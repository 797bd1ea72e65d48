// The backward of GQA prefill attention, for Hopper (sm_90a): K9's backward.
//
// No Pallas counterpart: the JAX package differentiates its jnp
// `chunked_attention` (src/repro/models/attention.py:54) with XLA's
// autodiff.  The port's forward is a ctypes kernel (K9), which autograd
// cannot see through, so a train step needs this kernel for dq, dk and dv.
//
// With S = scale * Q K^T (masked), P = softmax(S) row by row, O = P V:
//   dV = P^T dO,   dP = dO V^T,   D_i = sum_d dO[i, d] O[i, d],
//   dS = P o (dP - D),   dQ = scale * dS K,   dK = scale * dS^T Q.
// Two kernels a call, all sums in f32 and in a fixed order, no atomics:
//   1. query-major (`prefill_attention_bwd_dq_kernel`): a block takes 64
//      query rows of one head; it walks their keys once for each row's max
//      m and sum l (the forward's softmax statistics, recomputed: K9's
//      forward stays as it is), computes D from O and dO, walks the keys
//      again for P = exp(S - m) / l, dP, dS and dQ, and writes m, l and D
//      to a workspace;
//   2. key-major (`prefill_attention_bwd_dkdv_kernel`): a block takes 64 keys
//      of one KV head and walks the G query heads of that KV head in order,
//      each over the query rows that see those keys, rebuilding P from the
//      workspace's m and l, and sums dV and dK.
// The masks are K9's: query i at position q_offset + i, key j at j;
// causal keeps j <= q_offset + i; window > 0 keeps j > q_offset + i -
// window.  q/k at hd 16, 32, 64 or 128 with V as wide (the wrapper refuses
// the rest).  Inputs and outputs are bf16 or f32, each tensor its own.
//
// What bounds it on this card: the operations, 4 head-width products per
// (query, key) pair kept by the mask in each pass (S twice, dP and dQ; S,
// dV, dP and dK), against the bytes of q, k, v, o, dO in and dq, dk, dv
// out.  Design, first version: CUDA cores in f32, 64 x 64 tiles staged
// in shared memory with padded rows (no bank conflicts), each of 256
// threads holding a 4 x 4 piece of a score tile and 4 rows of the output
// columns it owns; the tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BT = 64;        // query rows or keys of a tile
constexpr float NEG = -1e30f;  // K9's masked score

__device__ __forceinline__ float ld(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]) : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* ws;  // (B, H, Sq) x 3: m, l, D
  int q_bf16, k_bf16, v_bf16;
  int B, Sq, Skv, H, KVH, q_offset, causal, window;
  float scale;
};

__device__ __forceinline__ bool kept(const Args& a, int i, int j) {
  const int qp = a.q_offset + i;
  return i < a.Sq && j < a.Skv && (!a.causal || j <= qp) && (!a.window || j > qp - a.window);
}

// rows [r0, r0 + BT) of a (B, S, heads, HD) tensor at head h -> s[BT][HD + 1] f32, zeros past S
template <int HD>
__device__ __forceinline__ void load_tile(float* s, const void* src, int bf16, int b, int r0, int S, int heads,
                                          int h) {
  for (int e = threadIdx.x; e < BT * HD; e += THREADS) {
    const int r = e / HD, c = e % HD, row = r0 + r;
    s[r * (HD + 1) + c] =
        row < S ? ld(src, ((static_cast<size_t>(b) * S + row) * heads + h) * HD + c, bf16) : 0.0f;
  }
}

// acc[r][c] = sum_d A[ty + 16 r][d] * Bm[tx + 16 c][d] over HD
template <int HD>
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* A, const float* Bm, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ty + 16 * r) * (HD + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bm[(tx + 16 * c) * (HD + 1) + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
  }
}

// out[r][cc] += sum_t T[ty + 16 r][t] * M[t][tx + 16 cc] over the BT columns of T
template <int HD>
__device__ __forceinline__ void tile_accum(float out[4][HD / 16], const float* T, const float* M, int ty, int tx) {
#pragma unroll 4
  for (int t = 0; t < BT; ++t) {
    float tv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) tv[r] = T[(ty + 16 * r) * (BT + 1) + t];
#pragma unroll
    for (int cc = 0; cc < HD / 16; ++cc) {
      const float mv = M[t * (HD + 1) + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r) out[r][cc] = __fmaf_rn(tv[r], mv, out[r][cc]);
    }
  }
}

// max and sum over the 16 threads of one row (a half warp), by a fixed butterfly
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return (4 * BT * (HD + 1) + BT * (BT + 1) + 3 * BT) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(THREADS) prefill_attention_bwd_dq_kernel(Args a) {
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sdO = sQ + BT * (HD + 1);
  float* sK = sdO + BT * (HD + 1);
  float* sV = sK + BT * (HD + 1);
  float* sT = sV + BT * (HD + 1);  // the dS tile
  float* sD = sT + BT * (BT + 1);
  const int i0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<HD>(sQ, a.q, a.q_bf16, b, i0, a.Sq, a.H, h);
  load_tile<HD>(sdO, a.dout, a.q_bf16, b, i0, a.Sq, a.H, h);
  __syncthreads();
  if (tid < BT) {  // D of row tid, summed over d in order
    const int i = i0 + tid;
    float dsum = 0.0f;
    if (i < a.Sq) {
      const size_t base = ((static_cast<size_t>(b) * a.Sq + i) * a.H + h) * HD;
      for (int d = 0; d < HD; ++d) dsum = __fmaf_rn(sdO[tid * (HD + 1) + d], ld(a.o, base + d, a.q_bf16), dsum);
    }
    sD[tid] = dsum;
  }
  __syncthreads();
  // the keys any row of the tile keeps
  const int last_i = min(i0 + BT, a.Sq) - 1;
  const int j_end = a.causal ? min(a.Skv, a.q_offset + last_i + 1) : a.Skv;
  const int j_begin = a.window ? max(0, a.q_offset + i0 - a.window + 1) : 0;
  const int c_begin = (j_begin / BT) * BT;
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = NEG, l[r] = 0.0f;
  float s[4][4];
  for (int c0 = c_begin; c0 < j_end; c0 += BT) {  // pass 1: each row's max and sum
    __syncthreads();
    load_tile<HD>(sK, a.k, a.k_bf16, b, c0, a.Skv, a.KVH, kh);
    __syncthreads();
    tile_dot<HD>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      float cmax = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = kept(a, i, c0 + tx + 16 * c) ? __fmul_rn(s[r][c], a.scale) : NEG;
        cmax = fmaxf(cmax, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(cmax));
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) psum = __fadd_rn(psum, s[r][c] > NEG ? expf(s[r][c] - m_new) : 0.0f);
      l[r] = __fadd_rn(__fmul_rn(l[r], expf(m[r] - m_new)), row_sum(psum));
      m[r] = m_new;
    }
  }
  float dq[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < HD / 16; ++cc) dq[r][cc] = 0.0f;
  float dp[4][4];
  for (int c0 = c_begin; c0 < j_end; c0 += BT) {  // pass 2: P, dP, dS and dQ
    __syncthreads();
    load_tile<HD>(sK, a.k, a.k_bf16, b, c0, a.Skv, a.KVH, kh);
    load_tile<HD>(sV, a.v, a.v_bf16, b, c0, a.Skv, a.KVH, kh);
    __syncthreads();
    tile_dot<HD>(s, sQ, sK, ty, tx);
    tile_dot<HD>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      const float dr = sD[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = kept(a, i, c0 + tx + 16 * c) ? __fdiv_rn(expf(__fmul_rn(s[r][c], a.scale) - m[r]), l[r])
                                                     : 0.0f;
        sT[(ty + 16 * r) * (BT + 1) + tx + 16 * c] = __fmul_rn(p, __fsub_rn(dp[r][c], dr));
      }
    }
    __syncthreads();
    tile_accum<HD>(dq, sT, sK, ty, tx);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= a.Sq) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Sq + i) * a.H + h) * HD;
#pragma unroll
    for (int cc = 0; cc < HD / 16; ++cc) st(a.dq, base + tx + 16 * cc, __fmul_rn(dq[r][cc], a.scale), a.q_bf16);
    if (tx == 0) {
      const size_t w = (static_cast<size_t>(b) * a.H + h) * a.Sq + i, n = static_cast<size_t>(a.B) * a.H * a.Sq;
      a.ws[w] = m[r];
      a.ws[n + w] = l[r];
      a.ws[2 * n + w] = sD[ty + 16 * r];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) prefill_attention_bwd_dkdv_kernel(Args a) {
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + BT * (HD + 1);
  float* sQ = sV + BT * (HD + 1);
  float* sdO = sQ + BT * (HD + 1);
  float* sT = sdO + BT * (HD + 1);  // P, then dS, keys x queries
  float* sM = sT + BT * (BT + 1);
  float* sL = sM + BT;
  float* sD = sL + BT;
  const int j0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z, g = a.H / a.KVH;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<HD>(sK, a.k, a.k_bf16, b, j0, a.Skv, a.KVH, kh);
  load_tile<HD>(sV, a.v, a.v_bf16, b, j0, a.Skv, a.KVH, kh);
  float dk[4][HD / 16], dv[4][HD / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < HD / 16; ++cc) dk[r][cc] = dv[r][cc] = 0.0f;
  // the query rows that keep any key of the tile
  const int last_j = min(j0 + BT, a.Skv) - 1;
  const int i_begin = a.causal ? max(0, j0 - a.q_offset) : 0;
  const int i_end = a.window ? min(a.Sq, last_j + a.window - a.q_offset) : a.Sq;
  const size_t n = static_cast<size_t>(a.B) * a.H * a.Sq;
  float s[4][4], dp[4][4];
  for (int h = kh * g; h < (kh + 1) * g; ++h) {
    for (int c0 = (i_begin / BT) * BT; c0 < i_end; c0 += BT) {
      __syncthreads();
      load_tile<HD>(sQ, a.q, a.q_bf16, b, c0, a.Sq, a.H, h);
      load_tile<HD>(sdO, a.dout, a.q_bf16, b, c0, a.Sq, a.H, h);
      if (tid < BT) {
        const int i = c0 + tid;
        const size_t w = (static_cast<size_t>(b) * a.H + h) * a.Sq + i;
        sM[tid] = i < a.Sq ? a.ws[w] : 0.0f;
        sL[tid] = i < a.Sq ? a.ws[n + w] : 1.0f;
        sD[tid] = i < a.Sq ? a.ws[2 * n + w] : 0.0f;
      }
      __syncthreads();
      tile_dot<HD>(s, sK, sQ, ty, tx);   // keys ty + 16 r, queries tx + 16 c
      tile_dot<HD>(dp, sV, sdO, ty, tx);
      float p[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tx + 16 * c;
          p[r][c] = kept(a, c0 + qi, j0 + ty + 16 * r)
                        ? __fdiv_rn(expf(__fmul_rn(s[r][c], a.scale) - sM[qi]), sL[qi])
                        : 0.0f;
          sT[(ty + 16 * r) * (BT + 1) + qi] = p[r][c];
        }
      __syncthreads();
      tile_accum<HD>(dv, sT, sdO, ty, tx);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tx + 16 * c;
          sT[(ty + 16 * r) * (BT + 1) + qi] = __fmul_rn(p[r][c], __fsub_rn(dp[r][c], sD[qi]));
        }
      __syncthreads();
      tile_accum<HD>(dk, sT, sQ, ty, tx);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= a.Skv) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Skv + j) * a.KVH + kh) * HD;
#pragma unroll
    for (int cc = 0; cc < HD / 16; ++cc) {
      st(a.dk, base + tx + 16 * cc, __fmul_rn(dk[r][cc], a.scale), a.k_bf16);
      st(a.dv, base + tx + 16 * cc, dv[r][cc], a.v_bf16);
    }
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(smem_bytes<HD>());
  cudaError_t e = cudaFuncSetAttribute(prefill_attention_bwd_dq_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(prefill_attention_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gq((a.Sq + BT - 1) / BT, a.H, a.B), gk((a.Skv + BT - 1) / BT, a.KVH, a.B);
  prefill_attention_bwd_dq_kernel<HD><<<gq, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  prefill_attention_bwd_dkdv_kernel<HD><<<gk, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq (B, Sq, H, hd); k, v, dk, dv (B, Skv, KVH, hd); all
// contiguous, bf16 or f32 (o, dout and dq in q's dtype; dk in k's, dv in
// v's); ws (3, B, H, Sq) f32.  Returns cudaErrorInvalidValue on arguments it
// does not take, else cudaGetLastError() after the two launches.
extern "C" int prefill_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                            const void* dout, void* dq, void* dk, void* dv, void* ws, int q_bf16,
                                            int k_bf16, int v_bf16, int B, int Sq, int Skv, int H, int KVH, int hd,
                                            int q_offset, int causal, int window, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH || q_offset < 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(ws), q_bf16, k_bf16, v_bf16,
               B, Sq, Skv, H, KVH, q_offset, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
