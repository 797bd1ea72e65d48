// Causal GQA prefill attention for Hopper (sm_90a), K9.
//
// No Pallas counterpart: the JAX package computes full-sequence attention
// in jnp outside any kernel (src/repro/models/attention.py:54,
// `chunked_attention`).  This kernel exists for the port's own invariant:
// a row's output must not depend on the rows around it, so that serving a
// prompt alone at its bucket gives the bits of generating it inside a
// padded batch.  Batched matmuls do not give that (the library picks its
// summation by shape); here every query row walks its keys the same way
// whatever B, Sq, the padded Skv or its place in a tile.
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * scale) @ v[b, j, h / G]
//   over keys j <= q_offset + i (causal) or all j < Skv
//
// Arithmetic, per query row (the plain version's, chunk by chunk):
//  * keys go in chunks of W = 64 positions from position 0 up to the row's
//    causal limit; a chunk past the limit is not visited, a key past it
//    inside the last chunk scores -1e30, so its p is exactly 0;
//  * score = (sum over d, in d order, of q_d k_d, one f32 FMA each) x scale;
//  * m' = max(m, chunk max); p = exp(score - m'); alpha = exp(m - m');
//    l = l alpha + (p summed by a fixed butterfly over the chunk);
//  * p is rounded to V's dtype, pv = sum over the chunk in key order of p v
//    (FMA), acc = acc alpha + pv;
//  * out = acc / max(l, 1e-30), in q's dtype.
// So a row's bits depend only on its q, the keys and values at or before
// its position, and its position.
//
// What bounds it on this card: 4 x hd operations per (query, key) pair on
// the f32 CUDA cores (the tensor cores are left for a later version), about
// 2 x Sq x Skv x H x 2 hd for a causal prefill; the bytes are q, k, v and
// out once.  At the prefill shapes it is bound by those operations.
//
// Design: a block owns 64 query positions of one head and walks 64-key
// chunks of its kv head: it stages the chunk's K and V in shared memory
// (converted to f32), each of its 256 threads computes a 4 x 4 tile of
// scores (rows ty + 16 r, keys tx + 16 c: conflict-free float4 reads), a
// row's 16 threads share one half-warp for the max and the sum, P goes
// through shared memory, and each thread accumulates 4 rows x hd / 16
// dims of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query positions per block
constexpr int W = 64;        // keys per chunk
constexpr int THREADS = 256;
constexpr int PSTRIDE = 80;  // P row stride (floats): the two rows a warp writes fall in distinct banks

template <int HD>
struct Smem {
  static constexpr int QK_STRIDE = HD + 4;  // padded: a phase's 8 key rows hit distinct banks
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * QK_STRIDE;
  static constexpr int V = K + W * QK_STRIDE;
  static constexpr int P = V + W * HD;
  static constexpr int FLOATS = P + BQ * PSTRIDE;
  static constexpr int BYTES = FLOATS * 4;
};

struct Params {
  const void* q;  // (B, Sq, H, HD)
  const void* k;  // (B, Skv, KVH, HD)
  const void* v;
  void* out;      // (B, Sq, H, HD), q's dtype
  int q_bf16, k_bf16, v_bf16;  // 1: bf16, 0: f32
  int B, Sq, Skv, H, KVH, q_offset, causal;
  float scale;
};

__device__ __forceinline__ float load_f32(const void* base, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]) : static_cast<const float*>(base)[i];
}

// rows [r0, r0 + n) of the (N, HD)-strided tensor (row stride `stride`
// elements) into shared memory as f32 with row stride `ld`; rows past
// `valid` are zero
template <int HD>
__device__ __forceinline__ void stage(float* dst, int ld, const void* src, size_t first, size_t stride, int n,
                                      int valid, int bf16) {
  for (int i = threadIdx.x; i < n * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    dst[r * ld + d] = r < valid ? load_f32(src, first + r * stride + d, bf16) : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) prefill_attention_kernel(const Params p) {
  using S = Smem<HD>;
  constexpr int DPT = HD / 16;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + S::Q;
  float* ks = smem + S::K;
  float* vs = smem + S::V;
  float* ps = smem + S::P;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KVH);
  const int rows = min(BQ, p.Sq - r0);

  stage<HD>(qs, S::QK_STRIDE, p.q, ((size_t)b * p.Sq + r0) * p.H * HD + (size_t)h * HD, (size_t)p.H * HD, BQ,
            rows, p.q_bf16);

  // each of this thread's rows: its last key (causal limit)
  int lim[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    lim[r] = p.causal ? min(p.q_offset + row, p.Skv - 1) : p.Skv - 1;
  }
  const int block_lim = p.causal ? min(p.q_offset + r0 + rows - 1, p.Skv - 1) : p.Skv - 1;
  const int chunks = block_lim < 0 ? 0 : block_lim / W + 1;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -1e30f;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.0f;
  }

  const size_t kv_row = (size_t)p.KVH * HD;
  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * W;
    __syncthreads();  // the last chunk's K, V and P are consumed
    const size_t first = ((size_t)b * p.Skv + c0) * kv_row + (size_t)kh * HD;
    const int valid = min(W, p.Skv - c0);
    stage<HD>(ks, S::QK_STRIDE, p.k, first, kv_row, W, valid, p.k_bf16);
    stage<HD>(vs, HD, p.v, first, kv_row, W, valid, p.v_bf16);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = *reinterpret_cast<const float4*>(qs + (ty + 16 * r) * S::QK_STRIDE + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S::QK_STRIDE + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = __fmaf_rn(qv[r].x, kv[j].x, s[r][j]);
          s[r][j] = __fmaf_rn(qv[r].y, kv[j].y, s[r][j]);
          s[r][j] = __fmaf_rn(qv[r].z, kv[j].z, s[r][j]);
          s[r][j] = __fmaf_rn(qv[r].w, kv[j].w, s[r][j]);
        }
    }

    float alpha[4];
    bool live[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      live[r] = c0 <= lim[r];  // the same for the row's 16 threads
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc = c0 + tx + 16 * j <= lim[r] ? __fmul_rn(s[r][j], p.scale) : -1e30f;
        s[r][j] = sc;
        mx = fmaxf(mx, sc);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(__fsub_rn(s[r][j], m_new));
        sum = j == 0 ? e : __fadd_rn(sum, e);
        const float pr = p.v_bf16 ? __bfloat162float(__float2bfloat16_rn(e)) : e;
        ps[(ty + 16 * r) * PSTRIDE + tx + 16 * j] = pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off, 16));
      alpha[r] = expf(__fsub_rn(m[r], m_new));
      if (live[r]) {
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum);
        m[r] = m_new;
      }
    }
    __syncthreads();  // P complete

    float pv[4][DPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < DPT; ++i) pv[r][i] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < W; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = *reinterpret_cast<const float4*>(ps + (ty + 16 * r) * PSTRIDE + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPT];
#pragma unroll
        for (int i = 0; i < DPT; ++i) vv[i] = vs[(j + jj) * HD + tx + 16 * i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int i = 0; i < DPT; ++i) pv[r][i] = __fmaf_rn(pj, vv[i], pv[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (live[r])
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[r][i] = __fadd_rn(__fmul_rn(acc[r][i], alpha[r]), pv[r][i]);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (row >= rows) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const size_t o = (((size_t)b * p.Sq + r0 + row) * p.H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const float y = __fdiv_rn(acc[r][i], den);
      if (p.q_bf16)
        static_cast<__nv_bfloat16*>(p.out)[o + tx + 16 * i] = __float2bfloat16_rn(y);
      else
        static_cast<float*>(p.out)[o + tx + 16 * i] = y;
    }
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t st) {
  static unsigned configured = 0;  // devices whose shared-memory limit is raised, as a bit set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(prefill_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<HD>::BYTES);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  prefill_attention_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KVH, hd), each contiguous bf16
// (*_bf16 = 1) or f32; out (B, Sq, H, hd) in q's dtype.  hd in {16, 32, 64,
// 128}, H % KVH == 0, B <= 65535, H <= 65535.  Query i sits at position
// q_offset + i and key j at j; causal keeps keys j <= q_offset + i.  Returns
// cudaErrorInvalidValue on arguments it does not take, else
// cudaGetLastError() after the launch.
extern "C" int prefill_attention_launch(const void* q, const void* k, const void* v, void* out, int q_bf16,
                                        int k_bf16, int v_bf16, int B, int Sq, int Skv, int H, int KVH, int hd,
                                        int q_offset, int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH || B > 65535 || H > 65535 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, q_bf16, k_bf16, v_bf16, B, Sq, Skv, H, KVH, q_offset, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch<16>(p, st));
    case 32: return static_cast<int>(launch<32>(p, st));
    case 64: return static_cast<int>(launch<64>(p, st));
    case 128: return static_cast<int>(launch<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
