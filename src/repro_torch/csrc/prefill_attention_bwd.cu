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
// S, dQ and dK run at q/k's width HD; dP, dV and D at V's width DV (o and
// dO have V's width).  Two kernels a call, all sums in f32 and in a fixed
// order, no atomics:
//   1. query-major: a block takes 64 query rows of one head (the f32 body)
//      or of GB heads of one KV head (the tensor-core body); it walks their
//      keys once for each row's max m and sum l (the forward's softmax
//      statistics, recomputed: K9's forward stays as it is), computes D
//      from O and dO, walks the keys again for P, dP, dS and dQ, and writes
//      the statistics and D to a (3, B, H, Sq) f32 workspace: m, l and D
//      (the f32 body), m + log2 l in base 2, l and D (the tensor-core body);
//   2. key-major: a block takes 64 keys (f32) or one or two tiles of 64 keys
//      (tensor cores) of one KV head and walks the G query heads of that KV
//      head in order, each over the query tiles that see those keys,
//      rebuilding P from the workspace, and sums dV and dK in registers.
// The masks are K9's: query i at position q_offset + i, key j at j;
// causal keeps j <= q_offset + i; window > 0 keeps j > q_offset + i -
// window.  Only the tiles that hold a kept (query, key) pair are walked.
// Built for (HD, DV) = (16, 16), (32, 32), (64, 64), (128, 128), MLA's
// (192, 128) and (256, 256): the forward's widths (the wrapper refuses the
// rest).
//
// What bounds it on this card: the operations.  The minimum is 3 products at
// HD and 2 at DV a kept (query, key) pair and head (S, dQ, dK; dP, dV),
// against the bytes of q, k, v, o, dO in and dq, dk, dv out; the recomputed
// statistics and the key-major pass's S and dP add more.
//
// Two bodies, chosen by the dtypes alone, the same way for every call
// (kernels/prefill_attention_bwd.py, `kernel_body`):
//  * the tensor-core body, for bf16 q, k and v (o and dO in q's dtype):
//    the training path, whose compute dtype is bf16.  Every product is a
//    `wgmma` with bf16 operands and f32 accumulators, a warpgroup for each
//    64 rows:
//      - S = q K^T and dP = dO V^T (query-major), S^T = K q^T and dP^T =
//        V dO^T (key-major): m64n64k16, both operands K-major tiles in
//        shared memory (8-row x 16-byte core matrices, no swizzle, as K9's
//        forward stages them);
//      - dQ = dS K, dV = P^T dO, dK = dS^T q: m64n{HD or DV}k16 with P and
//        dS rounded to bf16 as the A operand from registers (the score
//        accumulators' layout is the A fragment's), and B the same K-major
//        tile of K, dO or q read MN-major through the bf16 transpose bit:
//        its rows run along k, no transposed copy is staged; past 128
//        columns as two products of half the columns (each column is its
//        own sum: the same bits);
//      - a tile staged once serves several warpgroups: a query-major block
//        holds GB heads (the largest divisor of G up to 3, as K9's forward;
//        1 at HD 192 and 256, where two heads' tiles do not fit shared
//        memory) over one key-chunk ring; a key-major block 2 key tiles
//        over one query-tile ring (a warpgroup past Skv idles).  Neither
//        moves a bit: each warpgroup walks its own rows' tiles in the same
//        order;
//      - at HD 192 and 256 a thread cannot hold dK and dV (MLA: 96 + 64 f32
//        beside S^T, dP^T and both fragment sets; HD 256: 128 + 128), so the
//        key-major block takes one key tile and splits the sums: warpgroup 0
//        forms P and sums dV, warpgroup 1 forms P, dP and dS and sums dK.
//        Each sum keeps its order over heads and query tiles: no bit moves;
//      - tiles arrive by cp.async into a ring of NST stages, as many as
//        shared memory holds up to 4 (`Ring`): with 4, the last product of a
//        tile (dQ; dK) is left in flight into the next tile and waited for
//        there, before that tile's end, so tile it's stage is refilled only
//        after the block barrier at the top of tile it + 2, which every
//        warpgroup reaches past that wait; 2 tiles' copies are in flight
//        while one is computed.  With fewer stages (HD 256: 2) the last
//        product is waited for at its own tile's end, and tile it + NST - 1
//        is issued after the barrier at the top of tile it, into the stage
//        every warpgroup finished with in tile it - 1; S^T's (S's) softmax
//        runs while dP^T's (dP's) wgmma does, and dS while dV's does;
//      - blocks run heads (KV heads) fastest and the causal mask's heaviest
//        tiles first: the last query tiles (the most keys), the first key
//        tiles (the most queries), so the card's last wave holds the
//        lightest blocks;
//      - softmax in base 2 on scores scaled by scale x log2 e, P = exp2(s -
//        (m + log2 l)) in both passes; the mask is applied element by
//        element only in a warp whose 16 rows a tile's boundary crosses;
//      - `nvcc -Xptxas -v` reports each kernel's registers and spills
//        (PERF.md's kernel table);
//    a row with no kept key gets P = 0 (dq 0, nothing added to dk or dv);
//  * the f32 body, for any f32 input: CUDA cores in f32, 64 x 64 tiles
//    staged in shared memory with padded rows (no bank conflicts), each of
//    256 threads holding a 4 x 4 piece of a score tile and 4 rows of the
//    output columns it owns; the tiles a pass streams are staged in pieces
//    of 128 columns at HD 256 (four whole 64 x 256 f32 tiles exceed shared
//    memory), summed in the same order.  bf16 operands cannot hold the f32
//    tolerance.  The choice is by dtype, not a fallback: a failed build or
//    launch raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "razer_matmul_tile.cuh"  // razer_tile::Wgmma, the wgmma fences, cp.async

namespace {

constexpr int BT = 64;                 // query rows or keys of a tile
constexpr float NEG = -1e30f;          // K9's masked score
constexpr size_t SMEM_MAX = 232448;    // dynamic shared memory a block can have on an H100

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
  float* ws;  // (B, H, Sq) x 3: m (f32 body) or m + log2 l (tensor-core body), l, D
  int q_bf16, k_bf16, v_bf16;
  int B, Sq, Skv, H, KVH, q_offset, causal, window;
  float scale;
};

__device__ __forceinline__ bool kept(const Args& a, int i, int j) {
  const int qp = a.q_offset + i;
  return i < a.Sq && j < a.Skv && (!a.causal || j <= qp) && (!a.window || j > qp - a.window);
}

// ===========================================================================
// the f32 body
// ===========================================================================
namespace f32 {

constexpr int THREADS = 256;

// the columns of a streamed tile: whole up to 192, else pieces of 128
template <int D>
__host__ __device__ constexpr int piece() {
  return D > 192 ? 128 : D;
}

// rows [r0, r0 + BT), columns [c0, c0 + W) of a (B, S, heads, D) tensor at
// head h -> s[BT][W + 1] f32, zeros past S
template <int D, int W>
__device__ __forceinline__ void load_tile(float* s, const void* src, int bf16, int b, int r0, int S, int heads, int h,
                                          int c0 = 0) {
  for (int e = threadIdx.x; e < BT * W; e += THREADS) {
    const int r = e / W, c = e % W, row = r0 + r;
    s[r * (W + 1) + c] =
        row < S ? ld(src, ((static_cast<size_t>(b) * S + row) * heads + h) * D + c0 + c, bf16) : 0.0f;
  }
}

// acc[r][c] += sum_d A[ty + 16 r][d] * Bm[tx + 16 c][d] over W columns, A's
// rows SA floats apart, Bm's SB
template <int W, int SA, int SB>
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* A, const float* Bm, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = A[(ty + 16 * r) * SA + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bm[(tx + 16 * c) * SB + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __fmaf_rn(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float x[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[r][c] = 0.0f;
}

// out[r][cc0 + cc] += sum_t T[ty + 16 r][t] * M[t][tx + 16 cc] over the BT
// columns of T, for the W columns of M (rows W + 1 floats apart)
template <int W, int NC>
__device__ __forceinline__ void tile_accum(float (&out)[4][NC], int cc0, const float* T, const float* M, int ty,
                                           int tx) {
#pragma unroll 4
  for (int t = 0; t < BT; ++t) {
    float tv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) tv[r] = T[(ty + 16 * r) * (BT + 1) + t];
#pragma unroll
    for (int cc = 0; cc < W / 16; ++cc) {
      const float mv = M[t * (W + 1) + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r) out[r][cc0 + cc] = __fmaf_rn(tv[r], mv, out[r][cc0 + cc]);
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

// a block's tiles: the two it keeps whole (q and dO; K and V), the two it
// streams in pieces (K and V; q and dO), the 64 x 64 P / dS tile, 3 x 64
// statistics
template <int HD, int DV>
constexpr size_t smem_bytes() {
  return (BT * (HD + 1) + BT * (DV + 1) + BT * (piece<HD>() + 1) + BT * (piece<DV>() + 1) + BT * (BT + 1) + 3 * BT) *
         sizeof(float);
}

template <int HD, int DV>
__global__ void __launch_bounds__(THREADS) prefill_attention_bwd_dq_kernel(Args a) {
  constexpr int KP = piece<HD>(), VP = piece<DV>(), NK = HD / KP, NV = DV / VP;
  extern __shared__ float sm[];
  float* sQ = sm;
  float* sdO = sQ + BT * (HD + 1);
  float* sK = sdO + BT * (DV + 1);  // a piece of KP columns
  float* sV = sK + BT * (KP + 1);   // a piece of VP columns
  float* sT = sV + BT * (VP + 1);   // the dS tile
  float* sD = sT + BT * (BT + 1);
  const int i0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<HD, HD>(sQ, a.q, a.q_bf16, b, i0, a.Sq, a.H, h);
  load_tile<DV, DV>(sdO, a.dout, a.q_bf16, b, i0, a.Sq, a.H, h);
  __syncthreads();
  if (tid < BT) {  // D of row tid, summed over d in order
    const int i = i0 + tid;
    float dsum = 0.0f;
    if (i < a.Sq) {
      const size_t base = ((static_cast<size_t>(b) * a.Sq + i) * a.H + h) * DV;
      for (int d = 0; d < DV; ++d) dsum = __fmaf_rn(sdO[tid * (DV + 1) + d], ld(a.o, base + d, a.q_bf16), dsum);
    }
    sD[tid] = dsum;
  }
  __syncthreads();
  // the keys any row of the tile keeps
  const int last_i = min(i0 + BT, a.Sq) - 1;
  const int j_end = a.causal ? min(a.Skv, a.q_offset + last_i + 1) : a.Skv;
  const int j_begin = a.window ? max(0, a.q_offset + i0 - a.window + 1) : 0;
  const int c_begin = (j_begin / BT) * BT;
  // s = q K^T over the chunk at c0, K staged a piece at a time (sK holds the last piece after)
  auto scores = [&](float s[4][4], int c0) {
    zero(s);
#pragma unroll
    for (int kc = 0; kc < NK; ++kc) {
      __syncthreads();
      load_tile<HD, KP>(sK, a.k, a.k_bf16, b, c0, a.Skv, a.KVH, kh, kc * KP);
      __syncthreads();
      tile_dot<KP, HD + 1, KP + 1>(s, sQ + kc * KP, sK, ty, tx);
    }
  };
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = NEG, l[r] = 0.0f;
  float s[4][4];
  for (int c0 = c_begin; c0 < j_end; c0 += BT) {  // pass 1: each row's max and sum
    scores(s, c0);
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
    scores(s, c0);
    zero(dp);
#pragma unroll
    for (int vc = 0; vc < NV; ++vc) {
      __syncthreads();
      load_tile<DV, VP>(sV, a.v, a.v_bf16, b, c0, a.Skv, a.KVH, kh, vc * VP);
      __syncthreads();
      tile_dot<VP, DV + 1, VP + 1>(dp, sdO + vc * VP, sV, ty, tx);
    }
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
#pragma unroll
    for (int kc = NK - 1; kc >= 0; --kc) {  // the last piece is staged already
      if (kc != NK - 1) {
        __syncthreads();
        load_tile<HD, KP>(sK, a.k, a.k_bf16, b, c0, a.Skv, a.KVH, kh, kc * KP);
        __syncthreads();
      }
      tile_accum<KP, HD / 16>(dq, kc * KP / 16, sT, sK, ty, tx);
    }
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

template <int HD, int DV>
__global__ void __launch_bounds__(THREADS) prefill_attention_bwd_dkdv_kernel(Args a) {
  constexpr int KP = piece<HD>(), VP = piece<DV>(), NK = HD / KP, NV = DV / VP;
  extern __shared__ float sm[];
  float* sK = sm;
  float* sV = sK + BT * (HD + 1);
  float* sQ = sV + BT * (DV + 1);   // a piece of KP columns
  float* sdO = sQ + BT * (KP + 1);  // a piece of VP columns
  float* sT = sdO + BT * (VP + 1);  // P, then dS, keys x queries
  float* sM = sT + BT * (BT + 1);
  float* sL = sM + BT;
  float* sD = sL + BT;
  const int j0 = blockIdx.x * BT, kh = blockIdx.y, b = blockIdx.z, g = a.H / a.KVH;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<HD, HD>(sK, a.k, a.k_bf16, b, j0, a.Skv, a.KVH, kh);
  load_tile<DV, DV>(sV, a.v, a.v_bf16, b, j0, a.Skv, a.KVH, kh);
  float dk[4][HD / 16], dv[4][DV / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int cc = 0; cc < HD / 16; ++cc) dk[r][cc] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < DV / 16; ++cc) dv[r][cc] = 0.0f;
  }
  // the query rows that keep any key of the tile
  const int last_j = min(j0 + BT, a.Skv) - 1;
  const int i_begin = a.causal ? max(0, j0 - a.q_offset) : 0;
  const int i_end = a.window ? min(a.Sq, last_j + a.window - a.q_offset) : a.Sq;
  const size_t n = static_cast<size_t>(a.B) * a.H * a.Sq;
  float s[4][4], dp[4][4];
  for (int h = kh * g; h < (kh + 1) * g; ++h) {
    for (int c0 = (i_begin / BT) * BT; c0 < i_end; c0 += BT) {
      __syncthreads();
      load_tile<HD, KP>(sQ, a.q, a.q_bf16, b, c0, a.Sq, a.H, h);
      load_tile<DV, VP>(sdO, a.dout, a.q_bf16, b, c0, a.Sq, a.H, h);
      if (tid < BT) {
        const int i = c0 + tid;
        const size_t w = (static_cast<size_t>(b) * a.H + h) * a.Sq + i;
        sM[tid] = i < a.Sq ? a.ws[w] : 0.0f;
        sL[tid] = i < a.Sq ? a.ws[n + w] : 1.0f;
        sD[tid] = i < a.Sq ? a.ws[2 * n + w] : 0.0f;
      }
      __syncthreads();
      zero(s);  // keys ty + 16 r, queries tx + 16 c; q and dO staged a piece at a time
#pragma unroll
      for (int kc = 0; kc < NK; ++kc) {
        if (kc) {
          __syncthreads();
          load_tile<HD, KP>(sQ, a.q, a.q_bf16, b, c0, a.Sq, a.H, h, kc * KP);
          __syncthreads();
        }
        tile_dot<KP, HD + 1, KP + 1>(s, sK + kc * KP, sQ, ty, tx);
      }
      zero(dp);
#pragma unroll
      for (int vc = 0; vc < NV; ++vc) {
        if (vc) {
          __syncthreads();
          load_tile<DV, VP>(sdO, a.dout, a.q_bf16, b, c0, a.Sq, a.H, h, vc * VP);
          __syncthreads();
        }
        tile_dot<VP, DV + 1, VP + 1>(dp, sV + vc * VP, sdO, ty, tx);
      }
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
#pragma unroll
      for (int vc = NV - 1; vc >= 0; --vc) {  // the last piece of dO is staged already
        if (vc != NV - 1) {
          __syncthreads();
          load_tile<DV, VP>(sdO, a.dout, a.q_bf16, b, c0, a.Sq, a.H, h, vc * VP);
          __syncthreads();
        }
        tile_accum<VP, DV / 16>(dv, vc * VP / 16, sT, sdO, ty, tx);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tx + 16 * c;
          sT[(ty + 16 * r) * (BT + 1) + qi] = __fmul_rn(p[r][c], __fsub_rn(dp[r][c], sD[qi]));
        }
      __syncthreads();
#pragma unroll
      for (int kc = NK - 1; kc >= 0; --kc) {  // the last piece of q is staged already
        if (kc != NK - 1) {
          __syncthreads();
          load_tile<HD, KP>(sQ, a.q, a.q_bf16, b, c0, a.Sq, a.H, h, kc * KP);
          __syncthreads();
        }
        tile_accum<KP, HD / 16>(dk, kc * KP / 16, sT, sQ, ty, tx);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= a.Skv) continue;
    const size_t row = (static_cast<size_t>(b) * a.Skv + j) * a.KVH + kh;
#pragma unroll
    for (int cc = 0; cc < HD / 16; ++cc) st(a.dk, row * HD + tx + 16 * cc, __fmul_rn(dk[r][cc], a.scale), a.k_bf16);
#pragma unroll
    for (int cc = 0; cc < DV / 16; ++cc) st(a.dv, row * DV + tx + 16 * cc, dv[r][cc], a.v_bf16);
  }
}

template <int HD, int DV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(smem_bytes<HD, DV>());
  static_assert(smem_bytes<HD, DV>() <= SMEM_MAX, "the f32 body's tiles must fit shared memory");
  cudaError_t e = cudaFuncSetAttribute(prefill_attention_bwd_dq_kernel<HD, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(prefill_attention_bwd_dkdv_kernel<HD, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 gq((a.Sq + BT - 1) / BT, a.H, a.B), gk((a.Skv + BT - 1) / BT, a.KVH, a.B);
  prefill_attention_bwd_dq_kernel<HD, DV><<<gq, THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  prefill_attention_bwd_dkdv_kernel<HD, DV><<<gk, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ===========================================================================
// the tensor-core body
// ===========================================================================
namespace tc {

using razer_tile::cp_async16;
using razer_tile::cp_async_commit;
using razer_tile::cp_async_wait;
using razer_tile::fence_operands;
using razer_tile::fence_proxy_async;
using razer_tile::smem_u32;
using razer_tile::wgmma_commit;
using razer_tile::wgmma_fence;
using razer_tile::wgmma_wait;

constexpr int WG = 128;  // threads a warpgroup, 16 rows a warp

// the most stages up to 4 of `stage` bytes that fit beside `fixed` bytes
__host__ __device__ constexpr int stages(size_t fixed, size_t stage) {
  return fixed + 4 * stage <= SMEM_MAX ? 4 : fixed + 3 * stage <= SMEM_MAX ? 3 : 2;
}

// How a ring of NST stages is walked.  FLIGHT: the last product of a tile
// is left in flight into the next tile and waited for there (4 or more
// stages); else it is waited for at its own tile's end.  AHEAD: the tiles
// issued before the first is computed; tile it + AHEAD is issued after the
// block barrier at the top of tile it.  The stage it refills was last read
// by tile it + AHEAD - NST, whose products every warpgroup has waited for
// before that barrier: in tile it + AHEAD - NST + 1 <= it - 1 (FLIGHT) or
// in tile it + AHEAD - NST <= it - 1 itself.
template <int NST>
struct Ring {
  static constexpr bool FLIGHT = NST >= 4;
  static constexpr int AHEAD = FLIGHT ? NST - 2 : NST - 1;
  static_assert(AHEAD >= 1, "a ring needs a tile in flight");
};

// The query-major pass with GB warpgroups a block (GB heads of one KV head,
// the same 64 query rows): GB (q, dO) tile pairs, NST stages of a key
// chunk's (K, V), GB x 64 f32 D.
template <int HD, int DV, int GB>
struct DqGeo {
  static constexpr int TQ = BT * HD * 2;  // bytes of a 64-row bf16 tile at q/k's width
  static constexpr int TV = BT * DV * 2;  // at V's width
  static constexpr int STAGE = TQ + TV;
  static constexpr size_t FIXED = static_cast<size_t>(GB) * (TQ + TV) + GB * BT * 4;
  static constexpr int NST = stages(FIXED, STAGE);
  static constexpr size_t bytes = FIXED + static_cast<size_t>(NST) * STAGE;
  static_assert(bytes <= SMEM_MAX, "the query-major tiles must fit shared memory");
};
// The key-major pass: KBT tiles of 64 keys of one KV head (their K and V),
// NST stages of a query tile's (q, dO) and its rows' log-sum-exp, l and D
// (3 x 64 f32, in 1 KB).  SPLIT (HD above 128): one key tile, its dV summed
// by warpgroup 0 and its dK by warpgroup 1; else two key tiles, a
// warpgroup each, each summing both.
template <int HD, int DV>
struct KvGeo {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int KBT = SPLIT ? 1 : 2;
  static constexpr int TQ = BT * HD * 2;
  static constexpr int TV = BT * DV * 2;
  static constexpr int STAGE = TQ + TV + 1024;
  static constexpr size_t FIXED = static_cast<size_t>(KBT) * (TQ + TV);
  static constexpr int NST = stages(FIXED, STAGE);
  static constexpr size_t bytes = FIXED + static_cast<size_t>(NST) * STAGE;
  static_assert(bytes <= SMEM_MAX, "the key-major tiles must fit shared memory");
};

// Byte offset of element (row, k) in a K-major bf16 tile of `depth` k per
// row, in wgmma's interleaved layout (K9's forward, prefill_attention.cu):
// 8-row x 16-byte core matrices, the two 8-deep halves of a 16-deep k-step
// 128 bytes apart, k-steps 256 bytes apart, groups of 8 rows depth x 16
// bytes apart.
__host__ __device__ constexpr int core_off(int row, int k, int depth) {
  return (row >> 3) * (depth * 16) + (k >> 4) * 256 + ((k >> 3) & 1) * 128 + (row & 7) * 16 + (k & 7) * 2;
}
// descriptor of the k-step at `p` of such a tile read K-major (LBO 128
// bytes between the k halves, SBO depth x 16 between groups of 8 rows)
__device__ __forceinline__ uint64_t desc_k(const void* p, int depth) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(depth) << 32);
}
// the same tile as an MN-major B operand (the transpose bit), its rows along
// k: the 16 rows of a k-step from `p` on, LBO depth x 16 bytes between its
// two groups of 8 rows, SBO 128 bytes between groups of 8 columns (along N)
__device__ __forceinline__ uint64_t desc_mn(const void* p, int depth) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(depth) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// D (64 x 64 f32) += A (64 x 16, shared) . B^T (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// 4 bytes global -> shared, asynchronously; valid == false zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// (a, b) -> bf16x2 bits, a in the low half, each rounded to nearest
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the N registers of x from `off` on, as an array of its own
template <int N, int M>
__device__ __forceinline__ auto& part(float (&x)[M], int off) {
  return *reinterpret_cast<float(*)[N]>(&x[off]);
}

// rows [r0, r0 + 64) of a (B, S, heads, W) bf16 tensor at head h -> a
// K-major tile (zeros past S), by cp.async from all the block's threads: 8
// neighbouring threads take 8 rows of one 16-byte column piece, one core
// matrix
template <int W>
__device__ __forceinline__ void load_tile(uint8_t* dst, const void* src, int b, int r0, int S, int heads, int h) {
  constexpr int CH = W / 8;  // 16-byte pieces a row
  const __nv_bfloat16* t =
      static_cast<const __nv_bfloat16*>(src) + ((static_cast<size_t>(b) * S + r0) * heads + h) * W;
  const size_t stride = static_cast<size_t>(heads) * W;
  for (int i = threadIdx.x; i < BT * CH; i += blockDim.x) {
    const int row = 8 * (i / (8 * CH)) + (i & 7), d = 8 * ((i >> 3) % CH);
    const bool in = r0 + row < S;
    cp_async16(dst + core_off(row, d, W), in ? t + row * stride + d : src, in);
  }
}

// d (64 x 64) += A . B^T over D: A's and B's 64 rows from K-major tiles
template <int D>
__device__ __forceinline__ void ss_product(float (&d)[32], const uint8_t* at, const uint8_t* bt) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) wgmma_ss64(d, desc_k(at + 256 * ks, D), desc_k(bt + 256 * ks, D));
}

// d (64 x N, its first N / 2 registers) += A (64 x 64, registers: 4 k-steps
// of 16) . B, B the K-major tile `bt` (64 rows x N) read MN-major: its rows
// are the product's k.  Past 128 columns, two products of N / 2 columns
// each k-step (each column is its own sum: the same bits)
template <int N, int M>
__device__ __forceinline__ void rs_product(float (&d)[M], const uint32_t (&a)[4][4], const uint8_t* bt) {
  static_assert(M >= N / 2, "the accumulator holds N columns");
  constexpr int NC = N > 128 ? N / 2 : N;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < N / NC; ++c)
      razer_tile::Wgmma<NC>::template mma<1>(part<NC / 2>(d, c * NC / 2), a[kk],
                                             desc_mn(bt + kk * 2 * N * 16 + c * NC * 16, N));
}

// the A fragments of a 64 x 64 accumulator rounded to bf16: [k-step][register],
// x[8 kk + 2 r] and x[8 kk + 2 r + 1] (K9's forward builds P's the same way)
__device__ __forceinline__ void a_fragments(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = bf16x2_bits(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

// the quad (4 lanes) that holds a row: max and sum by xor-shuffles 1 and 2
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
}

// Query-major, GB warpgroups a block: warpgroup w takes head h0 + w.
// s[4 j + e] is row i0 + 8 (e >> 1) (16 w + lane / 4 of the tile), key c0 +
// 8 j + 2 (lane % 4) + (e & 1).  All warpgroups walk the same key chunks,
// staged once for all of them.
template <int HD, int DV, int GB>
__global__ void __launch_bounds__(WG * GB, 1) prefill_attention_bwd_tc_dq_kernel(const Args a) {
  using Gm = DqGeo<HD, DV, GB>;
  using R = Ring<Gm::NST>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  // blocks run heads fastest, then query tiles from the last (the most keys): the heaviest first
  const int hblocks = a.H / a.KVH / GB, kh = blockIdx.x / hblocks;
  const int h0 = kh * (a.H / a.KVH) + (blockIdx.x - kh * hblocks) * GB, h = h0 + wg;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BT;
  const int b = blockIdx.z;
  uint8_t* qt = smem + wg * (Gm::TQ + Gm::TV);  // this head's q rows, K-major
  uint8_t* dot = qt + Gm::TQ;                    // its dO rows
  uint8_t* ring = smem + GB * (Gm::TQ + Gm::TV);  // NST stages of (K, V)
  float* sD = reinterpret_cast<float*>(ring + Gm::NST * Gm::STAGE) + wg * BT;
  for (int w = 0; w < GB; ++w) {
    load_tile<HD>(smem + w * (Gm::TQ + Gm::TV), a.q, b, r0, a.Sq, a.H, h0 + w);
    load_tile<DV>(smem + w * (Gm::TQ + Gm::TV) + Gm::TQ, a.dout, b, r0, a.Sq, a.H, h0 + w);
  }
  cp_async_commit();
  {  // D of row (tid % 128) / 2: each of two threads sums half its dims in order, then the pair adds
    const int row = (tid & 127) >> 1, i = r0 + row, half = tid & 1;
    float dsum = 0.0f;
    if (i < a.Sq) {
      const size_t base = ((static_cast<size_t>(b) * a.Sq + i) * a.H + h) * DV + half * (DV / 2);
      const uint4* po = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.o) + base);
      const uint4* pd = reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.dout) + base);
#pragma unroll
      for (int c = 0; c < DV / 16; ++c) {
        const uint4 ov = po[c], dv = pd[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          dsum = __fmaf_rn(df.y, of.y, __fmaf_rn(df.x, of.x, dsum));
        }
      }
    }
    dsum = __fadd_rn(dsum, __shfl_xor_sync(0xFFFFFFFFu, dsum, 1));
    if (!half) sD[row] = dsum;
  }
  __syncthreads();

  // the key chunks any row of the tile keeps
  const int last = min(r0 + BT, a.Sq) - 1;
  const int j_end = a.causal ? min(a.Skv, a.q_offset + last + 1) : a.Skv;
  const int j_begin = a.window ? max(0, a.q_offset + r0 - a.window + 1) : 0;
  const int c_first = j_begin / BT, n = j_end > j_begin ? (j_end + BT - 1) / BT - c_first : 0;
  const int wr = r0 + 16 * warp, i0 = wr + gq, i1 = i0 + 8;
  const float sc = __fmul_rn(a.scale, 1.4426950408889634f);  // scores in base-2 units
  auto stage = [&](int it) { return ring + (it % Gm::NST) * Gm::STAGE; };
  auto issue = [&](int it, bool with_v) {  // chunk `it`'s K (and V) into its stage; a group, empty past the last
    if (it < n) {
      const int c0 = (c_first + it) * BT;
      load_tile<HD>(stage(it), a.k, b, c0, a.Skv, a.KVH, kh);
      if (with_v) load_tile<DV>(stage(it) + Gm::TQ, a.v, b, c0, a.Skv, a.KVH, kh);
    }
    cp_async_commit();
  };
  // scale the chunk's scores, -1e30 where the mask drops the pair
  auto mask = [&](float (&s)[32], int c0) {
    if (wr + 15 < a.Sq && c0 + BT <= a.Skv && (!a.causal || c0 + BT - 1 <= a.q_offset + wr) &&
        (!a.window || c0 > a.q_offset + wr + 15 - a.window)) {  // every pair of this warp's rows is kept
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = __fmul_rn(s[x], sc);
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x)
        s[x] = kept(a, (x & 2) ? i1 : i0, c0 + 8 * (x >> 2) + 2 * tq + (x & 1)) ? __fmul_rn(s[x], sc) : NEG;
    }
  };

  // pass 1: each row's max m and sum l of exp2(s - m); stage (it + NST - 1)
  // % NST is refilled at the top of chunk it, after the barrier that ended
  // chunk it - 1, its last reader
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;
  for (int it = 0; it < Gm::NST - 1; ++it) issue(it, false);
  for (int it = 0; it < n; ++it) {
    issue(it + Gm::NST - 1, false);
    cp_async_wait<Gm::NST - 1>();
    fence_proxy_async();
    __syncthreads();
    float s[32];
    zero(s);
    fence_operands(s);
    wgmma_fence();
    ss_product<HD>(s, qt, stage(it));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    mask(s, (c_first + it) * BT);
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float me0 = mn0 == NEG ? 0.0f : mn0, me1 = mn1 == NEG ? 0.0f : mn1;  // no kept key yet: every p is 0
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum0 = __fadd_rn(__fadd_rn(sum0, exp2f(__fsub_rn(s[4 * j], me0))), exp2f(__fsub_rn(s[4 * j + 1], me0)));
      sum1 = __fadd_rn(__fadd_rn(sum1, exp2f(__fsub_rn(s[4 * j + 2], me1))), exp2f(__fsub_rn(s[4 * j + 3], me1)));
    }
    l0 = __fadd_rn(__fmul_rn(l0, exp2f(__fsub_rn(m0, mn0))), quad_sum(sum0));
    l1 = __fadd_rn(__fmul_rn(l1, exp2f(__fsub_rn(m1, mn1))), quad_sum(sum1));
    m0 = mn0, m1 = mn1;
    __syncthreads();  // the stage is read: it may be refilled
  }
  // P = exp2(s - lse); a row without a kept key has every s at -1e30 and P 0
  const float lse0 = l0 > 0.0f ? __fadd_rn(m0, log2f(l0)) : 0.0f;
  const float lse1 = l1 > 0.0f ? __fadd_rn(m1, log2f(l1)) : 0.0f;
  const float D0 = sD[16 * warp + gq], D1 = sD[16 * warp + gq + 8];

  // pass 2: S, dP, dS = P (dP - D) and dQ += dS K, the ring walked as
  // `Ring` says (dQ's product is the last of a chunk)
  float dq[HD / 2];
  zero(dq);
  uint32_t ds[4][4] = {};  // dS's A fragments: read by dQ's product until it is waited for
  cp_async_wait<0>();
  __syncthreads();  // pass 1's stages are free
  for (int it = 0; it < R::AHEAD; ++it) issue(it, true);
  for (int it = 0; it < n; ++it) {
    cp_async_wait<R::AHEAD - 1>();  // chunk it has landed
    fence_proxy_async();
    __syncthreads();  // everyone's copies of chunk it have landed; every warpgroup is done with the stage refilled next
    issue(it + R::AHEAD, true);
    const uint8_t* kt = stage(it);
    float s[32], dp[32];
    zero(s);
    zero(dp);
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
    ss_product<HD>(s, qt, kt);
    wgmma_commit();
    ss_product<DV>(dp, dot, kt + Gm::TQ);  // in flight while P is computed
    wgmma_commit();
    wgmma_wait<1>();  // S, and the last chunk's dQ
    fence_operands(s);
    fence_operands(ds);
    mask(s, (c_first + it) * BT);
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = exp2f(__fsub_rn(s[x], (x & 2) ? lse1 : lse0));
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = __fmul_rn(s[x], __fsub_rn(dp[x], (x & 2) ? D1 : D0));
    a_fragments(ds, s);
    fence_operands(dq);
    wgmma_fence();
    rs_product<HD>(dq, ds, kt);
    wgmma_commit();
    if constexpr (!R::FLIGHT) {  // waited for here: its stage is refilled after the next barrier
      wgmma_wait<0>();
      fence_operands(dq);
      fence_operands(ds);
    }
  }
  wgmma_wait<0>();
  fence_operands(dq);
  fence_operands(ds);

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = half ? i1 : i0;
    if (i >= a.Sq) continue;
    __nv_bfloat16* row = out + ((static_cast<size_t>(b) * a.Sq + i) * a.H + h) * HD + 2 * tq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          __fmul_rn(dq[4 * j + 2 * half], a.scale), __fmul_rn(dq[4 * j + 2 * half + 1], a.scale));
    if (tq == 0) {
      const size_t w = (static_cast<size_t>(b) * a.H + h) * a.Sq + i, nw = static_cast<size_t>(a.B) * a.H * a.Sq;
      a.ws[w] = half ? lse1 : lse0;
      a.ws[nw + w] = half ? l1 : l0;
      a.ws[2 * nw + w] = half ? D1 : D0;
    }
  }
}

// Key-major, two warpgroups a block.  Without SPLIT warpgroup w takes keys
// jt = j0 + 64 w .. jt + 63 and sums their dV and dK; with SPLIT both take
// the block's 64 keys, warpgroup 0 summing dV (S^T, P, dV) and 1 dK (S^T,
// dP^T, P, dS, dK).  s[4 j + e] (S^T) is key jr0 + 8 (e >> 1) (16 w + lane
// / 4 of the tile), query c0 + 8 j + 2 (lane % 4) + (e & 1).  All
// warpgroups walk the query tiles of the block's keys, staged once for all
// of them; each skips the tiles where none of its pairs is kept.
template <int HD, int DV>
__global__ void __launch_bounds__(WG * 2, 1) prefill_attention_bwd_tc_dkdv_kernel(const Args a) {
  using Gm = KvGeo<HD, DV>;
  using R = Ring<Gm::NST>;
  constexpr bool SPLIT = Gm::SPLIT;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const bool sums_dv = !SPLIT || wg == 0, sums_dk = !SPLIT || wg == 1;
  // blocks run KV heads fastest, then key tiles from the first (the most queries): the heaviest first
  const int j0 = blockIdx.y * BT * Gm::KBT, kh = blockIdx.x, b = blockIdx.z, g = a.H / a.KVH;
  const int kw = SPLIT ? 0 : wg;                          // this warpgroup's key tile
  const int jt = j0 + kw * BT, jl = min(jt + BT, a.Skv) - 1;  // its keys (none where jl < jt)
  uint8_t* kt = smem + kw * (Gm::TQ + Gm::TV);  // its K rows, K-major
  uint8_t* vt = kt + Gm::TQ;                    // its V rows
  uint8_t* ring = smem + Gm::KBT * (Gm::TQ + Gm::TV);  // NST stages of (q, dO, lse, l, D)
  for (int w = 0; w < Gm::KBT; ++w) {
    load_tile<HD>(smem + w * (Gm::TQ + Gm::TV), a.k, b, j0 + w * BT, a.Skv, a.KVH, kh);
    load_tile<DV>(smem + w * (Gm::TQ + Gm::TV) + Gm::TQ, a.v, b, j0 + w * BT, a.Skv, a.KVH, kh);
  }
  cp_async_commit();
  // the query tiles whose rows keep any key of the block, for each of the g heads in order
  const int last_j = min(j0 + Gm::KBT * BT, a.Skv) - 1;
  const int i_begin = a.causal ? max(0, j0 - a.q_offset) : 0;
  const int i_end = a.window ? min(a.Sq, last_j + a.window - a.q_offset) : a.Sq;
  const int t_first = i_begin / BT, nt = i_end > i_begin ? (i_end + BT - 1) / BT - t_first : 0, n = g * nt;
  const size_t nw = static_cast<size_t>(a.B) * a.H * a.Sq;
  const int wj = jt + 16 * warp, jr0 = wj + gq, jr1 = jr0 + 8;
  const float sc = __fmul_rn(a.scale, 1.4426950408889634f);
  auto stage = [&](int it) { return ring + (it % Gm::NST) * Gm::STAGE; };
  auto issue = [&](int it) {
    if (it < n) {
      const int h = kh * g + it / nt, c0 = (t_first + it % nt) * BT;
      uint8_t* st = stage(it);
      load_tile<HD>(st, a.q, b, c0, a.Sq, a.H, h);
      load_tile<DV>(st + Gm::TQ, a.dout, b, c0, a.Sq, a.H, h);
      float* stats = reinterpret_cast<float*>(st + Gm::TQ + Gm::TV);
      for (int e = tid; e < 3 * BT; e += blockDim.x) {
        const int which = e / BT, i = c0 + e % BT;
        const bool in = i < a.Sq;
        cp_async4(stats + e, a.ws + (in ? which * nw + (static_cast<size_t>(b) * a.H + h) * a.Sq + i : 0), in);
      }
    }
    cp_async_commit();
  };
  // some (query of the tile at c0, key of this warpgroup) pair is kept
  auto any_kept = [&](int c0) {
    const int il = min(c0 + BT, a.Sq) - 1;
    return jt <= jl && (!a.causal || jt <= a.q_offset + il) && (!a.window || jl > a.q_offset + c0 - a.window);
  };

  float acc[SPLIT ? HD / 2 : HD / 2 + DV / 2];  // dK, then dV; with SPLIT this warpgroup's one sum
  auto& dk = part<HD / 2>(acc, 0);
  auto& dv = part<DV / 2>(acc, SPLIT ? 0 : HD / 2);
  zero(acc);
  uint32_t frags[SPLIT ? 1 : 2][4][4] = {};  // P's and dS's A fragments, read by products in flight until the next wait
  auto& pf = frags[0];
  auto& df = frags[SPLIT ? 0 : 1];
  for (int it = 0; it < R::AHEAD; ++it) issue(it);
  for (int it = 0; it < n; ++it) {
    cp_async_wait<R::AHEAD - 1>();  // tile it has landed
    fence_proxy_async();
    __syncthreads();  // everyone's copies of tile it have landed; every warpgroup is done with the stage refilled next
    issue(it + R::AHEAD);
    const int c0 = (t_first + it % nt) * BT;
    if (!any_kept(c0)) {
      wgmma_wait<0>();  // the last tile's readers of its stage
      fence_operands(pf);
      fence_operands(df);
      continue;
    }
    const uint8_t* qs = stage(it);
    const uint8_t* dos = qs + Gm::TQ;
    const float* stats = reinterpret_cast<const float*>(dos + Gm::TV);  // lse, l, D of the tile's 64 rows
    float s[32], dp[32];
    zero(s);
    fence_operands(s);
    if (sums_dk) {
      zero(dp);
      fence_operands(dp);
    }
    wgmma_fence();
    ss_product<HD>(s, kt, qs);  // S^T = K q^T
    wgmma_commit();
    if (sums_dk) {
      ss_product<DV>(dp, vt, dos);  // dP^T = V dO^T, in flight while P is computed
      wgmma_commit();
      wgmma_wait<1>();  // S^T, and the last tile's dV and dK
    } else {
      wgmma_wait<0>();  // S^T, and the last tile's dV
    }
    fence_operands(s);
    fence_operands(pf);
    fence_operands(df);
    const bool whole = wj + 15 < a.Skv && c0 + BT <= a.Sq && (!a.causal || wj + 15 <= a.q_offset + c0) &&
                       (!a.window || wj > a.q_offset + c0 + BT - 1 - a.window);  // this warp keeps every pair
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = 8 * (x >> 2) + 2 * tq + (x & 1);
      s[x] = whole || kept(a, c0 + col, (x & 2) ? jr1 : jr0) ? exp2f(__fsub_rn(__fmul_rn(s[x], sc), stats[col]))
                                                             : 0.0f;
    }
    if (sums_dv) {
      a_fragments(pf, s);
      fence_operands(dv);
      wgmma_fence();
      rs_product<DV>(dv, pf, dos);  // dV += P^T dO, in flight while dS is computed
      wgmma_commit();
    }
    if (sums_dk) {
      if (sums_dv)
        wgmma_wait<1>();  // dP^T
      else
        wgmma_wait<0>();
      fence_operands(dp);
#pragma unroll
      for (int x = 0; x < 32; ++x)
        dp[x] = __fmul_rn(s[x], __fsub_rn(dp[x], stats[2 * BT + 8 * (x >> 2) + 2 * tq + (x & 1)]));
      a_fragments(df, dp);
      fence_operands(dk);
      wgmma_fence();
      rs_product<HD>(dk, df, qs);  // dK += dS^T q
      wgmma_commit();
    }
    if constexpr (!R::FLIGHT) {  // waited for here: its stage is refilled after the next barrier
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(pf);
      fence_operands(df);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_operands(pf);
  fence_operands(df);

  __nv_bfloat16* gk = static_cast<__nv_bfloat16*>(a.dk);
  __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? jr1 : jr0;
    if (j >= a.Skv) continue;
    const size_t row = (static_cast<size_t>(b) * a.Skv + j) * a.KVH + kh;
    if (sums_dk) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(gk + row * HD + 2 * tq + 8 * c) = __floats2bfloat162_rn(
            __fmul_rn(dk[4 * c + 2 * half], a.scale), __fmul_rn(dk[4 * c + 2 * half + 1], a.scale));
    }
    if (sums_dv) {
#pragma unroll
      for (int c = 0; c < DV / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(gv + row * DV + 2 * tq + 8 * c) =
            __floats2bfloat162_rn(dv[4 * c + 2 * half], dv[4 * c + 2 * half + 1]);
    }
  }
}

template <int HD, int DV, int GB>
int launch(const Args& a, cudaStream_t stream) {
  using Dq = DqGeo<HD, DV, GB>;
  using Kv = KvGeo<HD, DV>;
  static unsigned configured = 0;  // devices whose shared-memory limits are raised, as a bit set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(prefill_attention_bwd_tc_dq_kernel<HD, DV, GB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Dq::bytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(prefill_attention_bwd_tc_dkdv_kernel<HD, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Kv::bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1u << dev;
  }
  const dim3 gq(a.H / GB, (a.Sq + BT - 1) / BT, a.B), gk(a.KVH, (a.Skv + BT * Kv::KBT - 1) / (BT * Kv::KBT), a.B);
  prefill_attention_bwd_tc_dq_kernel<HD, DV, GB><<<gq, WG * GB, Dq::bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  prefill_attention_bwd_tc_dkdv_kernel<HD, DV><<<gk, WG * 2, Kv::bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Heads a query-major block, GB: the largest divisor of G up to 3 (K9's
// forward takes the same), 1 above HD 128, where two heads' tiles and a
// ring do not fit shared memory.  It moves no bit: each warpgroup walks its
// own rows' tiles in the same order whatever shares its block.
template <int HD, int DV>
int launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KVH;
  if constexpr (HD > 128) {
    return launch<HD, DV, 1>(a, stream);
  } else {
    return G % 3 == 0 ? launch<HD, DV, 3>(a, stream)
                      : G % 2 == 0 ? launch<HD, DV, 2>(a, stream) : launch<HD, DV, 1>(a, stream);
  }
}

}  // namespace tc

// the tensor-core body for bf16 q, k and v; else the f32 body
inline bool tensor_core_body(int q_bf16, int k_bf16, int v_bf16) { return q_bf16 && k_bf16 && v_bf16; }

template <int HD, int DV>
int launch(const Args& a, cudaStream_t stream) {
  return tensor_core_body(a.q_bf16, a.k_bf16, a.v_bf16) ? tc::launch<HD, DV>(a, stream)
                                                        : f32::launch<HD, DV>(a, stream);
}

}  // namespace

// q, dq (B, Sq, H, hd); o, dout (B, Sq, H, dv); k, dk (B, Skv, KVH, hd); v,
// dv (B, Skv, KVH, dv); (hd, dv) one of (16, 16), (32, 32), (64, 64), (128,
// 128), (192, 128), (256, 256); all contiguous, bf16 or f32 (o, dout and dq
// in q's dtype; dk in k's, dv in v's; bf16 q, k and v run the tensor-core
// body, which reads q, k, v, o and dout in 16-byte pieces: 16-byte
// aligned); ws (3, B, H, Sq) f32.  Returns cudaErrorInvalidValue on
// arguments it does not take, else cudaGetLastError() after the two
// launches.
extern "C" int prefill_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                            const void* dout, void* dq, void* dk, void* dv, void* ws, int q_bf16,
                                            int k_bf16, int v_bf16, int B, int Sq, int Skv, int H, int KVH, int hd,
                                            int dv_width, int q_offset, int causal, int window, float scale,
                                            void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH || q_offset < 0 || window < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                              reinterpret_cast<uintptr_t>(dout);
  if (tensor_core_body(q_bf16, k_bf16, v_bf16) && (Sq > 65535 * BT || Skv > 65535 * BT || (addresses & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(ws), q_bf16, k_bf16, v_bf16,
               B, Sq, Skv, H, KVH, q_offset, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 192 && dv_width == 128) return launch<192, 128>(a, s);
  if (dv_width != hd) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch<16, 16>(a, s);
    case 32: return launch<32, 32>(a, s);
    case 64: return launch<64, 64>(a, s);
    case 128: return launch<128, 128>(a, s);
    case 256: return launch<256, 256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
