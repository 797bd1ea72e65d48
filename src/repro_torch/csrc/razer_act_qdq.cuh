// The RaZeR W4A4 activation fake-quant of one 16-value block, shared by the
// standalone kernel (razer_quantize.cu, K2) and the packed GEMM's fused x
// path (razer_matmul_tile.cuh, K1 and K7), so that the two cannot drift
// apart: both return the plain version's bits (kernels/ref.py
// razer_act_qdq_ref).  Every operation is written with an _rn intrinsic,
// which nvcc never contracts into an FMA, so the bits do not depend on the
// including file's --fmad flag.
//
// Arithmetic of a block (the plain version's, in the same order):
//   1. scale = absmax / 6 rounded to the nearest positive E4M3 value, ties
//      to the lower one (a lower_bound over the sorted midpoints: the count
//      of midpoints below it); a nonzero block whose scale rounds to 0
//      takes the smallest positive one;
//   2. s = x / scale, rounded to the FP4 grid with ties to the lower value
//      (the count of the grid's midpoints below s: searchsorted "left");
//   3. each special value v of the set, in order: s rounded to the FP4 grid
//      with v added.  That grid's midpoints are the FP4 grid's, except that
//      the one between v's neighbours is replaced by the two around v, so
//      its rounding is v where lo_v < s <= hi_v (those two midpoints; -inf /
//      +inf where v is the smallest / largest value) and the FP4 rounding
//      elsewhere: the same count, two compares.  The candidate replaces the
//      best so far only on a strictly smaller block SSE, summed left to
//      right over the 16 columns;
//   4. the chosen values times the scale (f32; the caller rounds to its
//      dtype).
//
// Layout: a block's 16 values lie in the four lanes of a quad (lanes 4j ...
// 4j + 3 of a warp), four consecutive columns each, lane 4j holding columns
// 0-3.  The absmax is a quad butterfly (max is exact in any order); the SSE
// runs lane after lane, so that it adds the 16 squares in column order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace razer_act {

// the float32 table the wrapper builds (kernels/razer_quantize.py _tables)
constexpr int SCALE_VALS = 0;    // 128: the positive E4M3 grid (0 first)
constexpr int SCALE_MIDS = 128;  // 128: its midpoints, padded with +inf
constexpr int BASE_VALS = 256;   // 16: the 15 FP4 values
constexpr int BASE_MIDS = 272;   // 16: their 14 midpoints, padded with +inf
constexpr int SV_VALS = 288;     // 4: the special values, in the set's order
constexpr int SV_LO = 292;       // 4: the midpoint below each (or -inf)
constexpr int SV_HI = 296;       // 4: the midpoint above each (or +inf)
constexpr int TABLE = 304;       // floats (a multiple of 4)
constexpr int MAX_SV = 4;

// count of a[0 .. 2 step) below x for a sorted a: lower_bound by halving
template <int STEP>
__device__ __forceinline__ int count_below(const float* a, float x) {
  int i = 0;
#pragma unroll
  for (int step = STEP; step > 0; step >>= 1)
    if (a[i + step - 1] < x) i += step;
  return i;
}

// v: this lane's 4 values of the quad's block, replaced by their fake-quant
// (f32).  q: the lane's place in its quad (0-3); mask: the quad's lanes,
// all of which call this together.  tab: the table above (shared memory).
__device__ __forceinline__ void qdq_quad(float (&v)[4], const float* tab, int n_sv, int q, unsigned mask) {
  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
  amax = fmaxf(amax, __shfl_xor_sync(mask, amax, 1, 4));
  amax = fmaxf(amax, __shfl_xor_sync(mask, amax, 2, 4));

  float scale = tab[SCALE_VALS + count_below<64>(tab + SCALE_MIDS, __fdiv_rn(amax, 6.0f))];
  if (scale == 0.0f && amax > 0.0f) scale = tab[SCALE_VALS + 1];
  const float den = scale == 0.0f ? 1.0f : scale;

  float s[4], base[4], best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = __fdiv_rn(v[i], den);
    best[i] = base[i] = tab[BASE_VALS + count_below<8>(tab + BASE_MIDS, s[i])];
  }
  // the block SSE of candidate values c: lane 0 starts the left-to-right
  // sum, each next lane continues it, lane 3 holds the total
  auto sse = [&](const float (&c)[4]) {
    float d2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = __fsub_rn(c[i], s[i]);
      d2[i] = __fmul_rn(d, d);
    }
    float run = __fadd_rn(__fadd_rn(__fadd_rn(d2[0], d2[1]), d2[2]), d2[3]);
#pragma unroll
    for (int t = 1; t < 4; ++t) {
      const float prev = __shfl_sync(mask, run, t - 1, 4);
      if (q == t) run = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(prev, d2[0]), d2[1]), d2[2]), d2[3]);
    }
    return __shfl_sync(mask, run, 3, 4);
  };
  float best_err = sse(best);
  // candidates in pairs, the two SSE chains side by side; a candidate is
  // taken in the set's order, only on a strictly smaller SSE (summing every
  // candidate's SSE measured faster than skipping those that take no
  // element, PERF.md)
  for (int c = 0; c < n_sv; c += 2) {
    float cand[2][4], err[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      // lo is -inf when v is the grid's smallest value: then s = -inf rounds to v too
      const float sv = tab[SV_VALS + c + u], lo = tab[SV_LO + c + u], hi = tab[SV_HI + c + u];
#pragma unroll
      for (int i = 0; i < 4; ++i) cand[u][i] = ((lo < s[i] || isinf(lo)) && s[i] <= hi) ? sv : base[i];
      err[u] = sse(cand[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (c + u < n_sv && err[u] < best_err) {  // the same on the quad's four lanes
        best_err = err[u];
#pragma unroll
        for (int i = 0; i < 4; ++i) best[i] = cand[u][i];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fmul_rn(best[i], scale);
}

// lane mask of the quad that holds `lane`
__device__ __forceinline__ unsigned quad_mask(int lane) { return 0xFu << (lane & 28); }

}  // namespace razer_act
