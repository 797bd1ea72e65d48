// RaZeR packed-weight GEMM for Hopper (sm_90a), K1, and its K-shard form K7.
//
// K1 replaces the Pallas TPU kernel `razer_matmul_pallas`
// (src/repro/kernels/razer_matmul.py:112, tile decode `_decode_weight_tile`);
// K7 replaces `razer_matmul_kshard_pallas` (razer_matmul.py:158): the same
// GEMM over this rank's K/tp wire rows, followed there by a psum_scatter
// tiled on the last dim.  torch.distributed's reduce_scatter_tensor scatters
// along dim 0, so K7 stores its full-N partial chunk-major, (tp, M, N/tp),
// and the Python wrapper hands that to the collective with no transpose.
//
//   y[M, N] (f32) = x[M, K] @ dequant(codes[K/2, N], scale_meta[K/16, N])
//
// What bounds it on this card: at decode (M = batch, a handful of rows) every
// weight byte is used M times, far below the ~295 operations per byte where
// the H100 turns compute bound, so the kernel is bound by the 4.5-bit weight
// bytes it streams from HBM.  At prefill (M = batch x bucket) it does
// 2*M*K*N operations on SIMT FMA units.
//
// Design: the tile decode and FMA loop, the kernel and its launch are in
// razer_matmul_tile.cuh, shared with the grouped GEMM (K6): this is its
// one-expert case.  Decode-sized M gives too few output tiles to
// fill 132 SMs, so K is split over gridDim.z; each split writes its partial
// tile and a second kernel sums the splits in a fixed order (deterministic,
// no atomics).  wgmma, TMA and a pipelined ring of tiles are later work.

#include "razer_matmul_tile.cuh"

struct K1;  // names the dense GEMM's kernel in a profile
struct K7;  // names its K-shard form

// x: (M, K) bf16 (x_is_bf16 = 1) or f32, row-major; codes (K/2, N) and
// scale_meta (K/16, N) uint8; out (M, N) f32.  With splits > 1, partial
// holds (splits, M, N) f32 scratch.  K must be a multiple of 64.  The
// grouped launch with one expert.
// Returns cudaGetLastError() after the launches.
extern "C" int razer_matmul_launch(const void* x, int x_is_bf16, const void* codes,
                                   const void* scale_meta, void* partial, void* out, int M,
                                   int K, int N, int splits, int k_tiles_per_split, float m0,
                                   float m1, void* stream) {
  return static_cast<int>(razer_tile::launch_grouped<K1>(
      x, x_is_bf16, codes, scale_meta, partial, out, 1, M, K, N, splits, k_tiles_per_split, 1, m0, m1,
      static_cast<cudaStream_t>(stream)));
}

// K7: as razer_matmul_launch on this rank's (K_local/2, N) shard, with out
// (and each split of partial) stored as (out_chunks, M, N/out_chunks): the
// N/out_chunks columns of rank r at out[r].  N must be a multiple of
// out_chunks.  Returns cudaGetLastError() after the launches.
extern "C" int razer_matmul_kshard_launch(const void* x, int x_is_bf16, const void* codes,
                                          const void* scale_meta, void* partial, void* out, int M,
                                          int K, int N, int splits, int k_tiles_per_split,
                                          int out_chunks, float m0, float m1, void* stream) {
  return static_cast<int>(razer_tile::launch_grouped<K7>(
      x, x_is_bf16, codes, scale_meta, partial, out, 1, M, K, N, splits, k_tiles_per_split,
      out_chunks, m0, m1, static_cast<cudaStream_t>(stream)));
}
