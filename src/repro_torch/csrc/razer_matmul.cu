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
// bytes it streams from HBM, and by the integer work of decoding them.  At
// prefill (M = batch x bucket) it does 2*M*K*N operations, on the tensor
// cores, and each block re-reads its x tile from L2.
//
// Design: the tile, kernel and launch are razer_matmul_tile.cuh's mixed-input
// wgmma GEMM (swap-AB: decoded weights as A in registers, x as B in shared
// memory, a cp.async ring of wire bytes), shared with the grouped GEMM (K6):
// this is its one-expert case.  Decode-sized M gives too few output tiles
// to fill 132 SMs, so K is split (from (N, K) alone) over the blocks of a
// cluster, which sum their partial tiles in a fixed order through
// distributed shared memory: one launch, deterministic, no atomics.

#include "razer_matmul_tile.cuh"

struct K1;  // names the dense GEMM's kernel in a profile
struct K7;  // names its K-shard form

// both quantize x in their own load under W4A4 (razer_matmul_tile.cuh)
namespace razer_tile {
template <>
struct Fusable<K1> {
  static constexpr bool value = true;
};
template <>
struct Fusable<K7> {
  static constexpr bool value = true;
};
}  // namespace razer_tile

// x: (M, K) bf16 (x_is_bf16 = 1) or f32, row-major; codes (K/2, N) and
// scale_meta (K/16, N) uint8; out (M, N) f32.  nt is the token tile, splits
// and k_tiles_per_split the K split (razer_matmul.py's launch_plan); K must
// be a multiple of 64.  act_table: null, or the activation fake-quant's
// table (razer_act_qdq.cuh) with act_nsv special values, to fake-quantize x
// in the load (W4A4): the bits of razer_act_qdq_launch on x, then this GEMM.
// The grouped launch with one expert.  Returns cudaGetLastError() after the
// launch.
extern "C" int razer_matmul_launch(const void* x, int x_is_bf16, const void* codes, const void* scale_meta,
                                   void* out, int M, int K, int N, int nt, int splits, int k_tiles_per_split,
                                   float m0, float m1, const void* act_table, int act_nsv, void* stream) {
  return static_cast<int>(razer_tile::launch_grouped<K1>(
      x, x_is_bf16, codes, scale_meta, out, 1, M, K, N, nt,
      splits, k_tiles_per_split, 1, m0, m1,
      static_cast<const float*>(act_table), act_nsv,
      static_cast<cudaStream_t>(stream)));
}

// K7: as razer_matmul_launch on this rank's (K_local/2, N) shard, with out
// stored as (out_chunks, M, N/out_chunks): the N/out_chunks columns of rank r
// at out[r].  N must be a multiple of out_chunks.  The fused activation
// quant takes this rank's K slice, whose 16-value blocks are whole.
// Returns cudaGetLastError() after the launch.
extern "C" int razer_matmul_kshard_launch(const void* x, int x_is_bf16, const void* codes,
                                          const void* scale_meta, void* out, int M, int K, int N, int nt,
                                          int splits, int k_tiles_per_split, int out_chunks, float m0, float m1,
                                          const void* act_table, int act_nsv, void* stream) {
  return static_cast<int>(razer_tile::launch_grouped<K7>(
      x, x_is_bf16, codes, scale_meta, out, 1, M, K, N, nt,
      splits, k_tiles_per_split, out_chunks, m0, m1,
      static_cast<const float*>(act_table), act_nsv,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory (bytes) of the tile's block for token tile nt (0 if
// nt is not one the kernel is built for): what a build report prints beside
// ptxas's registers.
extern "C" int razer_matmul_tile_smem(int nt) { return razer_tile::tile_smem(nt); }
