// Grouped RaZeR packed GEMM over a stacked expert bank for Hopper (sm_90a),
// K6, and its K-shard form K8.
//
// K6 replaces the Pallas TPU kernel `razer_grouped_matmul_pallas`
// (src/repro/kernels/razer_grouped_matmul.py:62): E independent packed
// GEMMs in one launch, the MoE expert einsum with the dispatch groups and
// capacity slots flattened into M, without a dense copy of the bank.  K8
// replaces `razer_grouped_matmul_kshard_pallas` (razer_grouped_matmul.py:
// 109): K6 over this rank's (E/ep, K/tp) bank tile, its full-N partial
// stored chunk-major, (tp, E, M, N/tp), for reduce_scatter_tensor (which
// scatters along dim 0) to hand each rank its N/tp columns.
//
//   y[e, M, N] (f32) = x[e, M, K] @ dequant(codes[e, K/2, N], scale_meta[e, K/16, N])
//
// The per-expert tensor scale is applied by the Python wrapper.
//
// What bounds it on this card: at decode an expert sees M = groups x capacity
// rows (4 at a batch-4 decode of DBRX), so every weight byte is used a few
// times and the kernel is bound by the 4.5-bit bank it streams from HBM
// (16 x 6144 x 10752 x 0.5625 B = 594.5 MB a call for DBRX's gate or up).
//
// Design: a grouped K1, not a copy of the Pallas grid.  The TPU kernel runs
// an (E, M/bm, N/bn, K/bk) grid in order on one core and carries each
// tile's sum across the K steps in VMEM.  Here the grid is
// (N/BN, ceil(M/NT), E * splits): blockIdx.z names the expert and its K
// split, each expert's x, codes and scale_meta are reached by expert
// strides, and kernel and tile are K1's mixed-input wgmma GEMM
// (razer_matmul_tile.cuh), with the split count the Python wrapper takes
// from K1's (N, K) rule and the split sum in a fixed order inside the
// launch.  So:
//  (a) expert e returns K1's bits on bank entry e;
//  (b) a row's bits do not move with M, so decode, padded serve slots,
//      verify passes and prefill give a token the same expert output.
// Skipping the all-zero capacity rows is later work.

#include "razer_matmul_tile.cuh"

struct K6;  // names the grouped GEMM's kernel in a profile
struct K8;  // names its K-shard form

// x: (E, M, K) bf16 (x_is_bf16 = 1) or f32, contiguous; codes (E, K/2, N)
// and scale_meta (E, K/16, N) uint8; out (E, M, N) f32.  nt, splits and
// k_tiles_per_split as razer_matmul_launch's.  K must be a multiple of 64
// and E * splits at most 65535.  Returns cudaGetLastError() after the
// launch.
extern "C" int razer_grouped_matmul_launch(const void* x, int x_is_bf16, const void* codes,
                                           const void* scale_meta, void* out, int E, int M, int K, int N, int nt,
                                           int splits, int k_tiles_per_split, float m0, float m1, void* stream) {
  return static_cast<int>(razer_tile::launch_grouped<K6>(
      x, x_is_bf16, codes, scale_meta, out, E, M, K, N, nt,
      splits, k_tiles_per_split, 1, m0, m1, nullptr, 0,
      static_cast<cudaStream_t>(stream)));
}

// K8: as razer_grouped_matmul_launch on this rank's bank tile, with out
// stored as (out_chunks, E, M, N/out_chunks).  N must be a multiple of
// out_chunks.  Returns cudaGetLastError() after the launch.
extern "C" int razer_grouped_matmul_kshard_launch(const void* x, int x_is_bf16, const void* codes,
                                                  const void* scale_meta, void* out, int E, int M, int K, int N,
                                                  int nt, int splits, int k_tiles_per_split, int out_chunks,
                                                  float m0, float m1, void* stream) {
  return static_cast<int>(razer_tile::launch_grouped<K8>(
      x, x_is_bf16, codes, scale_meta, out, E, M, K, N, nt,
      splits, k_tiles_per_split, out_chunks, m0, m1, nullptr, 0,
      static_cast<cudaStream_t>(stream)));
}
