// Single-query decode attention over a RaZeR-packed KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `razer_kv_attention_pallas`
// (src/repro/kernels/razer_kv_attention.py:101, tile decode `_dequant_tile`).
//
//   out[b, h, :] = softmax(q[b, h] . K[b, :cur_len[b], h / G] / sqrt(hd))
//                  @ V[b, :cur_len[b], h / G]                     (f32)
//
// K and V arrive in the 4.5-bit wire format as (B, S, KVH, hd/2) code bytes
// and (B, S, KVH, hd/16) meta bytes.
//
// What bounds it on this card: each cache byte up to cur_len is read once
// and used by the G = H / KVH query rows of its head, about 11 flop per
// byte at G = 3 plus the decode, so it is bound by the cache bytes (and at
// short lengths by the launch and the blocks it has to spread over 132 SMs).
//
// Design: the grid is (split, kv head, b), one block per 256-position split
// of a sequence, stopping at cur_len[b] (which the TPU kernel does not do);
// the body -- staging, decode, tensor-core scores and outputs, softmax and
// the split combine -- is `razer_kv::attend` (razer_kv_attend.cuh), shared
// with the paged kernels so that they compute the same bits.

#include "razer_kv_attend.cuh"

namespace {

// position p of sequence b lives at row (b, p, kh) of the (B, S, KVH, .) cache
struct ContiguousRows {
  int b, S, KVH, kh;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return ((size_t)b * S + pos) * KVH + kh;
  }
};

template <int HD, int NTM>
__global__ void __launch_bounds__(razer_kv::THREADS, razer_kv::MinBlocks<NTM>::value)
razer_kv_attention_kernel(const razer_kv::Params p, int S) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  razer_kv::attend<HD, NTM>(p, ContiguousRows{b, S, p.KVH, kh}, b, kh, split);
}

struct Launch {
  razer_kv::Params p;
  int B, S;
  cudaStream_t stream;
  template <int HD, int NTM>
  int go() const {
    const size_t smem = razer_kv::smem_bytes<HD>(p.G);
    auto kernel = razer_kv_attention_kernel<HD, NTM>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid(p.nsplit_grid, p.KVH, B);
    kernel<<<grid, razer_kv::THREADS, smem, stream>>>(p, S);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q (B, KVH * G, hd) f32; caches (B, S, KVH, hd/2 | hd/16) uint8; cur_len
// (B,) int32 on the device; out (B, KVH * G, hd) f32; ws a float32
// workspace of at least B * KVH * (splits + groups) * partial_floats(G, hd)
// floats and counters B * KVH * (groups + 1) int32, zero (each call leaves
// them zero), for the splits(S) splits and their groups of 8.  G <= 8,
// hd 16, 64 or 128.  Returns cudaGetLastError().
extern "C" int razer_kv_attention_launch(const void* q, const void* k_codes, const void* k_meta,
                                         const void* v_codes, const void* v_meta, const void* cur_len, void* out,
                                         void* ws, void* counters, int B, int S, int KVH, int G, int hd,
                                         void* stream) {
  using namespace razer_kv;
  if (G < 1 || G > MAX_G || !built_hd(hd) || B < 1 || S < 1 || KVH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  l.p = Params{static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
               static_cast<const uint8_t*>(k_meta), static_cast<const uint8_t*>(v_codes),
               static_cast<const uint8_t*>(v_meta), static_cast<const int*>(cur_len), static_cast<float*>(out),
               static_cast<float*>(ws), static_cast<int*>(counters), 1, 0, G, KVH, S, num_splits(S),
               num_groups(num_splits(S)), B, 1, 0, score_scale(hd),
               {copy_unit(k_codes, hd / 2), copy_unit(k_meta, hd / 16), copy_unit(v_codes, hd / 2),
                copy_unit(v_meta, hd / 16)}};
  l.B = B, l.S = S;
  l.stream = static_cast<cudaStream_t>(stream);
  return dispatch_hd<2>(hd, l);  // G <= 8 rows: at most two n-tiles
}
