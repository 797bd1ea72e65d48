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
// What bounds it on this card: each cache byte is read once and used by the
// G = H / KVH query rows of its head, a few operations per byte, so it is
// bound by the cache bytes up to cur_len (and, at small batch, by launch
// latency and the B * KVH blocks it has to spread over 132 SMs).
//
// Design: one block per (b, kv head) holding its G query rows; the body --
// chunks of SC positions, online softmax, stop at cur_len[b], which the TPU
// kernel does not do -- is `razer_kv::attend` (razer_kv_attend.cuh), shared
// with the paged kernels so that they compute the same bits.  A split-S
// second pass for long caches is later work.

#include "razer_kv_attend.cuh"

namespace {

// position p of sequence b lives at row (b, p, kh) of the (B, S, KVH, .) cache
struct ContiguousRows {
  int b, S, KVH, kh;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return ((size_t)b * S + pos) * KVH + kh;
  }
};

__global__ void __launch_bounds__(razer_kv::THREADS)
razer_kv_attention_kernel(const float* __restrict__ q, const uint8_t* __restrict__ k_codes,
                          const uint8_t* __restrict__ k_meta, const uint8_t* __restrict__ v_codes,
                          const uint8_t* __restrict__ v_meta, const int* __restrict__ cur_len,
                          float* __restrict__ out, int S, int KVH, int G, int hd, float scale) {
  const int b = blockIdx.x / KVH;
  const int kh = blockIdx.x % KVH;
  const size_t head0 = ((size_t)b * KVH * G + (size_t)kh * G) * hd;
  const int len = min(cur_len[b], S);
  razer_kv::attend(q + head0, k_codes, k_meta, v_codes, v_meta, len, ContiguousRows{b, S, KVH, kh},
                   out + head0, G, hd, scale);
}

}  // namespace

// q (B, KVH * G, hd) f32; caches (B, S, KVH, hd/2 | hd/16) uint8; cur_len
// (B,) int32 on the device; out (B, KVH * G, hd) f32.  G <= 8, hd a multiple
// of 16 and <= 256.  Returns cudaGetLastError().
extern "C" int razer_kv_attention_launch(const void* q, const void* k_codes, const void* k_meta,
                                         const void* v_codes, const void* v_meta,
                                         const void* cur_len, void* out, int B, int S, int KVH,
                                         int G, int hd, void* stream) {
  using namespace razer_kv;
  if (G < 1 || G > MAX_G || hd % 16 != 0 || hd > THREADS * MAX_D_PER_THREAD)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(G, hd);
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
