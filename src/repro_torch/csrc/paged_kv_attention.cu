// Decode (K4) and speculative-verify (K5) attention over the paged
// RaZeR-packed KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `paged_kv_attention_pallas` (K4,
// src/repro/kernels/paged_kv_attention.py:71) and
// `paged_kv_attention_verify_pallas` (K5, same file, :170).
//
//   K4: out[b, h]    = softmax(q[b, h] . K_b[:cur_len[b]]) @ V_b[:cur_len[b]]
//   K5: out[b, t, h] = the same with q[b, t, h] over cur_len[b] + t + 1
//                      positions (cur_len = the committed length)
//
// where position p of sequence b lives at slot p % ps of the physical page
// page_table[b, p / ps] of the pool (P, ps, KVH, hd/2 | hd/16); page 0 is the
// null page idle slots point at.
//
// What bounds it on this card: the valid pages' bytes, each read once and
// used by the G = H / KVH query rows of its head, a few operations per byte.
//
// Design: the TPU kernel walks a sequential (b, kv head, page) grid whose
// index maps do the page-table gather through scalar prefetch; neither
// exists on a GPU.  Here one block takes one (b, kv head) -- one (b, t, kv
// head) for K5 -- and runs the body of the contiguous kernel K3
// (`razer_kv::attend`, razer_kv_attend.cuh) with a row functor that reads
// page_table[b, p / ps] itself, only for positions below the query's length.
// So K4 gives K3's bits on the same bytes, and K5's query t gives K4's bits
// at cur_len + t + 1, the exact reduction a vanilla decode step performs
// there.  K5 re-reads a slot's pages once per query (T times, mostly from
// L2); fusing the T queries into one pass over the pages is later work.

#include "razer_kv_attend.cuh"

namespace {

// position p of sequence b lives at slot p % ps of page page_table[b, p / ps]
struct PagedRows {
  const int* row;  // page_table + b * NP
  int ps, KVH, kh;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return ((size_t)row[pos / ps] * ps + pos % ps) * KVH + kh;
  }
};

// grid (B * T, KVH): block (b * T + t, kh); its query length is
// cur_len[b] + (verify ? t + 1 : 0), clamped to the page table's span
__global__ void __launch_bounds__(razer_kv::THREADS)
paged_kv_attention_kernel(const float* __restrict__ q, const uint8_t* __restrict__ k_codes,
                          const uint8_t* __restrict__ k_meta, const uint8_t* __restrict__ v_codes,
                          const uint8_t* __restrict__ v_meta, const int* __restrict__ page_table,
                          const int* __restrict__ cur_len, float* __restrict__ out, int T,
                          int verify, int NP, int ps, int KVH, int G, int hd, float scale) {
  const int bt = blockIdx.x;
  const int b = bt / T;
  const int t = bt % T;
  const int kh = blockIdx.y;
  const size_t head0 = ((size_t)bt * KVH * G + (size_t)kh * G) * hd;
  const int len = min(cur_len[b] + (verify ? t + 1 : 0), NP * ps);
  razer_kv::attend(q + head0, k_codes, k_meta, v_codes, v_meta, len,
                   PagedRows{page_table + (size_t)b * NP, ps, KVH, kh}, out + head0, G, hd, scale);
}

int launch(const void* q, const void* k_codes, const void* k_meta, const void* v_codes,
           const void* v_meta, const void* page_table, const void* cur_len, void* out, int B,
           int T, int verify, int NP, int ps, int KVH, int G, int hd, void* stream) {
  using namespace razer_kv;
  if (G < 1 || G > MAX_G || hd % 16 != 0 || hd > THREADS * MAX_D_PER_THREAD || T < 1 || ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(G, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_kv_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf((float)hd);
  dim3 grid(B * T, KVH);
  paged_kv_attention_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
      static_cast<const uint8_t*>(k_meta), static_cast<const uint8_t*>(v_codes),
      static_cast<const uint8_t*>(v_meta), static_cast<const int*>(page_table),
      static_cast<const int*>(cur_len), static_cast<float*>(out), T, verify, NP, ps, KVH, G, hd,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4.  q (B, KVH * G, hd) f32; pool arrays (P, ps, KVH, hd/2 | hd/16) uint8;
// page_table (B, NP) int32, entries in [0, P); cur_len (B,) int32; out
// (B, KVH * G, hd) f32.  G <= 8, hd a multiple of 16 and <= 256.  Returns
// cudaGetLastError().
extern "C" int paged_kv_attention_launch(const void* q, const void* k_codes, const void* k_meta,
                                         const void* v_codes, const void* v_meta,
                                         const void* page_table, const void* cur_len, void* out,
                                         int B, int NP, int ps, int KVH, int G, int hd,
                                         void* stream) {
  return launch(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len, out, B, 1, 0, NP, ps,
                KVH, G, hd, stream);
}

// K5.  q (B, T, KVH * G, hd) f32; out (B, T, KVH * G, hd) f32; cur_len (B,)
// int32 is the committed length before the T positions; the rest as K4.
extern "C" int paged_kv_attention_verify_launch(const void* q, const void* k_codes,
                                                const void* k_meta, const void* v_codes,
                                                const void* v_meta, const void* page_table,
                                                const void* cur_len, void* out, int B, int T,
                                                int NP, int ps, int KVH, int G, int hd,
                                                void* stream) {
  return launch(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len, out, B, T, 1, NP, ps,
                KVH, G, hd, stream);
}
