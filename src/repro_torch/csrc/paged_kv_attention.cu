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
// used by the G = H / KVH query rows of its head (T G rows for K5).
//
// Design: the TPU kernel walks a sequential (b, kv head, page) grid whose
// index maps do the page-table gather through scalar prefetch; neither
// exists on a GPU.  Here the grid is (split, kv head, b): each block runs
// the body of the contiguous kernel K3 (`razer_kv::attend`,
// razer_kv_attend.cuh) over one 256-position split of one sequence, with a
// row functor that reads page_table[b, p / ps] itself for the positions it
// stages, and the last block of a (b, kv head) combines the splits.  K5's
// block takes all T queries of its (b, kv head) (up to 32 / G of them; a
// call with more launches once per 32 / G queries), so each page is read
// once for them, and masks query t at cur_len + t + 1 with K4's cut and order:
// K4 gives K3's bits on the same bytes, and K5's query t gives K4's bits at
// cur_len + t + 1, the exact reduction a vanilla decode step performs there.

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

// grid (splits, KVH, B): block (split, kh, b)
template <int HD, int NTM>
__global__ void __launch_bounds__(razer_kv::THREADS, razer_kv::MinBlocks<NTM>::value)
paged_kv_attention_kernel(const razer_kv::Params p, const int* __restrict__ page_table, int NP, int ps) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  razer_kv::attend<HD, NTM>(p, PagedRows{page_table + (size_t)b * NP, ps, p.KVH, kh}, b, kh, split);
}

struct Launch {
  razer_kv::Params p;
  const int* page_table;
  int B, NP, ps, rows;
  cudaStream_t stream;
  template <int HD, int NTM>
  int go() const {
    const size_t smem = razer_kv::smem_bytes<HD>(rows);
    auto kernel = paged_kv_attention_kernel<HD, NTM>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dim3 grid(p.nsplit_grid, p.KVH, B);
    kernel<<<grid, razer_kv::THREADS, smem, stream>>>(p, page_table, NP, ps);
    return static_cast<int>(cudaGetLastError());
  }
};

int launch(const void* q, const void* k_codes, const void* k_meta, const void* v_codes, const void* v_meta,
           const void* page_table, const void* cur_len, void* out, void* ws, void* counters, int B, int TQ,
           int t0, int T, int verify, int NP, int ps, int KVH, int G, int hd, void* stream) {
  using namespace razer_kv;
  const int rows = T * G;
  if (G < 1 || G > MAX_G || T < 1 || rows > MAX_ROWS || t0 < 0 || t0 + T > TQ || !built_hd(hd) || ps < 1 ||
      NP < 1 || B < 1 || KVH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l;
  l.p = Params{static_cast<const float*>(q), static_cast<const uint8_t*>(k_codes),
               static_cast<const uint8_t*>(k_meta), static_cast<const uint8_t*>(v_codes),
               static_cast<const uint8_t*>(v_meta), static_cast<const int*>(cur_len), static_cast<float*>(out),
               static_cast<float*>(ws), static_cast<int*>(counters), T, verify, G, KVH, NP * ps,
               num_splits(NP * ps), num_groups(num_splits(NP * ps)), B, TQ, t0, score_scale(hd),
               {copy_unit(k_codes, hd / 2), copy_unit(k_meta, hd / 16), copy_unit(v_codes, hd / 2),
                copy_unit(v_meta, hd / 16)}};
  l.page_table = static_cast<const int*>(page_table);
  l.B = B, l.NP = NP, l.ps = ps, l.rows = rows;
  l.stream = static_cast<cudaStream_t>(stream);
  const int nt = (rows + 3) / 4;  // n-tiles of 4 query rows (and their low parts)
  if (nt <= 2) return dispatch_hd<2>(hd, l);
  if (nt <= 4) return dispatch_hd<4>(hd, l);
  return dispatch_hd<8>(hd, l);
}

}  // namespace

// K4.  q (B, KVH * G, hd) f32; pool arrays (P, ps, KVH, hd/2 | hd/16) uint8;
// page_table (B, NP) int32, entries in [0, P); cur_len (B,) int32; out
// (B, KVH * G, hd) f32; ws a float32 workspace of at least B * KVH *
// (splits + groups) * partial_floats(G, hd) floats and counters
// B * KVH * (groups + 1) int32, zero (each call leaves them zero), for the
// splits(NP * ps) splits and their groups of 8.  G <= 8, hd 16, 64 or
// 128.  Returns cudaGetLastError().
extern "C" int paged_kv_attention_launch(const void* q, const void* k_codes, const void* k_meta,
                                         const void* v_codes, const void* v_meta, const void* page_table,
                                         const void* cur_len, void* out, void* ws, void* counters, int B, int NP,
                                         int ps, int KVH, int G, int hd, void* stream) {
  return launch(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len, out, ws, counters, B, 1, 0, 1, 0, NP,
                ps, KVH, G, hd, stream);
}

// K5 over queries [t0, t0 + T) of TQ.  q (B, TQ, KVH * G, hd) f32; out
// (B, TQ, KVH * G, hd) f32, this launch writing its queries' rows; cur_len
// (B,) int32 is the committed length before the TQ positions; T * G <= 32;
// the workspace as K4's with T * G rows; the rest as K4.
extern "C" int paged_kv_attention_verify_launch(const void* q, const void* k_codes, const void* k_meta,
                                                const void* v_codes, const void* v_meta, const void* page_table,
                                                const void* cur_len, void* out, void* ws, void* counters, int B,
                                                int TQ, int t0, int T, int NP, int ps, int KVH, int G, int hd,
                                                void* stream) {
  return launch(q, k_codes, k_meta, v_codes, v_meta, page_table, cur_len, out, ws, counters, B, TQ, t0, T, 1, NP,
                ps, KVH, G, hd, stream);
}
