// Causal GQA prefill attention for Hopper (sm_90a), K9.
//
// No Pallas counterpart: the JAX package computes full-sequence attention
// in jnp outside any kernel (src/repro/models/attention.py:54,
// `chunked_attention`).  This kernel exists for the port's own invariant:
// a row's output must not depend on the rows around it, so that serving a
// prompt alone at its bucket gives the bits of generating it inside a
// padded batch.  Batched matmuls do not give that (the library picks its
// summation by shape); here every query row walks its keys the same way
// whatever B, Sq, the padded Skv, its place in a tile or the GQA group
// around it.
//
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * scale) @ v[b, j, h / G]
//   over keys j <= q_offset + i (causal) or all j < Skv, and with a sliding
//   window w > 0 only keys j > q_offset + i - w (RecurrentGemma's local
//   attention, src/repro/models/attention.py:112)
//
// q and k have head width HD, v and out DV: DV = HD at hd 16, 32, 64 and
// 128; at HD 192, MLA's qk_nope + qk_rope (DeepSeek-V2), V is 128 wide
// (v_head_dim).  The reference pads MLA's V with zeros to 192 only so that
// its attention sees one head width, and slices the output back to 128;
// each output dim is its own sum over the same P, so attending V at 128
// keeps every kept dim's bits and drops 64 dims of zeros.  It is also what
// fits: the tensor-core body's shared memory at one head a block is 270,464
// bytes with V at 192 and 229,504 with V at 128, against the H100's 232,448
// a block.
//
// At HD 256 (RecurrentGemma) the tensor-core body takes bf16 K and V only,
// with two ring stages and no low-tile region: 2 heads x 32,768 (q) + 2 x
// 65,536 (ring) + 128 = 196,736 bytes, where three stages and the low tiles
// would need 360,576 for one head.  bf16 K/V -- what the exact-length
// prefill attends -- have no low parts, so nothing is left out; keeping the
// 64-key chunk keeps the arithmetic of every other width.  A bf16 q with
// f32 K/V at HD 256 runs the f32 body (the choice is by the dtypes, made
// the same way for every call: kernels/prefill_attention.py, `kernel_body`).
// Two heads a block, not three: o is 128 f32 registers a thread at HD 256,
// which needs the 255 registers 256 threads a block leave.
//
// Two bodies, chosen by q's dtype alone (kernels/prefill_attention.py,
// `kernel_body`): a bf16 q -- the serving path, whose compute dtype is bf16
// -- runs the tensor-core body; an f32 q (the f32 engines the checks run)
// runs the f32 body on the CUDA cores, whose error the split arithmetic
// below cannot bring within the f32 tolerance of its plain version.  The
// choice is by dtype, not a fallback: a failed build or launch raises.
//
// Arithmetic shared by both bodies, per query row:
//  * keys go in chunks of W = 64 positions, from the chunk that holds the
//    block's first row's first key (chunk 0 without a window) up to the
//    block's last row's causal limit; a key outside the row's range
//    [first, limit] scores -1e30 and its p is exactly 0; a chunk with no
//    valid key for a row leaves that row's state unchanged: its max is then
//    taken as 0 for the exponent, so every p is exp2(-1e30) = 0, alpha is
//    exp2(m - m) = 1, and l x 1 + 0 and o x 1 + 0 are exact.  So the chunks
//    a block walks before a row's first key (a window's rows) or past its
//    limit (causal rows) leave no trace in it, and its first valid chunk
//    starts from m = -1e30, l = 0, o = 0 wherever the block began;
//  * m' = max(m, chunk max); p = exp(score - m'); alpha = exp(m - m');
//    l = l alpha + (p summed in a fixed order over the chunk);
//    acc = acc alpha + p v summed in a fixed order;
//  * out = acc / max(l, 1e-30), in q's dtype.
// So a row's bits depend only on its q, the keys and values at or before
// its position, and its position.
//
// The tensor-core body: two kernels a call.
//  * What bounds it: 4 x hd operations per (query, key) pair, about 2 x
//    Sq x Skv x H x 2 hd for a causal prefill, against the bytes of q, k,
//    v and out once: bound by operations at every prefill bucket.
//  * Exactness.  An f32 value x is split into three bf16 parts, hi =
//    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (each difference
//    exact in f32); for a normal f32 nothing is left.  Two parts leave up
//    to 2^-16 of x, which does not hold the f32-K/V tolerance against the
//    plain version (tests/test_torch_prefill_split.py emulates the three).
//    Products of bf16 parts are exact in the f32 accumulators, so only the
//    order of the f32 sums differs from the plain version -- and how the
//    tensor cores round them: an accumulation of products onto a large
//    running sum there drifts much further from the f32 sum than a sum
//    rounded to nearest (on an H100 at B 1 x 4096 with random f32 K/V, up
//    to 1.4e-6 where the output is near zero: outside the f32-K/V
//    tolerance; PERF.md, section 6).  So no tensor-core sum
//    outlives a chunk: each chunk's P V is summed from zero, a slice of NS
//    output dims at a time, and added to o on the CUDA cores, o = o alpha +
//    slice, with one rounding (fma);
//      S = q K^T = q hi(K)^T + q mid(K)^T + q lo(K)^T  (q is bf16: exact);
//      P V for f32 V: the part pairs (hi, hi), (mid, hi), (lo, hi), (hi,
//      mid), (mid, mid), (hi, lo) of (P, V); for bf16 V, P is rounded to
//      bf16 first, as the plain version casts it to V's dtype.
//    K/V from the KV wire format (prefill's `_qdq_kv`: an FP4 value times
//    an E4M3 scale, at most 7 significant bits) are exact in bf16: their
//    mid and lo parts are all zero.  Per 64-key chunk a block-wide vote
//    (__syncthreads_or) finds whether any K or V value of it has a non-zero
//    lower half, and where none has, the mid and lo tiles are neither
//    written nor read and their MMAs are skipped.  Adding the skipped
//    products -- exact zeros -- would change no value (at most the sign of
//    a zero), so the skip is bit-neutral.  It must be: the vote can differ
//    between a prompt alone and the same prompt in a batch, where the
//    padding past its length holds other values.  So the serving path runs
//    one score MMA and three P V MMAs per tile.
//  * The split (prefill_attention_tc_split_kernel), one block per (64-key
//    chunk, kv head, b): K and V are read once, in their own dtype (zero
//    past Skv), and written as bf16 tiles in the layout the MMAs read -- K
//    as K-major rows of keys, V transposed (rows of dims, keys along k),
//    8-row x 16-byte core matrices through stmatrix(.trans) -- into a
//    workspace, hi tiles always, mid and lo where the chunk's vote says,
//    with one flag a chunk.  The attention then reads half the bytes of f32
//    K/V and converts nothing: converting inside the attention block
//    stalled all its warps once a chunk (PERF.md, section 6).
//  * The attention (prefill_attention_tc_kernel).  Grid: a block owns 64
//    query positions of one (batch, kv head) for GB of the kv head's G
//    query heads (GB the largest divisor of G up to 3: one warpgroup a
//    head, each warp 16 positions); each chunk's tiles are staged once for
//    GB x 64 rows.  The heaviest query blocks (the last positions) are
//    scheduled first.  Staging: a ring of three stages of (K hi, V^T hi),
//    each filled from the workspace by one bulk copy (the copy engine)
//    that completes on the stage's mbarrier; a flagged chunk's low tiles
//    go into a region of their own the same way.  Each warpgroup walks the
//    chunks on its own, waiting for a stage's mbarrier; the last of the
//    block's warpgroups to finish a stage refills it three chunks on.  No
//    block barrier in the loop: one warpgroup's softmax runs beside
//    another's wgmmas.
//  * Math: wgmma, bf16 -> f32.  S = q K^T: m64n64k16 with q and K from
//    shared memory (descriptors, no swizzle); a chunk's P V: m64n{NS}k16
//    per slice of NS = min(hd, 64) output dims (NS / 2 accumulators a
//    thread beside o's hd / 2: three warpgroups leave no room for a second
//    full-width accumulator; slices of 32 were slower) with P from
//    registers -- the score
//    accumulators' layout is the A fragment's -- and V^T from shared
//    memory.  The k-steps over hd and over a chunk's
//    keys run in a fixed order, and an accumulator element sums only its
//    own row's q and P, so a row's bits do not move with its slot in the
//    64-row tile (the continuation checks at q_offset 40 and 1000 move rows
//    to other slots and hold them bit for bit).
//  * Softmax in registers: a row's 64 scores of a chunk lie with the four
//    lanes of a quad, 16 each; each lane folds its 16 in key order, then
//    the quad combines by xor-shuffles 1 and 2 (fadd and fmax commute, so
//    all four lanes get the same bits).  Exponentials are base 2 on scores
//    scaled by scale x log2 e.  One shortcut, exact: a warp whose rows all
//    see the whole chunk skips the mask's compares.
//
// The f32 body (prefill_attention_f32_kernel): a block owns 64 query
// positions of one head; it stages the chunk's K and V in shared memory as
// f32, each of its 256 threads computes a 4 x 4 tile of scores (rows ty +
// 16 r, keys tx + 16 c) with one f32 FMA per dim in d order, a row's 16
// threads share one half-warp for the max and the sum (a fixed butterfly),
// P goes through shared memory, and each thread accumulates 4 rows x hd /
// 16 dims of the output in key order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "razer_matmul_tile.cuh"  // razer_tile::Wgmma and the wgmma fences

namespace {

constexpr int BQ = 64;  // query positions per block
constexpr int W = 64;   // keys per chunk

struct Params {
  const void* q;  // (B, Sq, H, HD)
  const void* k;  // (B, Skv, KVH, HD)
  const void* v;  // (B, Skv, KVH, DV)
  void* out;      // (B, Sq, H, DV), q's dtype
  void* ws;       // the tensor-core body's split K/V tiles (B, KVH, ceil(Skv / 64)) x 3 x 64 x (HD + DV) bf16
  int* flags;     // (B, KVH, ceil(Skv / 64)): the chunk has non-zero low tiles
  int q_bf16, k_bf16, v_bf16;  // 1: bf16, 0: f32
  int B, Sq, Skv, H, KVH, q_offset, causal, window;
  float scale;
};

// the last key row `pos` may attend
__device__ __forceinline__ int row_limit(const Params& p, int pos) {
  return p.causal ? min(p.q_offset + pos, p.Skv - 1) : p.Skv - 1;
}
// the first key row `pos` may attend: past its window, else 0
__device__ __forceinline__ int row_first(const Params& p, int pos) {
  return p.window > 0 ? max(p.q_offset + pos - p.window + 1, 0) : 0;
}

// ===========================================================================
// the tensor-core body
// ===========================================================================
namespace tc {

using razer_tile::cp_async16;
using razer_tile::cp_async_commit;
using razer_tile::cp_async_wait_all;
using razer_tile::fence_operands;
using razer_tile::fence_proxy_async;
using razer_tile::smem_u32;
using razer_tile::wgmma_commit;
using razer_tile::wgmma_fence;
using razer_tile::wgmma_wait;

constexpr int MAX_GB = 3;                  // query heads per block, at most: one warpgroup each
constexpr size_t MAX_SMEM = 232448;        // dynamic shared memory a block can have on an H100

// mbarriers: one arrival (with the bytes to expect) completes a phase once
// the bytes have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {  // until phase `parity` has completed
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16) global -> shared by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// four 8 x 8 bf16 matrices from registers to shared memory: lanes 8i .. 8i + 7
// give the row addresses of matrix i, register i of lane t holds its row
// t / 4, columns 2 (t % 4) and + 1 (transposed: row 2 (t % 4) and + 1, column t / 4)
__device__ __forceinline__ void stmatrix_x4(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void stmatrix_x4_trans(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// (a, b) -> bf16x2 bits, a in the low half, each rounded to nearest
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) -> their three bf16 parts as bf16x2 (hi, mid, lo): each part the
// rounding of what the earlier ones leave, every difference exact in f32
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = bf16x2_bits(x0, x1);
  x0 = __fsub_rn(x0, __uint_as_float(hi << 16)), x1 = __fsub_rn(x1, __uint_as_float(hi & 0xFFFF0000u));
  mid = bf16x2_bits(x0, x1);
  x0 = __fsub_rn(x0, __uint_as_float(mid << 16)), x1 = __fsub_rn(x1, __uint_as_float(mid & 0xFFFF0000u));
  lo = bf16x2_bits(x0, x1);
}

// Byte offset of element (row, k) in a K-major bf16 tile of `depth` k per
// row, in wgmma's interleaved layout: 8-row x 16-byte core matrices, the
// two 8-deep halves of a 16-deep k-step 128 bytes apart (LBO), k-steps 256
// bytes apart, groups of 8 rows depth x 16 bytes apart (SBO).
__host__ __device__ constexpr int core_off(int row, int k, int depth) {
  return (row >> 3) * (depth * 16) + (k >> 4) * 256 + ((k >> 3) & 1) * 128 + (row & 7) * 16 + (k & 7) * 2;
}
// descriptor of the k-step at `p` of such a tile
__device__ __forceinline__ uint64_t desc(const void* p, int depth) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(depth) << 32);  // SBO = depth x 16 bytes, in 16-byte units
}

// S (64 x 64 f32) += Q (64 x 16, shared) . K^T (16 x 64, shared)
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da, uint64_t db) {
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

template <int HD, int DV>
struct Geo {
  static constexpr bool LOW_TILES = HD != 256;  // f32 K/V taken: low tiles; at HD 256 bf16 K/V only
  static constexpr int KT = W * HD * 2;    // bytes of one K part tile (and of a q tile) of a chunk
  static constexpr int VT = W * DV * 2;    // bytes of one V^T part tile
  static constexpr int STAGE = KT + VT;    // a ring stage: K hi, V^T hi
  static constexpr int LOWS = LOW_TILES ? 2 * STAGE : 0;  // a chunk's low tiles: K mid, K lo, V^T mid, V^T lo
  static constexpr int CHUNK = STAGE + LOWS;  // a chunk in the workspace: K hi, V^T hi, then its low tiles
  static constexpr int NUK = W * HD / 256;  // stmatrix x4 units (four 8 x 8 blocks) of K's chunk
  static constexpr int NUV = W * DV / 256;  // ... and of V's
  static constexpr int NST = LOW_TILES ? 3 : 2;  // stages of the hi tiles' ring
  static constexpr int NS = DV < 64 ? DV : 64;  // output dims per P V slice (its accumulators: NS / 2 a thread)
  static constexpr int GB_CAP = HD == 256 ? 2 : MAX_GB;  // heads a block, at most: o's registers at HD 256
  // the attention kernel's dynamic shared memory for gb heads: q tiles, the
  // ring of (K hi, V^T hi) stages, one chunk's four low tiles, the
  // stages' and the low tiles' mbarriers and release counts
  static constexpr size_t bytes(int gb) { return (size_t)gb * KT + (size_t)NST * STAGE + LOWS + 128; }
  static constexpr size_t split_bytes() { return (size_t)CHUNK; }
  // the most heads a block can hold in shared memory and registers
  static constexpr int max_gb() {
    return GB_CAP >= 3 && bytes(3) <= MAX_SMEM ? 3 : GB_CAP >= 2 && bytes(2) <= MAX_SMEM ? 2 : 1;
  }
  static_assert(bytes(1) <= MAX_SMEM, "one head a block must fit the H100's shared memory");
};

// ---------------------------------------------------------------------------
// the split: K/V chunk -> bf16 part tiles in the workspace
// ---------------------------------------------------------------------------
// One block per (chunk, kv head, b).  K (HD dims) goes to K-major rows of
// keys, V (DV dims) transposed (rows of dims, keys along k), in 8 x 8
// blocks through stmatrix;
// lane t reads key t / 4, dims 2 (t % 4) and + 1 of each block straight
// from K or V (zero past Skv).  LOWS false: the hi tiles, each f32 value's
// upper half (its bf16 when the lower half is zero), and returns whether
// this thread saw a non-zero lower half; LOWS true: hi rounded to nearest,
// mid and lo, into the part tiles.
template <int HD, int DV, bool LOWS>
__device__ __forceinline__ bool convert(uint8_t* tiles, const Params& p, int b, int kh, int c0) {
  using Gm = Geo<HD, DV>;
  const int lane = threadIdx.x & 31;
  bool low = false;
  for (int u = threadIdx.x >> 5; u < Gm::NUK + Gm::NUV; u += blockDim.x >> 5) {
    const bool is_v = u >= Gm::NUK;
    const int bf16 = is_v ? p.v_bf16 : p.k_bf16;
    if (LOWS && bf16) continue;
    const void* src = is_v ? p.v : p.k;
    const int width = is_v ? DV : HD;
    const int ub = 4 * (is_v ? u - Gm::NUK : u);  // first 8 x 8 block: block i is key group i % 8, dim group i / 8
    uint32_t h[4], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bi = ub + i, key = c0 + 8 * (bi & 7) + (lane >> 2), d = 8 * (bi >> 3) + 2 * (lane & 3);
      const size_t e = (((size_t)b * p.Skv + key) * p.KVH + kh) * width + d;
      const bool in = key < p.Skv;
      if (bf16) {
        h[i] = in ? *reinterpret_cast<const uint32_t*>(static_cast<const __nv_bfloat16*>(src) + e) : 0u;
      } else {
        const float2 x =
            in ? *reinterpret_cast<const float2*>(static_cast<const float*>(src) + e) : make_float2(0.0f, 0.0f);
        if (LOWS) {
          split3(x.x, x.y, h[i], m[i], l[i]);
        } else {
          const uint32_t xa = __float_as_uint(x.x), xb = __float_as_uint(x.y);
          h[i] = __byte_perm(xa, xb, 0x7632);
          low |= ((xa | xb) & 0xFFFFu) != 0u;
        }
      }
    }
    const int bi = ub + (lane >> 3), kg = bi & 7, dg = bi >> 3, rr = lane & 7;
    if (!is_v) {  // K hi at 0, K mid at STAGE, K lo at STAGE + KT
      uint8_t* dst = tiles + core_off(8 * kg + rr, 8 * dg, HD);
      stmatrix_x4(dst, h);
      if (LOWS) stmatrix_x4(dst + Gm::STAGE, m), stmatrix_x4(dst + Gm::STAGE + Gm::KT, l);
    } else {  // V^T hi at KT, V^T mid at STAGE + 2 KT, V^T lo at STAGE + 2 KT + VT
      uint8_t* dst = tiles + Gm::KT + core_off(8 * dg + rr, 8 * kg, W);
      stmatrix_x4_trans(dst, h);
      if (LOWS) stmatrix_x4_trans(dst + Gm::STAGE + Gm::KT, m), stmatrix_x4_trans(dst + Gm::STAGE + Gm::KT + Gm::VT, l);
    }
  }
  return low;
}

// ws: (B, KVH, chunks) x Geo::CHUNK bytes; flags: (B, KVH, chunks), 1 where
// a chunk's K or V holds a value bf16 does not (its low tiles are then
// written; else they are not, and never read)
template <int HD, int DV>
__global__ void __launch_bounds__(256) prefill_attention_tc_split_kernel(const Params p) {
  using Gm = Geo<HD, DV>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const size_t slot = ((size_t)b * p.KVH + kh) * gridDim.x + c;
  const bool low = __syncthreads_or(convert<HD, DV, false>(smem, p, b, kh, c * W));
  if constexpr (Gm::LOW_TILES) {
    if (low) {
      convert<HD, DV, true>(smem, p, b, kh, c * W);
      __syncthreads();
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(static_cast<uint8_t*>(p.ws) + slot * Gm::CHUNK);
  const uint4* src = reinterpret_cast<const uint4*>(smem);
  for (int i = threadIdx.x; i < (low ? Gm::CHUNK : Gm::STAGE) / 16; i += blockDim.x) dst[i] = src[i];
  if (threadIdx.x == 0) p.flags[slot] = low;
}

// ---------------------------------------------------------------------------
// the attention
// ---------------------------------------------------------------------------
template <int HD, int DV>
__global__ void __launch_bounds__(128 * Geo<HD, DV>::GB_CAP, 1) prefill_attention_tc_kernel(const Params p) {
  using Gm = Geo<HD, DV>;
  constexpr int NO = DV / 2;  // output accumulators per thread
  extern __shared__ __align__(1024) uint8_t smem[];
  const int GB = blockDim.x / 128;
  uint8_t* qt = smem;                       // GB q tiles (64 positions x HD, K-major)
  uint8_t* ring = qt + GB * Gm::KT;         // NST stages of (K hi: 64 keys x HD, V^T hi: DV dims x 64 keys)
  uint8_t* lows = ring + Gm::NST * Gm::STAGE;  // K mid, K lo, V^T mid, V^T lo of a flagged chunk
  uint64_t* full = reinterpret_cast<uint64_t*>(lows + Gm::LOWS);  // NST stages', then the low tiles'
  int* done = reinterpret_cast<int*>(full + Gm::NST + 1);           // warpgroups done with a stage, low tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int G = p.H / p.KVH, hblocks = G / GB;
  const int kh = blockIdx.x / hblocks, g0 = (blockIdx.x - kh * hblocks) * GB;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the heaviest query blocks first
  const int b = blockIdx.z;
  const int hs = warp >> 2;  // this warpgroup: head g0 + hs, positions r0 .. r0 + 63
  const int h = kh * G + g0 + hs;
  const int nch = (p.Skv + W - 1) / W;
  const uint8_t* ws = static_cast<const uint8_t*>(p.ws) + ((size_t)b * p.KVH + kh) * nch * Gm::CHUNK;
  const int* flags = p.flags + ((size_t)b * p.KVH + kh) * nch;
  const int last = min(r0 + BQ, p.Sq) - 1;  // the block's last real position
  const int chunks = row_limit(p, last) / W + 1;
  const int first = row_first(p, r0) / W;  // the chunk of the block's first row's first key
  const bool v_bf16 = !Gm::LOW_TILES || p.v_bf16;  // at HD 256 K and V are bf16

  // chunk c's hi tiles into its stage (the ring counts from `first`); the
  // low tiles of the first flagged chunk from c on
  auto load_hi = [&](int c) {
    if (c >= chunks) return;
    uint64_t* bar = full + (c - first) % Gm::NST;
    mbar_expect(bar, Gm::STAGE);
    bulk_copy(ring + ((c - first) % Gm::NST) * Gm::STAGE, ws + (size_t)c * Gm::CHUNK, Gm::STAGE, bar);
  };
  auto load_lows = [&](int c) {
    if constexpr (Gm::LOW_TILES) {
      while (c < chunks && !flags[c]) ++c;
      if (c >= chunks) return;
      mbar_expect(full + Gm::NST, Gm::LOWS);
      bulk_copy(lows, ws + (size_t)c * Gm::CHUNK + Gm::STAGE, Gm::LOWS, full + Gm::NST);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= Gm::NST; ++i) mbar_init(full + i, 1), done[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = first; c < first + Gm::NST; ++c) load_hi(c);
    load_lows(first);
  }

  // q tiles: row i of tile j holds position r0 + i of head g0 + j; rows past Sq are zero
  for (int i = tid; i < GB * BQ * (HD / 8); i += blockDim.x) {
    const int row = i / (HD / 8), d = 8 * (i - row * (HD / 8));
    const int pos = r0 + (row & (BQ - 1)), hh = kh * G + g0 + row / BQ;
    const bool in = pos < p.Sq;
    cp_async16(qt + (row / BQ) * Gm::KT + core_off(row & (BQ - 1), d, HD),
               static_cast<const __nv_bfloat16*>(p.q) + (in ? (((size_t)b * p.Sq + pos) * p.H + hh) * HD + d : 0),
               in);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();  // this thread's q writes, visible to the tensor cores
  __syncthreads();      // everyone's, and the barriers are initialized

  const int pos0 = r0 + 16 * (warp & 3) + gq, lim0 = row_limit(p, pos0), lim1 = row_limit(p, pos0 + 8);
  const int lo0 = row_first(p, pos0), lo1 = row_first(p, pos0 + 8);
  const int wlim = row_limit(p, r0 + 16 * (warp & 3));  // the warp's first row's limit: the least of its rows
  const int wlo = row_first(p, r0 + 16 * (warp & 3) + 15);  // its last row's first key: the greatest
  const float sc = __fmul_rn(p.scale, 1.4426950408889634f);  // scores in base-2 units

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};
  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.0f;

  // Each warpgroup walks the chunks on its own: it waits for a stage's bytes
  // and, when done with them, counts itself out; the last of the block's
  // warpgroups to leave a stage refills it with the chunk NST on (and, for
  // a flagged chunk, loads the next flagged chunk's low tiles).  No barrier
  // holds the warpgroups together, so one's softmax runs beside another's
  // wgmmas.
  int nlow = 0;  // flagged chunks this warpgroup has passed
  for (int c = first; c < chunks; ++c) {
    const int c0 = c * W, st = (c - first) % Gm::NST;
    mbar_wait(full + st, ((c - first) / Gm::NST) & 1);
    const bool low = Gm::LOW_TILES && flags[c] != 0;  // some K or V value of the chunk is not exact in bf16
    if (low) mbar_wait(full + Gm::NST, nlow++ & 1);
    const uint8_t* kt = ring + st * Gm::STAGE;
    const uint8_t* vt = kt + Gm::KT;
    const bool k_low = low && !p.k_bf16, v_low = low && !v_bf16;  // bf16 tensors have no low tiles

    // ---- S = q K^T over the chunk's 64 keys: per k-step hi, then mid and lo where flagged ----
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.0f;
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint64_t dq = desc(qt + hs * Gm::KT + 256 * ks, HD);
      wgmma_qk(s, dq, desc(kt + 256 * ks, HD));
      if (k_low) {
        wgmma_qk(s, dq, desc(lows + 256 * ks, HD));
        wgmma_qk(s, dq, desc(lows + Gm::KT + 256 * ks, HD));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // ---- scale, mask, online softmax: s[4j + e] is row pos0 + 8 (e >> 1), key c0 + 8j + 2tq + (e & 1) ----
    float mx0 = -1e30f, mx1 = -1e30f;
    if (c0 + W - 1 <= wlim && c0 >= wlo) {  // every key of the chunk is visible to every row of this warp
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = __fmul_rn(s[j], sc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = c0 + 8 * j + 2 * tq;
        s[4 * j] = key <= lim0 && key >= lo0 ? __fmul_rn(s[4 * j], sc) : -1e30f;
        s[4 * j + 1] = key + 1 <= lim0 && key + 1 >= lo0 ? __fmul_rn(s[4 * j + 1], sc) : -1e30f;
        s[4 * j + 2] = key <= lim1 && key >= lo1 ? __fmul_rn(s[4 * j + 2], sc) : -1e30f;
        s[4 * j + 3] = key + 1 <= lim1 && key + 1 >= lo1 ? __fmul_rn(s[4 * j + 3], sc) : -1e30f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 2));
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float al0 = exp2f(__fsub_rn(m[0], mn0)), al1 = exp2f(__fsub_rn(m[1], mn1));
    // a row with no valid key yet: its p are exp2(-1e30 - 0) = 0, not exp2(0)
    const float me0 = mn0 == -1e30f ? 0.0f : mn0, me1 = mn1 == -1e30f ? 0.0f : mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(__fsub_rn(s[4 * j], me0));
      s[4 * j + 1] = exp2f(__fsub_rn(s[4 * j + 1], me0));
      s[4 * j + 2] = exp2f(__fsub_rn(s[4 * j + 2], me1));
      s[4 * j + 3] = exp2f(__fsub_rn(s[4 * j + 3], me1));
      sum0 = __fadd_rn(__fadd_rn(sum0, s[4 * j]), s[4 * j + 1]);
      sum1 = __fadd_rn(__fadd_rn(sum1, s[4 * j + 2]), s[4 * j + 3]);
    }
    sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xFFFFFFFFu, sum0, 1));
    sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xFFFFFFFFu, sum1, 1));
    sum0 = __fadd_rn(sum0, __shfl_xor_sync(0xFFFFFFFFu, sum0, 2));
    sum1 = __fadd_rn(sum1, __shfl_xor_sync(0xFFFFFFFFu, sum1, 2));
    l[0] = __fadd_rn(__fmul_rn(l[0], al0), sum0);
    l[1] = __fadd_rn(__fmul_rn(l[1], al1), sum1);
    m[0] = mn0, m[1] = mn1;

    // ---- o = o alpha + P V over the chunk, in slices of NS dims: a slice's products over the chunk's
    //      4 k-steps of 16 keys summed from zero on the tensor cores (P's A fragments from the scores),
    //      then added to o with one rounding on the CUDA cores ----
    uint32_t ph[4][4], pm[4][4], pl[4][4];  // [k-step][register]: keys 16 kk .., n-tiles 2 kk and 2 kk + 1
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
        if (v_bf16) {  // P rounded to bf16, as the plain version casts it to V's dtype
          ph[kk][r] = bf16x2_bits(x0, x1);
          pm[kk][r] = pl[kk][r] = 0u;
        } else {
          split3(x0, x1, ph[kk][r], pm[kk][r], pl[kk][r]);
        }
      }
#pragma unroll
    for (int sl = 0; sl < DV / Gm::NS; ++sl) {
      float a[Gm::NS / 2];
#pragma unroll
      for (int j = 0; j < Gm::NS / 2; ++j) a[j] = 0.0f;
      fence_operands(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // (P, V) parts (hi, hi), (mid, hi), (lo, hi); (hi, mid), (mid, mid), (hi, lo)
        const int off = sl * Gm::NS * W * 2 + 256 * kk;  // V^T rows (dims) sl NS .., keys 16 kk ..
        const uint64_t dv = desc(vt + off, W);
        razer_tile::Wgmma<Gm::NS>::mma(a, ph[kk], dv);
        if (!v_bf16) {
          razer_tile::Wgmma<Gm::NS>::mma(a, pm[kk], dv);
          razer_tile::Wgmma<Gm::NS>::mma(a, pl[kk], dv);
          if (v_low) {
            const uint64_t dm = desc(lows + 2 * Gm::KT + off, W);
            const uint64_t dl = desc(lows + 2 * Gm::KT + Gm::VT + off, W);
            razer_tile::Wgmma<Gm::NS>::mma(a, ph[kk], dm);
            razer_tile::Wgmma<Gm::NS>::mma(a, pm[kk], dm);
            razer_tile::Wgmma<Gm::NS>::mma(a, ph[kk], dl);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(a);
#pragma unroll
      for (int j = 0; j < Gm::NS / 2; j += 4) {
        float* oj = o + sl * (Gm::NS / 2) + j;
        oj[0] = __fmaf_rn(oj[0], al0, a[j]);
        oj[1] = __fmaf_rn(oj[1], al0, a[j + 1]);
        oj[2] = __fmaf_rn(oj[2], al1, a[j + 2]);
        oj[3] = __fmaf_rn(oj[3], al1, a[j + 3]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + hs) : "memory");  // the warpgroup's four warps are done
    if ((tid & 127) == 0) {
      if (atomicAdd(done + c % Gm::NST, 1) == GB - 1) {
        done[c % Gm::NST] = 0;
        load_hi(c + Gm::NST);
      }
      if (Gm::LOW_TILES && low && atomicAdd(done + Gm::NST, 1) == GB - 1) {
        done[Gm::NST] = 0;
        load_lows(c + 1);
      }
    }
  }

  // ---- out = o / max(l, 1e-30), bf16 ----
  const float den0 = fmaxf(l[0], 1e-30f), den1 = fmaxf(l[1], 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = pos0 + 8 * half;
    if (pos >= p.Sq) continue;
    const float den = half ? den1 : den0;
    __nv_bfloat16* op = out + (((size_t)b * p.Sq + pos) * p.H + h) * DV + 2 * tq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
          __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2 * half], den), __fdiv_rn(o[4 * j + 2 * half + 1], den));
  }
}

// query heads per block: the largest divisor of G up to `most` (MAX_GB, or
// fewer where their tiles would not fit in shared memory: 1 at hd 192)
inline int heads_per_block(int G, int most) {
  for (int gb = most; gb > 1; --gb)
    if (G % gb == 0) return gb;
  return 1;
}

template <int HD, int DV>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using Gm = Geo<HD, DV>;
  static unsigned configured = 0;  // devices whose shared-memory limits are raised, as a bit set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(prefill_attention_tc_kernel<HD, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Gm::bytes(Gm::max_gb()));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(prefill_attention_tc_split_kernel<HD, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Gm::split_bytes());
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  const int nch = (p.Skv + W - 1) / W;
  prefill_attention_tc_split_kernel<HD, DV><<<dim3(nch, p.KVH, p.B), 256, Gm::split_bytes(), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = p.H / p.KVH, gb = heads_per_block(G, Gm::max_gb());
  const dim3 grid(p.KVH * (G / gb), (p.Sq + BQ - 1) / BQ, p.B);
  prefill_attention_tc_kernel<HD, DV><<<grid, 128 * gb, Gm::bytes(gb), st>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ===========================================================================
// the f32 body
// ===========================================================================
namespace f32 {

constexpr int THREADS = 256;
constexpr int PSTRIDE = 80;  // P row stride (floats): the two rows a warp writes fall in distinct banks

template <int HD, int DV>
struct Smem {
  static constexpr int QK_STRIDE = HD + 4;  // padded: a phase's 8 key rows hit distinct banks
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * QK_STRIDE;
  static constexpr int V = K + W * QK_STRIDE;
  static constexpr int P = V + W * DV;
  static constexpr int FLOATS = P + BQ * PSTRIDE;
  static constexpr int BYTES = FLOATS * 4;
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

template <int HD, int DV>
__global__ void __launch_bounds__(THREADS) prefill_attention_f32_kernel(const Params p) {
  using S = Smem<HD, DV>;
  constexpr int DPT = DV / 16;  // output dims per thread
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

  // each of this thread's rows: its first and last keys (window, causal limit)
  int lim[4], lo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) lim[r] = row_limit(p, r0 + ty + 16 * r), lo[r] = row_first(p, r0 + ty + 16 * r);
  const int block_lim = row_limit(p, r0 + rows - 1);
  const int chunks = block_lim < 0 ? 0 : block_lim / W + 1;
  const int first = row_first(p, r0) / W;  // the chunk of the block's first row's first key

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -1e30f;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.0f;
  }

  const size_t k_row = (size_t)p.KVH * HD, v_row = (size_t)p.KVH * DV;
  for (int c = first; c < chunks; ++c) {
    const int c0 = c * W;
    __syncthreads();  // the last chunk's K, V and P are consumed
    const size_t first = (size_t)b * p.Skv + c0;  // the chunk's first key row
    const int valid = min(W, p.Skv - c0);
    stage<HD>(ks, S::QK_STRIDE, p.k, first * k_row + (size_t)kh * HD, k_row, W, valid, p.k_bf16);
    stage<DV>(vs, DV, p.v, first * v_row + (size_t)kh * DV, v_row, W, valid, p.v_bf16);
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
      live[r] = c0 <= lim[r] && c0 + W - 1 >= lo[r];  // the chunk holds a key of the row (the same for its 16 threads)
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = c0 + tx + 16 * j;
        const float sc = key <= lim[r] && key >= lo[r] ? __fmul_rn(s[r][j], p.scale) : -1e30f;
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
        for (int i = 0; i < DPT; ++i) vv[i] = vs[(j + jj) * DV + tx + 16 * i];
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
    const size_t o = (((size_t)b * p.Sq + r0 + row) * p.H + h) * DV;
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

template <int HD, int DV>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using S = Smem<HD, DV>;
  static unsigned configured = 0;  // devices whose shared-memory limit is raised, as a bit set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(prefill_attention_f32_kernel<HD, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::BYTES);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  prefill_attention_f32_kernel<HD, DV><<<grid, THREADS, S::BYTES, st>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

// the tensor-core body for a bf16 q, with bf16 K/V at HD 256; else the f32 body
inline bool tensor_core_body(int q_bf16, int k_bf16, int v_bf16, int hd) {
  return q_bf16 && (hd != 256 || (k_bf16 && v_bf16));
}

template <int HD, int DV = HD>
cudaError_t launch(const Params& p, cudaStream_t st) {
  return tensor_core_body(p.q_bf16, p.k_bf16, p.v_bf16, HD) ? tc::launch<HD, DV>(p, st) : f32::launch<HD, DV>(p, st);
}

}  // namespace

// q (B, Sq, H, hd), k (B, Skv, KVH, hd) and v (B, Skv, KVH, dv), each
// contiguous bf16 (*_bf16 = 1) or f32, q 16-byte aligned; out (B, Sq, H,
// dv) in q's dtype.  A bf16 q (at hd 256 with bf16 K/V) runs the
// tensor-core body, which first splits K/V into ws (B x KVH x ceil(Skv /
// 64) x P x 64 x (hd + dv) bf16, P = 3 part tiles, 1 at hd 256; 16-byte
// aligned) and flags (B x KVH x ceil(Skv / 64) ints); otherwise the f32
// body runs, which reads neither.  (hd, dv) in {(16, 16), (32, 32), (64,
// 64), (128, 128), (192, 128), (256, 256)}, H % KVH == 0, B <= 65535, H <=
// 65535, Sq <= 65535 x 64.  Query i sits at position q_offset + i and key j
// at j; causal keeps keys j <= q_offset + i, else every key is attended;
// window > 0 keeps only keys j > q_offset + i - window, and every row must
// keep one (q_offset + Sq - window <= Skv - 1).
// Returns cudaErrorInvalidValue on arguments it does not take, else
// cudaGetLastError() after the launches.
extern "C" int prefill_attention_launch(const void* q, const void* k, const void* v, void* out, void* ws, int* flags,
                                        int q_bf16, int k_bf16, int v_bf16, int B, int Sq, int Skv, int H, int KVH,
                                        int hd, int dv, int q_offset, int causal, int window, float scale,
                                        void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH || B > 65535 || H > 65535 || q_offset < 0 ||
      Sq > 65535 * BQ || dv != (hd == 192 ? 128 : hd) || window < 0 ||
      (window > 0 && q_offset + Sq - window > Skv - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_core_body(q_bf16, k_bf16, v_bf16, hd) && (!ws || !flags)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, ws, flags, q_bf16, k_bf16, v_bf16, B, Sq, Skv, H, KVH, q_offset, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(launch<16>(p, st));
    case 32: return static_cast<int>(launch<32>(p, st));
    case 64: return static_cast<int>(launch<64>(p, st));
    case 128: return static_cast<int>(launch<128>(p, st));
    case 192: return static_cast<int>(launch<192, 128>(p, st));
    case 256: return static_cast<int>(launch<256>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
