// The decode-attention body shared by the contiguous kernel (K3,
// razer_kv_attention.cu) and the paged kernels (K4 decode and K5
// speculative verify, paged_kv_attention.cu), for Hopper (sm_90a).
//
// One block attends the R = T * G query rows of one (sequence b, kv head)
// -- T = 1 for K3/K4, for K5 the verify queries [t0, t0 + T) with T * G <=
// MAX_ROWS (a call with more queries launches once per such range) -- over
// one split of the sequence, and the last block of the (b, kv head) to
// finish combines the splits' partials.  The kernels differ only in where
// position p's packed row lives: K3 at (b, p) of a contiguous (B, S, KVH,
// .) cache, K4/K5 at slot p % ps of the physical page page_table[b, p / ps]
// of the pool.  Each passes that mapping as a functor; everything else --
// the split cut, the staging, the decode, the scores, the softmax and the
// order of every floating-point operation -- is this one function.  So K4 on a page table
// that maps a sequence onto its pages returns K3's bits on the same bytes,
// and K5's query t returns K4's bits at length cur_len + t + 1.
//
// Wire format: per (position, kv head) hd/2 code bytes, low nibble first,
// and hd/16 meta bytes = SV sign << 7 | E4M3 scale code (bias 7, subnormals
// 2^-6 * m/8); code 8 decodes to +-5 times the scale.
//
// What bounds it on this card: the cache bytes up to each query's length,
// each read once; the work is about 11 flop per cache byte at G = 3
// (21 at G = 6) plus the decode's integer work, against an f32 ridge of
// about 20.  The design:
//  * The split.  A sequence of length L is cut into splits of SPLIT
//    positions (a multiple of the page size 16): [0, 256), [256, 512), ...
//    The cut depends on L alone -- not on B, T, KVH, the grid or the SM
//    count -- and partials are combined in split order, so a sequence's
//    output does not move with the batch around it.  The grid is sized from
//    the table's span (NP * ps) or S, which the host knows without a sync;
//    blocks past a sequence's last split return at once.  Each block writes
//    its partial (max, sum, weighted V sum per row) to a workspace; the
//    last to arrive (an atomic ticket per (b, kv head), reset by it) reads
//    all partials in split order and writes the output: one launch per
//    call.  A single-split sequence goes through the same combine.
//  * Staging.  A split is walked in chunks of CHUNK = 64 positions.  A
//    position's K and V rows (hd/2 code bytes and hd/16 meta bytes each)
//    are contiguous in the pool and in the cache; each chunk's rows arrive
//    by cp.async (16 bytes a copy where the row allows) into one of two
//    shared buffers, the next chunk's copies in flight while this one is
//    computed.  Only positions below the split's end are read.
//  * Decode in registers, straight into tensor-core fragments.  The FP4
//    bits of a code byte become a bf16x2 holding value x 2^-126, and one
//    fma.bf16x2 multiplies by scale x 2^118 and adds, where the code is 8,
//    the special value x scale x 2^-8: the exact bf16 of value x scale x
//    2^-8 (FP4 x E4M3 has at most 7 significant bits), the same decode as
//    the packed GEMM tile's.  Scores and outputs are scaled back by 2^8.
//  * Math on tensor cores, mma.sync m16n8k16 bf16 -> f32, with q and P
//    split into a high and a low bf16 part (each the f32 value's leading
//    and next 8 bits; what is left is below 2^-17 of it): an n-tile's 8
//    columns are the high parts of 4 query rows and their low parts, and
//    the two columns of a row are summed in f32.  Scores are S^T = K q^T:
//    a warp's 16 positions are the 16 rows of A, decoded K; outputs are
//    O^T = V^T P^T: 16 dims of V as A's rows, 16 positions as its k.
//    The dims inside a k-step (QK) and the position order inside an
//    m-tile's rows (PV) are permuted so that a thread's bytes lie together.
//  * Per chunk: each of the 4 warps decodes and scores 16 positions; the
//    softmax of each query row over the chunk runs on one warp, two
//    positions a lane, with shuffle reductions, and keeps the row's running
//    max and sum (base-2 exponentials of scores scaled by log2 e); each
//    warp then rescales and accumulates a quarter of the output dims over
//    all 64 positions.  Three barriers a chunk.
//  * A masked position (at or past its row's length) gets probability
//    exactly 0, and a row's state is unchanged by a chunk, a k-step or a
//    split in which it has no valid position: x 1 and + 0, both exact.  So
//    K5's query t, whose block reads past cur_len + t + 1 for the later
//    queries, returns K4's bits at that length.
//  * f32 everywhere else, with the exponentials, sums and products written
//    as explicit intrinsics so that no instantiation contracts them
//    differently.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace razer_kv {

constexpr int THREADS = 128;  // 4 warps
constexpr int CHUNK = 64;     // positions staged per step: one 16-position block per warp
constexpr int SPLIT = 256;    // positions per split: a multiple of CHUNK and of the page size 16
constexpr int MAX_G = 8;      // query rows per kv head
constexpr int MAX_ROWS = 32;  // T * G rows per block (K5)
constexpr int NSTAGE = 2;     // chunk buffers in the staging ring
constexpr int GROUP = 8;      // splits combined together first (a two-level combine)

// Launch-time facts of one call.
struct Params {
  const float* q;
  const uint8_t* kc;
  const uint8_t* km;
  const uint8_t* vc;
  const uint8_t* vm;
  const int* cur_len;
  float* out;
  float* ws;      // (B * KVH, nsplit_grid) split partials, then (B * KVH, ngroup_grid) group partials,
                  // each partial_floats(R, hd) floats
  int* counters;  // (B * KVH, ngroup_grid) group tickets, then (B * KVH) final tickets; zero between calls
  int T, verify, G, KVH, span, nsplit_grid, ngroup_grid, B;
  int TQ, t0;                 // K5: q and out hold TQ queries a sequence; this launch takes [t0, t0 + T)
  float score_scale;          // 2^8 / sqrt(hd) * log2(e)
  int unit[4];                // copy unit of k codes, k meta, v codes, v meta: 16, 8, 4 or 1 byte
};

__host__ __device__ inline int num_splits(int len) { return len > SPLIT ? (len + SPLIT - 1) / SPLIT : 1; }
__host__ __device__ inline int num_groups(int splits) { return (splits + GROUP - 1) / GROUP; }

template <int HD>
struct Geo {
  static constexpr int KC = HD / 2;                 // code bytes per row
  static constexpr int KM = HD / 16;                // meta bytes per row
  static constexpr int NKS = HD / 16;               // QK k-steps = PV m-tiles
  static constexpr int KCS = (KC + 15) / 16 * 16;   // shared row strides
  static constexpr int VCS = KCS + 16;              // padded: the V^T fragments' loads miss no bank
  static constexpr int KMS = (KM + 15) / 16 * 16;
  static constexpr int QB = HD / 8;                 // K code bytes of a row a lane scores
  static constexpr int QW = (QB + 3) / 4;           // ... in 32-bit words
  static constexpr int MWM = (NKS + 3) / 4;         // PV m-tiles of a warp, at most
  static constexpr int STAGE = CHUNK * (KCS + VCS + 2 * KMS);
};

// Blocks per SM the register budget is set for: the main path's R <= 8
// rows keep 6 resident (80 registers a thread), larger K5 row counts fewer.
// The body waits on latency more than it issues, so resident blocks are
// what overlaps one block's copies with another's math.
template <int NTM>
struct MinBlocks {
  static constexpr int value = NTM <= 2 ? 6 : NTM <= 4 ? 4 : 2;
};

// Dynamic shared memory of one block (bytes) for R query rows.
template <int HD>
__host__ __device__ inline size_t smem_bytes(int rows) {
  using Gm = Geo<HD>;
  const int nt = (rows + 3) / 4;
  return NSTAGE * (size_t)Gm::STAGE + (size_t)CHUNK * Gm::KM * 8 + (size_t)nt * Gm::NKS * 32 * 8 +
         (size_t)nt * (CHUNK / 16) * 32 * 8 + (size_t)4 * nt * CHUNK * 4 + (size_t)4 * nt * 4 + 16;
}

// Floats of one split's partial (acc, then max and sum per row), padded to
// a multiple of 4 so that every partial's acc is 16-byte aligned.
__host__ __device__ inline size_t partial_floats(int rows, int hd) {
  return (size_t)rows * hd + ((2 * rows + 3) & ~3);
}

inline float score_scale(int hd) { return (float)(256.0 / sqrt((double)hd) * 1.4426950408889634); }

// ---------------------------------------------------------------------------
// small device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy_async(void* dst, const void* src, int unit) {
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
  else if (unit == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
  else
    *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most n committed groups are pending
__device__ __forceinline__ void cp_async_wait_group(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
__device__ __forceinline__ uint32_t lop3_and_andnot(uint32_t a, uint32_t b, uint32_t c) {  // a & ~b & c
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x20;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t bf16_bits_rn(float v) {  // round to nearest even; finite inputs
  const uint32_t u = __float_as_uint(v);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}
__device__ __forceinline__ float bf16_value(uint32_t bits) { return __uint_as_float(bits << 16); }

// D (16 x 8 f32) += A (16 x 16 bf16, row) . B (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Meta byte -> (scale x 2^118, special value x scale x 2^-8), each a bf16
// pair.  (m & 0x7F) << 20 is the f32 of the E4M3 scale times 2^-120, for
// normal and subnormal codes alike; every step is exact.
__device__ __forceinline__ uint2 meta_entry(uint32_t m) {
  const float f = __uint_as_float((m & 0x7Fu) << 20);
  const float s = __fmul_rn(__fmul_rn(f, 0x1p119f), 0x1p119f);
  const uint32_t x = __float_as_uint(s) >> 16;
  const uint32_t y = (__float_as_uint(__fmul_rn(f, 0x1.4p114f)) >> 16) | ((m & 0x80u) << 8);
  return make_uint2(x * 0x10001u, y * 0x10001u);
}

// bf16x2 of the two nibbles in u = [n0, 0, n1, 0]: value x scale x 2^-8,
// the special value where the code is 8 (is8 = 0xFFFF in that half).
__device__ __forceinline__ uint32_t decode_pair(uint32_t u, uint32_t is8, uint32_t scale, uint32_t sv) {
  const uint32_t v = (u * 0x1040u) & 0x81C081C0u;  // sign -> bit 15, e1 e0 m -> bits 8..6
  return fma_bf16x2(v, scale, is8 & sv);
}

// nibble == 8 (sign set, magnitude clear) -> flag at the nibble's bit 3
__device__ __forceinline__ uint32_t code8_flags(uint32_t w) {
  return lop3_and_andnot(w, (w & 0x77777777u) + 0x77777777u, 0x88888888u);
}

// QK's A fragment of one k-step from w = [row r: byte c, c + 1; row r + 8:
// byte c, c + 1]: a[0] (r, k 2t..) = byte c of r, a[1] = byte c of r + 8,
// a[2] (r, k 2t + 8..) = byte c + 1 of r, a[3] = byte c + 1 of r + 8.
__device__ __forceinline__ void decode_k(uint32_t (&a)[4], uint32_t w, uint2 er, uint2 er8) {
  const uint32_t wa = w & 0x0F0F0F0Fu, wb = (w >> 4) & 0x0F0F0F0Fu;
  const uint32_t z = code8_flags(w), z4 = z << 4;
  // prmt: selector nibble j copies byte j of {a, b}; 8 | j replicates its bit 7
  a[0] = decode_pair(prmt(wa, wb, 0xC480u), prmt(z4, z, 0xCC88u), er.x, er.y);
  a[1] = decode_pair(prmt(wa, wb, 0xE6A2u), prmt(z4, z, 0xEEAAu), er8.x, er8.y);
  a[2] = decode_pair(prmt(wa, wb, 0xD591u), prmt(z4, z, 0xDD99u), er.x, er.y);
  a[3] = decode_pair(prmt(wa, wb, 0xF7B3u), prmt(z4, z, 0xFFBBu), er8.x, er8.y);
}

// PV's A fragment (V^T) of one m-tile from w = [x0, x1, x2, x3], the code
// byte at positions 2t, 2t + 1, 2t + 8, 2t + 9: a[0] (dim row r = low
// nibble) = (x0, x1) low nibbles, a[1] (row r + 8 = high nibble) = their
// high nibbles, a[2], a[3] the same of (x2, x3).  e01 / e23: the two
// positions' scale and special-value pairs.
__device__ __forceinline__ void decode_v(uint32_t (&a)[4], uint32_t w, uint2 e01, uint2 e23) {
  const uint32_t wa = w & 0x0F0F0F0Fu, wb = (w >> 4) & 0x0F0F0F0Fu;
  const uint32_t z = code8_flags(w), z4 = z << 4;
  a[0] = decode_pair(prmt(wa, wb, 0x9180u), prmt(z4, z, 0x9988u), e01.x, e01.y);
  a[1] = decode_pair(prmt(wa, wb, 0xD5C4u), prmt(z4, z, 0xDDCCu), e01.x, e01.y);
  a[2] = decode_pair(prmt(wa, wb, 0xB3A2u), prmt(z4, z, 0xBBAAu), e23.x, e23.y);
  a[3] = decode_pair(prmt(wa, wb, 0xF7E6u), prmt(z4, z, 0xFFEEu), e23.x, e23.y);
}

__device__ __forceinline__ uint2 pair_entries(uint2 e0, uint2 e1) {  // halves from two positions
  return make_uint2(prmt(e0.x, e1.x, 0x5410u), prmt(e0.y, e1.y, 0x5410u));
}

// N (even) bytes at an N-aligned shared address into 32-bit words
template <int N>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[(N + 3) / 4], const uint8_t* p) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 16 * i);
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    }
  } else if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * i);
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(p + 4 * i);
  } else {
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i) {
      const uint32_t lo = *reinterpret_cast<const uint16_t*>(p + 4 * i);
      const uint32_t hi = 4 * i + 2 < N ? *reinterpret_cast<const uint16_t*>(p + 4 * i + 2) : 0u;
      w[i] = lo | (hi << 16);
    }
  }
}

// Rows [c0, min(c0 + CHUNK, end)) of one cache array into a shared buffer.
template <int ROWB, class RowOf>
__device__ __forceinline__ void stage_array(uint8_t* dst, int dstride, const uint8_t* src, int unit, int c0,
                                            int end, const RowOf& row_of) {
  const int pieces = ROWB / unit;
  for (int i = threadIdx.x; i < CHUNK * pieces; i += THREADS) {
    const int p = i / pieces, k = i - p * pieces;
    if (c0 + p < end)
      copy_async(dst + p * dstride + k * unit, src + row_of(c0 + p) * ROWB + k * unit, unit);
  }
}

// After this block's writes: true in every thread of the block that is the
// n-th of n to arrive at `ticket`, which it resets for the next call.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  const bool last = *flag;
  if (last) {
    __threadfence();
    if (threadIdx.x == 0) *ticket = 0;
  }
  return last;
}

// Combine n partials (PS floats apart, from `in`: acc (R, HD), then max,
// sum per row), in order, with weights 2^(max_i - max): into the output
// (out_part == nullptr: acc x 2^8 / sum) or into one partial of the same
// layout.  A partial whose max is -inf (no valid position) adds exactly 0.
// `red`: 2 MAX_ROWS floats of shared memory.
template <int HD>
__device__ __forceinline__ void combine(const Params& p, const float* in, size_t PS, int n, int R, int b, int kh,
                                        float* out_part, float* red) {
  const int tid = threadIdx.x;
  if (tid < R) {
    float mx = -INFINITY;
#pragma unroll 8
    for (int i = 0; i < n; ++i) mx = fmaxf(mx, __ldcg(in + i * PS + (size_t)R * HD + tid));
    const float m_use = mx == -INFINITY ? 0.0f : mx;
    float den = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float* pm = in + i * PS + (size_t)R * HD;
      den = fmaf(exp2f(__fsub_rn(__ldcg(pm + tid), m_use)), __ldcg(pm + R + tid), den);
    }
    red[tid] = m_use;
    red[MAX_ROWS + tid] = den;
    if (out_part) out_part[(size_t)R * HD + tid] = mx, out_part[(size_t)R * HD + R + tid] = den;
  }
  __syncthreads();
  for (int i = tid; i < R * (HD / 4); i += THREADS) {
    const int row = i / (HD / 4), d = 4 * (i - row * (HD / 4));
    const float m_use = red[row], den = red[MAX_ROWS + row];
    float4 num = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float* pk = in + k * PS;
      const float wgt = exp2f(__fsub_rn(__ldcg(pk + (size_t)R * HD + row), m_use));
      const float4 a = __ldcg(reinterpret_cast<const float4*>(pk + (size_t)row * HD + d));
      num.x = fmaf(wgt, a.x, num.x), num.y = fmaf(wgt, a.y, num.y);
      num.z = fmaf(wgt, a.z, num.z), num.w = fmaf(wgt, a.w, num.w);
    }
    if (out_part) {
      *reinterpret_cast<float4*>(out_part + (size_t)row * HD + d) = num;
      continue;
    }
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (den > 0.0f)
      o = make_float4(__fdiv_rn(__fmul_rn(num.x, 256.0f), den), __fdiv_rn(__fmul_rn(num.y, 256.0f), den),
                      __fdiv_rn(__fmul_rn(num.z, 256.0f), den), __fdiv_rn(__fmul_rn(num.w, 256.0f), den));
    *reinterpret_cast<float4*>(p.out + ((((size_t)b * p.TQ + p.t0 + row / p.G) * p.KVH + kh) * p.G + row % p.G) * HD + d) = o;
  }
}

// ---------------------------------------------------------------------------
// the body: one block = one split of one (b, kv head), R = T * G rows
// ---------------------------------------------------------------------------
template <int HD, int NTM, class RowOf>
__device__ __forceinline__ void attend(const Params& p, const RowOf& row_of, int b, int kh, int split) {
  using Gm = Geo<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment group and thread in group
  const int T = p.T, G = p.G, R = T * G, NT = (R + 3) / 4;
  const int cl = p.cur_len[b];
  const int len_max = min(max(cl + (p.verify ? p.t0 + T : 0), 0), p.span);
  const int nsplit = num_splits(len_max);
  if (split >= nsplit) return;
  const int s0 = split * SPLIT, s1 = min(s0 + SPLIT, len_max);

  uint8_t* stage = smem;
  uint2* vent = reinterpret_cast<uint2*>(smem + NSTAGE * Gm::STAGE);  // (KM, CHUNK) V meta entries
  uint2* qfrag = vent + CHUNK * Gm::KM;                           // (NT, NKS, 32) B fragments of q
  uint2* pfrag = qfrag + NT * Gm::NKS * 32;                       // (NT, CHUNK / 16, 32) of P
  float* ssm = reinterpret_cast<float*>(pfrag + NT * (CHUNK / 16) * 32);  // (4 NT, CHUNK) scores
  float* alpha_sm = ssm + 4 * NT * CHUNK;                                 // (4 NT)
  int* flag = reinterpret_cast<int*>(alpha_sm + 4 * NT);

  // the softmax state of rows warp + 4 i (every lane holds it)
  float m_run[NTM], l_run[NTM];
#pragma unroll
  for (int i = 0; i < NTM; ++i) m_run[i] = -INFINITY, l_run[i] = 0.0f;
  // the output accumulators of this warp's m-tiles [ja, ja + mw)
  const int ja = warp * Gm::NKS / 4, mw = (warp + 1) * Gm::NKS / 4 - ja;
  float acc[NTM][Gm::MWM][4];
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt)
#pragma unroll
    for (int j = 0; j < Gm::MWM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.0f;

  // the staging ring: chunks 0 .. NSTAGE - 1 in flight at once, one
  // cp.async group each (every thread commits one group per chunk slot,
  // empty past the split's end); chunk c + NSTAGE refills chunk c's buffer
  const int nchunks = (s1 - s0 + CHUNK - 1) / CHUNK;  // 0 for an empty sequence
  auto stage_chunk = [&](int c) {
    uint8_t* buf = stage + (c % NSTAGE) * Gm::STAGE;
    const int c0 = s0 + c * CHUNK;
    if (c < nchunks) {
      stage_array<Gm::KC>(buf, Gm::KCS, p.kc, p.unit[0], c0, s1, row_of);
      stage_array<Gm::KC>(buf + CHUNK * Gm::KCS, Gm::VCS, p.vc, p.unit[2], c0, s1, row_of);
      stage_array<Gm::KM>(buf + CHUNK * (Gm::KCS + Gm::VCS), Gm::KMS, p.km, p.unit[1], c0, s1, row_of);
      stage_array<Gm::KM>(buf + CHUNK * (Gm::KCS + Gm::VCS + Gm::KMS), Gm::KMS, p.vm, p.unit[3], c0, s1, row_of);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < NSTAGE; ++c) stage_chunk(c);

  // q's B fragments: lane (g', t) of n-tile nt, k-step s holds dims
  // t * HD/4 + 4s .. + 3 of row 4 nt + (g' & 3), its high part for g' < 4,
  // its low part for g' >= 4; rows >= R are zero
  for (int i = tid; i < NT * Gm::NKS * 32; i += THREADS) {
    const int ln = i & 31, s = (i >> 5) % Gm::NKS, nt = (i >> 5) / Gm::NKS;
    const int g2 = ln >> 2, t = ln & 3, row = 4 * nt + (g2 & 3);
    uint32_t h[4] = {0u, 0u, 0u, 0u};
    if (row < R) {
      const float* src = p.q + ((((size_t)b * p.TQ + p.t0 + row / G) * p.KVH + kh) * G + row % G) * HD + t * (HD / 4) + 4 * s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = src[e];
        const uint32_t hi = bf16_bits_rn(v);
        h[e] = g2 < 4 ? hi : bf16_bits_rn(__fsub_rn(v, bf16_value(hi)));
      }
    }
    qfrag[i] = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  }
  for (int i = tid; i < NT * (CHUNK / 16) * 32; i += THREADS) pfrag[i] = make_uint2(0u, 0u);

  for (int c = 0; c < nchunks; ++c) {
    // groups committed: NSTAGE, plus one refill per earlier iteration after
    // the first when the ring is shorter than the split; wait for chunk c's
    constexpr bool refills = NSTAGE < SPLIT / CHUNK;
    cp_async_wait_group(refills ? (c == 0 ? NSTAGE - 1 : NSTAGE - 2) : NSTAGE - 1 - c);
    __syncthreads();  // chunk c is in shared memory, and every warp is done with chunk c - 1
    if (refills && c > 0) stage_chunk(c - 1 + NSTAGE);  // into chunk c - 1's buffer
    const uint8_t* buf = stage + (c % NSTAGE) * Gm::STAGE;
    const uint8_t* st_kc = buf;
    const uint8_t* st_vc = buf + CHUNK * Gm::KCS;
    const uint8_t* st_km = buf + CHUNK * (Gm::KCS + Gm::VCS);
    const uint8_t* st_vm = st_km + CHUNK * Gm::KMS;
    const int c0 = s0 + c * CHUNK;

    // ---- scores of this warp's 16 positions, and their V meta entries ----
    for (int i = lane; i < 16 * Gm::KM; i += 32) {  // every entry: stale rows must decode to finite values
      const int pp = 16 * warp + i / Gm::KM, blk = i % Gm::KM;
      vent[blk * CHUNK + pp] = meta_entry(st_vm[pp * Gm::KMS + blk]);
    }
    if (c0 + 16 * warp < s1) {
      const int pr = 16 * warp + gq;  // rows pr and pr + 8 of the chunk
      uint32_t kr[Gm::QW], kr8[Gm::QW];
      load_bytes<Gm::QB>(kr, st_kc + pr * Gm::KCS + tq * Gm::QB);
      load_bytes<Gm::QB>(kr8, st_kc + (pr + 8) * Gm::KCS + tq * Gm::QB);
      float sc[NTM][4];
#pragma unroll
      for (int nt = 0; nt < NTM; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
      uint2 er = make_uint2(0u, 0u), er8 = er;
      int cur_blk = -1;
#pragma unroll
      for (int s = 0; s < Gm::NKS; ++s) {
        const int blk = (tq * Gm::QB + 2 * s) >> 3;
        if (blk != cur_blk) {
          cur_blk = blk;
          er = meta_entry(st_km[pr * Gm::KMS + blk]);
          er8 = meta_entry(st_km[(pr + 8) * Gm::KMS + blk]);
        }
        const uint32_t w = prmt(kr[s >> 1], kr8[s >> 1], (s & 1) ? 0x7632u : 0x5410u);
        uint32_t a[4];
        decode_k(a, w, er, er8);
#pragma unroll
        for (int nt = 0; nt < NTM; ++nt)
          if (nt < NT) mma_bf16(sc[nt], a, qfrag[(nt * Gm::NKS + s) * 32 + lane]);
      }
      // columns 2t, 2t + 1: high parts of rows 2t, 2t + 1 (t < 2) or low
      // parts of rows 2t - 4, 2t - 3; a row's score is high + low
#pragma unroll
      for (int nt = 0; nt < NTM; ++nt) {
        if (nt < NT) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = __fmul_rn(__fadd_rn(sc[nt][e], __shfl_xor_sync(0xFFFFFFFFu, sc[nt][e], 2)), p.score_scale);
          if (tq < 2) {
            float* r0 = ssm + (4 * nt + 2 * tq) * CHUNK + pr;
            r0[0] = v[0], r0[CHUNK] = v[1], r0[8] = v[2], r0[CHUNK + 8] = v[3];
          }
        }
      }
    }
    __syncthreads();

    // ---- softmax: row warp + 4 i over the chunk, two positions a lane ----
#pragma unroll
    for (int i = 0; i < NTM; ++i) {
      const int row = warp + 4 * i;
      if (row < R) {
        const int len = min(max(cl + (p.verify ? p.t0 + row / G + 1 : 0), 0), p.span);
        const bool ok0 = c0 + lane < len, ok1 = c0 + lane + 32 < len;
        const float v0 = ok0 ? ssm[row * CHUNK + lane] : -INFINITY;
        const float v1 = ok1 ? ssm[row * CHUNK + lane + 32] : -INFINITY;
        float cm = fmaxf(v0, v1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) cm = fmaxf(cm, __shfl_xor_sync(0xFFFFFFFFu, cm, o));
        const float m_new = fmaxf(m_run[i], cm);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float a = exp2f(__fsub_rn(m_run[i], m_use));
        const float p0 = ok0 ? exp2f(__fsub_rn(v0, m_use)) : 0.0f;
        const float p1 = ok1 ? exp2f(__fsub_rn(v1, m_use)) : 0.0f;
        float sum = __fadd_rn(p0, p1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, o));
        l_run[i] = fmaf(l_run[i], a, sum);
        m_run[i] = m_new;
        if (lane == 0) alpha_sm[row] = a;
        // P^T's B fragments: position k of k-step kk is row 2t + (k & 1)
        // (+ 8 for k & 8) of lane (g', t), t = (k & 7) / 2
        uint16_t* pf = reinterpret_cast<uint16_t*>(pfrag + (row >> 2) * (CHUNK / 16) * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = lane + 32 * h;
          const float pv = h ? p1 : p0;
          const uint32_t hi = bf16_bits_rn(pv), lo = bf16_bits_rn(__fsub_rn(pv, bf16_value(hi)));
          const int kk = k >> 4, kl = k & 15;
          const int slot = (kl >> 3) * 2 + (kl & 1), t = (kl & 7) >> 1;
          pf[((kk * 32) + (row & 3) * 4 + t) * 4 + slot] = static_cast<uint16_t>(hi);
          pf[((kk * 32) + (4 + (row & 3)) * 4 + t) * 4 + slot] = static_cast<uint16_t>(lo);
        }
      }
    }
    __syncthreads();

    // ---- P V: this warp's m-tiles over the chunk's positions ----
#pragma unroll
    for (int nt = 0; nt < NTM; ++nt) {
      if (nt < NT) {
        const int r0 = 4 * nt + ((2 * tq) & 3);
        const float a0 = r0 < R ? alpha_sm[r0] : 0.0f, a1 = r0 + 1 < R ? alpha_sm[r0 + 1] : 0.0f;
#pragma unroll
        for (int j = 0; j < Gm::MWM; ++j) {
          acc[nt][j][0] = __fmul_rn(acc[nt][j][0], a0);
          acc[nt][j][1] = __fmul_rn(acc[nt][j][1], a1);
          acc[nt][j][2] = __fmul_rn(acc[nt][j][2], a0);
          acc[nt][j][3] = __fmul_rn(acc[nt][j][3], a1);
        }
      }
    }
    if (mw > 0) {
      const int vb = 8 * ja + gq * mw;  // this lane's first code byte: byte vb + j is m-tile ja + j's
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        if (c0 + 16 * kk >= s1) break;
        const int lp = 16 * kk + 2 * tq;  // positions lp, lp + 1, lp + 8, lp + 9
        uint32_t x[4];
        if (mw == 2 && Gm::MWM == 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = *reinterpret_cast<const uint16_t*>(st_vc + (lp + (i & 1) + 8 * (i >> 1)) * Gm::VCS + vb);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint8_t* src = st_vc + (lp + (i & 1) + 8 * (i >> 1)) * Gm::VCS + vb;
            x[i] = 0u;
#pragma unroll
            for (int j = 0; j < Gm::MWM; ++j)
              if (j < mw) x[i] |= static_cast<uint32_t>(src[j]) << (8 * j);
          }
        }
        const uint32_t x01 = prmt(x[0], x[1], 0x5410u), x23 = prmt(x[2], x[3], 0x5410u);
        int cur_blk = -1;
        uint2 e01 = make_uint2(0u, 0u), e23 = e01;
#pragma unroll
        for (int j = 0; j < Gm::MWM; ++j) {
          if (j < mw) {
            const int blk = (vb + j) >> 3;
            if (blk != cur_blk) {
              cur_blk = blk;
              const uint2* ve = vent + blk * CHUNK + lp;
              e01 = pair_entries(ve[0], ve[1]);
              e23 = pair_entries(ve[8], ve[9]);
            }
            // byte j of each position: x01 = [x0.b0, x0.b1, x1.b0, x1.b1] (for mw <= 2)
            uint32_t w;
            if (Gm::MWM <= 2)
              w = prmt(x01, x23, j ? 0x7531u : 0x6420u);
            else
              w = prmt(prmt(x[0], x[1], 0x40u + 0x11u * j), prmt(x[2], x[3], 0x40u + 0x11u * j), 0x5410u);
            uint32_t a[4];
            decode_v(a, w, e01, e23);
#pragma unroll
            for (int nt = 0; nt < NTM; ++nt)
              if (nt < NT) mma_bf16(acc[nt][j], a, pfrag[(nt * (CHUNK / 16) + kk) * 32 + lane]);
          }
        }
      }
    }
  }

  // ---- this split's partial: acc (R, HD), then each row's max and sum;
  // partials lie PS floats apart, a multiple of 4 ----
  const size_t bk = (size_t)b * p.KVH + kh;
  const size_t PS = partial_floats(R, HD);
  float* part = p.ws + (bk * p.nsplit_grid + split) * PS;
  float* part_m = part + (size_t)R * HD;
  float* part_l = part_m + R;
#pragma unroll
  for (int nt = 0; nt < NTM; ++nt) {
    if (nt < NT) {
#pragma unroll
      for (int j = 0; j < Gm::MWM; ++j) {
        if (j < mw) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(acc[nt][j][e], __shfl_xor_sync(0xFFFFFFFFu, acc[nt][j][e], 2));
          const int byte = 8 * ja + gq * mw + j, r0 = 4 * nt + 2 * tq;
          if (tq < 2) {  // m-tile rows gq, gq + 8 = dims 2 byte, 2 byte + 1
            if (r0 < R) part[(size_t)r0 * HD + 2 * byte] = v[0], part[(size_t)r0 * HD + 2 * byte + 1] = v[2];
            if (r0 + 1 < R)
              part[(size_t)(r0 + 1) * HD + 2 * byte] = v[1], part[(size_t)(r0 + 1) * HD + 2 * byte + 1] = v[3];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NTM; ++i) {
    const int row = warp + 4 * i;
    if (row < R && lane == 0) part_m[row] = m_run[i], part_l[row] = l_run[i];
  }
  if (nsplit == 1) {  // the only split: combine it alone
    __syncthreads();
    combine<HD>(p, part, PS, 1, R, b, kh, nullptr, reinterpret_cast<float*>(smem));
    return;
  }
  // the last split of a group of GROUP to finish combines the group; if
  // the sequence has more groups, the last group to finish combines those
  const int g = split / GROUP, ngroups = num_groups(nsplit);
  const size_t gslot = bk * p.ngroup_grid + g;
  if (!last_to_arrive(p.counters + gslot, min(GROUP, nsplit - g * GROUP), flag)) return;
  const float* first = p.ws + (bk * p.nsplit_grid + (size_t)g * GROUP) * PS;
  float* red = reinterpret_cast<float*>(smem);  // the staging buffers are idle now
  if (ngroups == 1) {
    combine<HD>(p, first, PS, nsplit, R, b, kh, nullptr, red);
    return;
  }
  float* gpart = p.ws + ((size_t)p.B * p.KVH * p.nsplit_grid + gslot) * PS;
  combine<HD>(p, first, PS, min(GROUP, nsplit - g * GROUP), R, b, kh, gpart, red);
  int* final_ticket = p.counters + (size_t)p.B * p.KVH * p.ngroup_grid + bk;
  if (!last_to_arrive(final_ticket, ngroups, flag)) return;
  combine<HD>(p, p.ws + ((size_t)p.B * p.KVH * p.nsplit_grid + bk * p.ngroup_grid) * PS, PS, ngroups, R, b, kh,
              nullptr, red);
}

// Copy unit of a cache array whose rows are `rowb` bytes from `ptr`: the
// largest of 16, 8, 4 that divides both, else 1 (byte copies).
inline int copy_unit(const void* ptr, int rowb) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  for (int u = 16; u >= 4; u >>= 1)
    if (rowb % u == 0 && a % u == 0) return u;
  return 1;
}

// The head widths the kernels are built for: each is an instantiation of
// the body (its fragment layout and registers are fixed by the width),
// compiled for each row bound at every first build, so only the widths in
// use are built: the port's configs (128, and 16 reduced) and 64, the
// tests' second width.
constexpr bool built_hd(int hd) { return hd == 16 || hd == 64 || hd == 128; }

// Launch kernel<HD, NTM> for a built hd: F is a functor whose go<HD, NTM>()
// launches it.
template <int NTM, class F>
inline int dispatch_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f.template go<16, NTM>();
    case 64: return f.template go<64, NTM>();
    case 128: return f.template go<128, NTM>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace razer_kv
