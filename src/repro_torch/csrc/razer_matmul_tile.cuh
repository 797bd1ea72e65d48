// The RaZeR packed-weight GEMM's tile, kernel and launch for Hopper
// (sm_90a), shared by the dense GEMM (razer_matmul.cu, K1, one expert), the
// grouped GEMM over stacked expert banks (razer_grouped_matmul.cu, K6) and
// their K-shard forms (K7, K8), so that all run the same instructions: an
// expert of the grouped GEMM returns the dense GEMM's bits on that entry.
//
//   out[e, M, N] (f32) = x[e, M, K] @ dequant(codes[e, K/2, N], scale_meta[e, K/16, N])
//
// The store takes an out_chunks argument (the K-shard epilogue): element
// (e, m, n) of an (E, M, N) output goes to [n / (N/c)][e][m][n % (N/c)] for
// c = out_chunks, so that the N/c columns each rank of a tensor-parallel
// group owns lie contiguous, as reduce_scatter_tensor wants them (it
// scatters along dim 0).  At c = 1 that is the plain (E, M, N) layout; the
// tile loop, the split count and the split sum do not depend on c, so a
// chunked output holds the unchunked output's bits, permuted.  The tensor
// scale is not applied here: the Python wrappers multiply it in.
//
// Design: a mixed-input tensor-core GEMM, swap-AB.
//  * outT = WT . xT: the decoded weight tile is wgmma's A operand (64
//    columns of N x 16 of K per instruction), x's tile its B operand, so the
//    token count is the instruction's n (8 ... 128 in steps the launch picks:
//    NT).  A decode step pads M to 8, not to 64.
//  * A block is two warpgroups and owns BN = 128 columns of N (64 each) and
//    NT tokens, over its K split in BK = 64 steps.  Each step's packed code
//    tile (32 x 128 bytes), scale/meta tile (4 x 128) and x tile (NT x 64
//    bf16) arrive by 16-byte cp.async in a ring of STAGES (4-6) slots: the
//    step in the tensor cores, the step being decoded and the rest in
//    flight.  The ring holds the 4.5-bit wire bytes.
//  * Decode goes into registers in wgmma's A-fragment layout, one code byte
//    (two K neighbours of one column) per bf16x2 register: the FP4 bits are
//    placed as a bf16 that is the value times 2^-126 (e = 0 lands on the
//    subnormal 0.5), then one fma.bf16x2 multiplies by the block's E3M3
//    scale x 2^118 and adds, where the code is 8 (the redundant -0), the
//    block's special value x scale x 2^-8; scale and special value come
//    from a 256-entry table indexed by the meta byte, read once per
//    16-element block.  So A holds w x 2^-8 for the w = bf16(value x scale)
//    of the plain version (exact in bf16 for the repo's SV sets), and the
//    epilogue multiplies by 2^8: only the order of the f32 sum differs.
//  * The registers go to wgmma as its A operand; x's tile is B, read from
//    the slot by a descriptor.  Two sets of A registers alternate, so the
//    next step's decode runs while the tensor cores read the last one.
//  * What bounds it at decode is the issue rate of the decode's integer work
//    (about 40 instructions per 8 weights), beside the wire bytes.  Measured
//    and set aside (PERF.md): A through a decoded shared tile (SS
//    wgmma), mma.sync, four-warpgroup blocks, an mbarrier ring in place of
//    the per-step barrier; none was faster at the main path's shapes.
//  * Rows of A are the block's columns in pairs: A row g of a warp's 16 is
//    column 2g, row g + 8 is column 2g + 1, so one 16-bit shared load gives
//    a thread both of its columns' bytes.
//  * x is rounded to bf16 (RN) as it is loaded; tokens past M and columns
//    past N are zero-filled in shared memory.
//  * Fused activation fake-quant (K1 and K7 under W4A4 at decode-sized M,
//    the launch's act table set): x does not travel in the ring.  The block
//    reads its x rows, a chunk of steps at a time, from global memory (bf16,
//    or f32 before any bf16 rounding), fake-quantizes each 16-value block
//    with one quad of threads (razer_act_qdq.cuh, the standalone K2's
//    arithmetic, so the bits are K2's followed by the GEMM), and writes the
//    bf16 tiles into a region of their own, which the wgmmas then read.
//    The region holds the whole K split when it fits in QX_MAX bytes, so the
//    block quantizes once, before its first wgmma, while the prologue's wire
//    bytes are in flight: the latency of a long dependent chain per block
//    (the scale search, divisions, three SSE chains) is paid once, not once
//    per step.  That is every fused launch of the main path: launch_plan
//    fuses at M <= 16 only (NT 8 or 16: 64 or 32 steps fit), and no packed
//    (K, N) of the repo's configurations splits K into more than 28 steps
//    (llama3_2_3b 16).  A longer split (a fused launch forced at a large
//    NT, which only the checks and the timing tool make) quantizes chunk
//    after chunk, each after every wgmma has retired and behind opaque
//    register barriers, so that no chunk
//    instruction (nor its registers) moves above that retirement while a
//    wgmma still reads its A registers.  BK is a multiple of 16, so a block
//    never straddles a step or a K split.  Every column block quantizes its
//    rows again, N / 128 times the work of one K2 pass: cheap at
//    decode-sized M, not at prefill's (launch_plan chooses from M).
//  * K is split over up to MAX_SPLITS blocks from (N, K) alone (the Python
//    plan); a split's blocks form one thread-block cluster, each leaves its
//    partial tile in its shared memory, and after a cluster barrier block r
//    sums its share of the tile over ranks 0, 1, ... in that order through
//    distributed shared memory: one launch, no atomics, no workspace.  A
//    row's bits depend neither on M nor on which block finishes first.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "razer_act_qdq.cuh"

namespace razer_tile {

namespace cg = cooperative_groups;

constexpr int BN = 128;                            // columns of N per block: two warpgroups of 64
constexpr int BK = 64;                             // K per pipeline step
constexpr int THREADS = 256;
constexpr int MAX_SPLITS = 8;                      // K splits = blocks of one cluster (portable size)
constexpr int CODE_ROW = BN + 16;                  // padded: a warp's 4 code rows hit distinct banks
constexpr int CODE_BYTES = BK / 2 * CODE_ROW;      // 4608
constexpr int X_OFFSET = CODE_BYTES + BK / 16 * BN;  // after the scale/meta tile: x, 8-token x 16-byte core matrices
constexpr int TABLE_BYTES = 256 * 8;               // meta byte -> {scale, special value} bf16x2 pairs
constexpr int ACT_BYTES = 1280;                    // the activation fake-quant's table (razer_act::TABLE floats)
static_assert(razer_act::TABLE * 4 <= ACT_BYTES, "the act table fits its region");

constexpr int QX_MAX = 65536;                      // the fused path's quantized x tiles, at most

// shared memory for NT tokens: the table, then the ring of STAGES slots,
// which the split sum's partial tile reuses with the table; a fused launch
// adds the act table and qx_steps quantized x tiles (at most QX_MAX bytes)
// after the ring
template <int NT>
struct Tile {
  static constexpr int STAGE_BYTES = X_OFFSET + NT * BK * 2;
  static constexpr int STAGES = NT <= 32 ? 6 : (NT <= 64 ? 5 : 4);
  static constexpr int SMEM = TABLE_BYTES + STAGES * STAGE_BYTES;
  static constexpr int X_TILE = NT * BK * 2;  // one step's quantized x tile
  static constexpr int MAX_QSTEPS = QX_MAX / X_TILE > 0 ? QX_MAX / X_TILE : 1;
  static_assert(BN * NT * 4 <= SMEM, "the partial tile reuses the table and the ring");
};

__constant__ float kE3M3[64] = {
    0.0f,  0.03125f, 0.0625f, 0.09375f, 0.125f, 0.15625f, 0.1875f, 0.21875f,
    0.25f, 0.28125f, 0.3125f, 0.34375f, 0.375f, 0.40625f, 0.4375f, 0.46875f,
    0.5f,  0.5625f,  0.625f,  0.6875f,  0.75f,  0.8125f,  0.875f,  0.9375f,
    1.0f,  1.125f,   1.25f,   1.375f,   1.5f,   1.625f,   1.75f,   1.875f,
    2.0f,  2.25f,    2.5f,    2.75f,    3.0f,   3.25f,    3.5f,    3.75f,
    4.0f,  4.5f,     5.0f,    5.5f,     6.0f,   6.5f,     7.0f,    7.5f,
    8.0f,  9.0f,     10.0f,   11.0f,    12.0f,  13.0f,    14.0f,   15.0f,
    16.0f, 18.0f,    20.0f,   22.0f,    24.0f,  26.0f,    28.0f,   30.0f};

struct Params {
  const void* x;              // (E, M, K) bf16 or f32
  const uint8_t* codes;       // (E, K/2, N)
  const uint8_t* scale_meta;  // (E, K/16, N)
  float* out;                 // (out_chunks, E, M, N/out_chunks)
  int E, M, K, N, splits, k_tiles_per_split, out_chunks;
  float m0, m1;
  int x_is_bf16, vec_x, vec_w;  // vec_*: 16-byte cp.async is legal for x / codes and scale_meta
  const float* act_table;       // set: fake-quantize x first (razer_act_qdq.cuh's table); null: not
  int act_nsv;                  // its special values
  int qx_steps;                 // steps of quantized x the fused path holds at once
};

// v, as the compiler sees it, computed here: code that depends on it cannot
// be scheduled above this point
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v)::"memory");
  return v;
}

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; valid == false zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// orders this thread's generic-proxy shared writes before wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register reads or writes across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_operands(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
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
__device__ __forceinline__ uint32_t mad_lo(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// wgmma descriptor of a K-major bf16 operand without swizzle: 8-row x
// 16-byte core matrices, LBO between the two K halves of a 16-deep step,
// SBO between groups of 8 rows (tokens of x, or columns of W in A)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  constexpr uint64_t LBO = 128, SBO = 1024;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | ((SBO >> 4) << 32);
}

// D (64 x NT, f32) += A (64 x 16 bf16, registers) . B (16 x NT bf16, shared);
// TB = 1 reads B MN-major (the bf16 transpose bit: rows of B along k, NT
// contiguous), else K-major
template <int NT>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

template <>
struct Wgmma<16> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

template <>
struct Wgmma<24> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, %18;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

template <>
struct Wgmma<48> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

template <>
struct Wgmma<96> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB = 0>
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1), "n"(TB));
  }
};

// ---------------------------------------------------------------------------
// loads
// ---------------------------------------------------------------------------
// 16 wire bytes at column n of a row of N: cp.async when the row allows it
// (vec: N % 16 == 0 and aligned bases, so a chunk is wholly in or out),
// else byte loads with the tail past N zeroed
__device__ __forceinline__ void load_wire16(uint8_t* dst, const uint8_t* src, int n, int N, int vec) {
  if (vec) {
    cp_async16(dst, src, n < N);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (n + 4 * i + b < N) v |= static_cast<uint32_t>(src[4 * i + b]) << (8 * b);
      w[i] = v;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 8 x values (bf16, or f32 rounded to bf16 RN) into one 16-byte core-matrix
// row; valid == false zero-fills (tokens past M)
__device__ __forceinline__ void load_x16(uint8_t* dst, const Params& p, const uint8_t* src, bool valid) {
  if (p.vec_x) {
    cp_async16(dst, valid ? src : p.x, valid);
    return;
  }
  uint32_t w[4] = {0, 0, 0, 0};
  if (valid) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p.x_is_bf16) {
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(src);
        w[i] = xs[2 * i] | (static_cast<uint32_t>(xs[2 * i + 1]) << 16);
      } else {
        const float* xf = reinterpret_cast<const float*>(src);
        w[i] = bf16_bits(xf[2 * i]) | (bf16_bits(xf[2 * i + 1]) << 16);
      }
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// This thread's share of every step's copies: one 16-byte chunk of the code
// tile (row tid / 8), one of the scale/meta tile (tid < 32) and XN of the x
// tile (token t + 32 i, K chunk c).  The global addresses of the split's
// first step are computed once; a step adds a fixed stride.
template <int NT>
struct Loader {
  static constexpr int XN = (NT * 8 + THREADS - 1) / THREADS;
  const uint8_t* code;
  const uint8_t* meta;
  const uint8_t* x;
  int n, t;                            // wire column; x token of chunk 0
  uint32_t code_dst, meta_dst, x_dst;  // offsets in a slot

  __device__ __forceinline__ Loader(const Params& p, int e, int kt0, int n0, int m0) {
    const int tid = threadIdx.x, row = tid >> 3, chunk = tid & 7;
    n = n0 + chunk * 16;
    const int nc = n < p.N ? n : 0;  // a chunk past N reads nothing; keep its address in bounds
    code = p.codes + (static_cast<size_t>(e) * (p.K / 2) + kt0 * (BK / 2) + row) * p.N + nc;
    meta = p.scale_meta + (static_cast<size_t>(e) * (p.K / 16) + kt0 * (BK / 16) + (row & 3)) * p.N + nc;
    code_dst = row * CODE_ROW + chunk * 16;
    meta_dst = CODE_BYTES + (row & 3) * BN + chunk * 16;
    const int c = (tid >> 3) & 7, size = p.x_is_bf16 ? 2 : 4;
    t = (tid & 7) | ((tid >> 6) << 3);
    x = static_cast<const uint8_t*>(p.x) + ((static_cast<size_t>(e) * p.M + m0 + t) * p.K + kt0 * BK + c * 8) * size;
    x_dst = X_OFFSET + (t >> 3) * 1024 + c * 128 + (t & 7) * 16;
    t += m0;
  }

  // step j of the split into `slot` (its x tile too when WITH_X: the fused
  // path reads x itself)
  template <bool WITH_X>
  __device__ __forceinline__ void load(const Params& p, uint8_t* slot, int j) const {
    const int tid = threadIdx.x, size = p.x_is_bf16 ? 2 : 4;
    load_wire16(slot + code_dst, code + static_cast<size_t>(j) * (BK / 2) * p.N, n, p.N, p.vec_w);
    if (tid < BK / 16 * 8)
      load_wire16(slot + meta_dst, meta + static_cast<size_t>(j) * (BK / 16) * p.N, n, p.N, p.vec_w);
    if (!WITH_X) return;
#pragma unroll
    for (int i = 0; i < XN; ++i)  // chunk i: token t + 32 i
      if (tid + i * THREADS < NT * 8)
        load_x16(slot + x_dst + i * 4096, p, x + (j * BK + static_cast<size_t>(32 * i) * p.K) * size,
                 t + 32 * i < p.M);
  }
};

// ---------------------------------------------------------------------------
// decode: 16-deep step s of a slot -> this thread's four A registers
// ---------------------------------------------------------------------------
// bf16x2 of (lo nibble, hi nibble) of one code byte, from u = [lo, 0, hi, 0]:
// the FP4 bits land as value x 2^-126, then x (scale x 2^118) + (special
// value x scale x 2^-8 where the code is 8, else +0)
__device__ __forceinline__ uint32_t decode_pair(uint32_t u, uint32_t is8, uint2 entry) {
  const uint32_t v = (u * 0x1040u) & 0x81C081C0u;  // sign -> bit 15, e1 e0 m -> bits 8..6
  return fma_bf16x2(v, entry.x, is8 & entry.y);
}

// Registers: a[0] (column c, k 2q, 2q+1), a[1] (c + 1, same k), a[2] (c,
// k 2q + 8, +9), a[3] (c + 1, k 2q + 8, +9): wgmma's A fragment for rows g
// and g + 8, whose columns are c = col and col + 1.  The integer pipe is
// what bounds the decode, so shifts and index arithmetic go to the
// multiplier (mad, mul.hi) where they can.
__device__ __forceinline__ void decode_step(uint32_t (&a)[4], const uint8_t* slot, const uint2* table, int s,
                                            int q, int col) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(slot + (8 * s + q) * CODE_ROW + col);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(slot + (8 * s + 4 + q) * CODE_ROW + col);
  const uint32_t w = mad_lo(hi, 0x10000u, lo);  // bytes: (c, kA), (c + 1, kA), (c, kB), (c + 1, kB)
  const uint32_t mm = *reinterpret_cast<const uint16_t*>(slot + CODE_BYTES + s * BN + col);
  const uint32_t m1 = mul_hi(mm, 0x1000000u);  // meta byte of column c + 1
  const uint2 t0 = table[mad_lo(m1, 0xFFFFFF00u, mm)], t1 = table[m1];
  const uint32_t wa = w & 0x0F0F0F0Fu, wb = mul_hi(w, 0x10000000u) & 0x0F0F0F0Fu;  // low, high nibbles
  // nibble == 8: sign set, magnitude bits clear -> flag at the nibble's bit 3
  const uint32_t z = lop3_and_andnot(w, (w & 0x77777777u) + 0x77777777u, 0x88888888u);
  const uint32_t z4 = mad_lo(z, 16u, 0u);  // low-nibble flags to bit 7 of each byte
  // prmt: selector nibble j copies byte j of {a, b}; 8 | j replicates its bit 7
  a[0] = decode_pair(prmt(wa, wb, 0x8480u), prmt(z4, z, 0xCC88u), t0);
  a[1] = decode_pair(prmt(wa, wb, 0x9591u), prmt(z4, z, 0xDD99u), t1);
  a[2] = decode_pair(prmt(wa, wb, 0xA6A2u), prmt(z4, z, 0xEEAAu), t0);
  a[3] = decode_pair(prmt(wa, wb, 0xB7B3u), prmt(z4, z, 0xFFBBu), t1);
}

// The fused activation fake-quant of `nsteps` steps of the block's x from
// step k-tile `kt` on, into the quantized-x region `qx` (each step's NT x 64
// tile in the ring slot's core-matrix layout).  The quads enumerate (token,
// 16-value block) over the tokens below M, the blocks of one token
// consecutive, so a warp reads 128 contiguous x values; a thread takes two
// quads at once where there are that many, so that their dependent chains
// overlap, and a warp with none left stops (the work is issue-bound: three
// resident blocks share an SM).  Tokens past M are zero.
template <int NT>
__device__ __forceinline__ void qdq_chunk(const Params& p, uint8_t* qx, const float* act, int e, int m0, int kt,
                                          int nsteps) {
  const int tid = opaque(static_cast<int>(threadIdx.x)), q = tid & 3;
  const unsigned mask = razer_act::quad_mask(tid & 31);
  const int valid = min(NT, p.M - m0), nblk = nsteps * (BK / 16), quads = valid * nblk;
  for (int i = tid; i < (NT - valid) * nsteps * 8; i += THREADS) {
    const int t = valid + i / (nsteps * 8), j = (i >> 3) % nsteps, c = i & 7;
    *reinterpret_cast<uint4*>(qx + j * Tile<NT>::X_TILE + (t >> 3) * 1024 + c * 128 + (t & 7) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  const size_t row0 = static_cast<size_t>(e) * p.M + m0;
  auto load = [&](int qi, float (&v)[4]) {
    const int t = qi / nblk, b = qi - t * nblk;
    const size_t at = (row0 + t) * p.K + static_cast<size_t>(kt) * BK + b * 16 + q * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = p.x_is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[at + i])
                         : static_cast<const float*>(p.x)[at + i];
  };
  auto store = [&](int qi, const float (&v)[4]) {
    const int t = qi / nblk, b = qi - t * nblk, c = 2 * (b & 3) + (q >> 1);
    *reinterpret_cast<uint2*>(qx + (b >> 2) * Tile<NT>::X_TILE + (t >> 3) * 1024 + c * 128 + (t & 7) * 16 +
                              (q & 1) * 8) =
        make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16), bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
  };
  constexpr int PER = THREADS / 4;  // quads a round
#pragma unroll 1
  for (int first = 0; first < quads; first += 2 * PER) {
    const int qa = first + (tid >> 2), qb = qa + PER;
    if (qa >= quads) break;  // the same on a quad's lanes
    float va[4], vb[4];
    if (qb < quads) {
      load(qa, va);
      load(qb, vb);
      razer_act::qdq_quad(va, act, p.act_nsv, q, mask);
      razer_act::qdq_quad(vb, act, p.act_nsv, q, mask);
      store(qa, va);
      store(qb, vb);
    } else {
      load(qa, va);
      razer_act::qdq_quad(va, act, p.act_nsv, q, mask);
      store(qa, va);
    }
  }
}

// One K step of the main loop: wait for step `it`'s copies, refill the slot
// two steps back, decode into `cur`, queue the step's wgmmas; with the
// fused activation quant, the wgmmas read x from the quantized tiles `qx`.  A-operand
// registers are read by the tensor cores asynchronously, so `prev` (the last
// step's A, possibly still in flight) is kept live until the wait that
// retires its group: the two sets alternate, and no decode overwrites
// registers a pending wgmma reads.
template <int NT, bool FUSE>
__device__ __forceinline__ void main_step(const Params& p, const Loader<NT>& loader, uint8_t* ring,
                                          const uint2* table, const uint8_t* qx, int it, int steps, int q, int col,
                                          float (&acc)[NT / 2], uint32_t (&cur)[4][4], uint32_t (&prev)[4][4]) {
  using R = Tile<NT>;
  cp_async_wait<R::STAGES - 3>();  // step it has landed (this thread's copies)
  fence_proxy_async();             // ... and is visible to the tensor cores
  __syncthreads();                 // ... everyone's; and slot it - 2 is free (its wgmmas retired)
  {
    const int j = it + R::STAGES - 2;
    if (j < steps) loader.template load<!FUSE>(p, ring + (j % R::STAGES) * R::STAGE_BYTES, j);
    cp_async_commit();
  }
  const uint8_t* slot = ring + (it % R::STAGES) * R::STAGE_BYTES;
#pragma unroll
  for (int s = 0; s < 4; ++s) decode_step(cur[s], slot, table, s, q, col);
  const uint32_t xs = FUSE ? smem_u32(qx + (it % p.qx_steps) * R::X_TILE) : smem_u32(slot + X_OFFSET);
  fence_operands(cur);
  fence_operands(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) Wgmma<NT>::mma(acc, cur[s], kmajor_desc(xs + s * 256));
  wgmma_commit();
  fence_operands(acc);
  wgmma_wait<1>();  // the previous step's group has retired: its slot and `prev` are free
  fence_operands(prev);
}

__device__ __forceinline__ void store_out(const Params& p, int e, int m, int n, float v) {
  const int nc = p.N / p.out_chunks;  // the launch checks N % out_chunks == 0
  const int chunk = n / nc;
  p.out[((static_cast<size_t>(chunk) * p.E + e) * p.M + m) * nc + (n - chunk * nc)] = __fadd_rn(v, 0.0f);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
// grid (ceil(N / BN), ceil(M / NT), E * splits); blockIdx.z names the expert
// and its K split, and the splits of one output tile form one cluster.  Tag
// only names the instantiation (K1, K6, K7 or K8), so a profile tells them
// apart.
// blocks per SM the register budget is set for: a small token tile is
// decode, where resident blocks hide the copies and the decode's latency
// (the fused path too: with the budget of two blocks it spills nothing,
// but measured slower at decode, PERF.md)
template <int NT>
constexpr int min_blocks() { return NT <= 48 ? 3 : (NT <= 96 ? 2 : 1); }

// FUSE: 0 the plain GEMM; 1 the fused activation path with the whole K
// split's x quantized before the main loop; 2 the fused path in chunks
// (a split longer than the quantized-x region holds: a fused launch forced
// at a large token tile by the checks, never the main path's).  Each is a kernel of
// its own, so that the plain GEMM and the one-chunk path at decode keep
// their registers.
template <typename Tag, int NT, int FUSE>
__global__ void __launch_bounds__(THREADS, min_blocks<NT>()) gemm_kernel(const __grid_constant__ Params p) {
  using R = Tile<NT>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint2* table = reinterpret_cast<uint2*>(smem);
  uint8_t* ring = smem + TABLE_BYTES;
  float* act = reinterpret_cast<float*>(ring + R::STAGES * R::STAGE_BYTES);  // fused launches only

  const int tid = threadIdx.x;
  const int split = blockIdx.z % p.splits, e = blockIdx.z / p.splits;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * NT;
  const int kt0 = split * p.k_tiles_per_split;
  const int steps = min(p.k_tiles_per_split, p.K / BK - kt0);

  {  // meta byte tid -> {bf16x2 scale x 2^118, bf16x2 special value x scale x 2^-8}
    const float scale = kE3M3[tid & 63];
    const float mag = (tid & 0x80) ? p.m1 : p.m0;  // select bit
    const float sv = (tid & 0x40) ? -mag : mag;     // sign bit
    const uint32_t s16 = bf16_bits(scale * 0x1p118f);
    const uint32_t v16 = bf16_bits(__bfloat162float(__float2bfloat16_rn(sv * scale)) * 0x1p-8f);
    table[tid] = make_uint2(s16 | (s16 << 16), v16 | (v16 << 16));
  }
  const Loader<NT> loader(p, e, kt0, n0, m0);
#pragma unroll
  for (int s = 0; s < R::STAGES - 2; ++s) {
    if (s < steps) loader.template load<FUSE == 0>(p, ring + s * R::STAGE_BYTES, s);
    cp_async_commit();
  }
  uint8_t* qx = reinterpret_cast<uint8_t*>(act) + ACT_BYTES;  // the fused path's quantized x tiles
  if constexpr (FUSE != 0) {  // after the prologue's copies are on their way
    for (int i = tid; i < razer_act::TABLE; i += THREADS) act[i] = p.act_table[i];
    __syncthreads();
  }

  const int lane = tid & 31, q = lane & 3, g = lane >> 2;
  const int col = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + 2 * g;  // this thread's columns: col, col + 1
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;

  uint32_t a[2][4][4] = {};
  constexpr bool FUSED = FUSE != 0;
  if constexpr (FUSE == 2) {
    // chunks of qx_steps steps, an even number, so that a chunk starts with
    // a[0] as `cur`; each chunk's x is quantized after every wgmma has retired
    int it = 0;
    for (int c0 = 0; c0 < steps; c0 += p.qx_steps) {
      if (c0) {
        wgmma_wait<0>();  // the last chunk's readers, and every A register in flight
        fence_operands(acc);
        fence_operands(a[0]);
        fence_operands(a[1]);
        __syncthreads();
      }
      qdq_chunk<NT>(p, qx, act, e, opaque(m0), opaque(kt0 + c0), opaque(min(p.qx_steps, steps - c0)));
      fence_proxy_async();  // made visible to the tensor cores by the first step's barrier
      const int end = min(c0 + p.qx_steps, steps);
      for (; it + 1 < end; it += 2) {
        main_step<NT, FUSED>(p, loader, ring, table, qx, it, steps, q, col, acc, a[0], a[1]);
        main_step<NT, FUSED>(p, loader, ring, table, qx, it + 1, steps, q, col, acc, a[1], a[0]);
      }
      if (it < end) main_step<NT, FUSED>(p, loader, ring, table, qx, it++, steps, q, col, acc, a[0], a[1]);
    }
  } else {
    if constexpr (FUSE == 1) {
      qdq_chunk<NT>(p, qx, act, e, m0, kt0, steps);  // all of the split, before any wgmma
      fence_proxy_async();
    }
    int it = 0;
    for (; it + 1 < steps; it += 2) {
      main_step<NT, FUSED>(p, loader, ring, table, qx, it, steps, q, col, acc, a[0], a[1]);
      main_step<NT, FUSED>(p, loader, ring, table, qx, it + 1, steps, q, col, acc, a[1], a[0]);
    }
    if (it < steps) main_step<NT, FUSED>(p, loader, ring, table, qx, it, steps, q, col, acc, a[0], a[1]);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  fence_operands(a[0]);
  fence_operands(a[1]);

  // acc[4i + {0, 1}]: column col, tokens t, t + 1; acc[4i + {2, 3}]: column
  // col + 1; t = 8i + 2q.  x 2^8 undoes the decode's 2^-8 (exact).
  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < NT / 8; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 8 * i + 2 * q + (r & 1), n = n0 + col + (r >> 1);
        if (m < p.M && n < p.N) store_out(p, e, m, n, acc[4 * i + r] * 256.0f);
      }
    return;
  }
  cp_async_wait_all();
  __syncthreads();  // the table and the ring are free: they hold the partial tile [token][column]
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < NT / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 8 * i + 2 * q + r;
      *reinterpret_cast<float2*>(part + t * BN + col) = make_float2(acc[4 * i + r] * 256.0f, acc[4 * i + 2 + r] * 256.0f);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // block `split` sums its share of the tile, four columns at a time, over
  // the cluster's ranks in order: every rank's loads first, then the sum
  const int total = NT * BN / 4, share = (total + p.splits - 1) / p.splits;
  const int end = min(total, (split + 1) * share);
  for (int i = split * share + tid; i < end; i += THREADS) {
    const int m = m0 + 4 * i / BN, n = n0 + 4 * i % BN;
    if (m >= p.M || n >= p.N) continue;
    float4 v[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < p.splits) v[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part + 4 * i, r));
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r)
      if (r < p.splits) sum = make_float4(sum.x + v[r].x, sum.y + v[r].y, sum.z + v[r].z, sum.w + v[r].w);
    store_out(p, e, m, n, sum.x);
    if (n + 1 < p.N) store_out(p, e, m, n + 1, sum.y);
    if (n + 2 < p.N) store_out(p, e, m, n + 2, sum.z);
    if (n + 3 < p.N) store_out(p, e, m, n + 3, sum.w);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// the launch of one instantiation (FUSE as gemm_kernel's)
template <typename Tag, int NT, int FUSE>
cudaError_t launch_kernel(const Params& p, dim3 grid, cudaStream_t st) {
  auto kernel = gemm_kernel<Tag, NT, FUSE>;
  constexpr int MAX_SMEM = Tile<NT>::SMEM + (FUSE ? ACT_BYTES + Tile<NT>::MAX_QSTEPS * Tile<NT>::X_TILE : 0);
  static unsigned configured = 0;  // devices whose shared-memory limit is raised, as a bit set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  Params q = p;
  q.qx_steps = FUSE == 0 ? 1 : FUSE == 1 ? p.k_tiles_per_split : Tile<NT>::MAX_QSTEPS & ~1;
  cfg.dynamicSmemBytes = Tile<NT>::SMEM + (FUSE ? ACT_BYTES + q.qx_steps * Tile<NT>::X_TILE : 0);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.splits;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, q);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// whether Tag's launches may carry an act table: the dense GEMMs (K1, K7)
// specialize it to true where they are named; the grouped GEMMs (K6, K8)
// never quantize x and build no fused kernel
template <typename Tag>
struct Fusable {
  static constexpr bool value = false;
};

template <typename Tag, int NT>
cudaError_t launch_nt(const Params& p, dim3 grid, cudaStream_t st) {
  if constexpr (Fusable<Tag>::value) {
    if (p.act_table)  // the whole K split's quantized x in one chunk when it fits
      return p.k_tiles_per_split <= Tile<NT>::MAX_QSTEPS ? launch_kernel<Tag, NT, 1>(p, grid, st)
                                                         : launch_kernel<Tag, NT, 2>(p, grid, st);
  }
  return p.act_table ? cudaErrorInvalidValue : launch_kernel<Tag, NT, 0>(p, grid, st);
}

// dynamic shared memory (bytes) of the block for token tile nt, 0 if none
inline int tile_smem(int nt) {
  switch (nt) {
    case 8: return Tile<8>::SMEM;
    case 16: return Tile<16>::SMEM;
    case 24: return Tile<24>::SMEM;
    case 32: return Tile<32>::SMEM;
    case 48: return Tile<48>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 96: return Tile<96>::SMEM;
    case 128: return Tile<128>::SMEM;
    default: return 0;
  }
}

// x: (E, M, K) bf16 (x_is_bf16) or f32, contiguous; codes (E, K/2, N) and
// scale_meta (E, K/16, N) uint8; out (E, M, N) f32, stored out_chunks-
// chunked ((out_chunks, E, M, N/out_chunks)).  act_table (razer_act_qdq.cuh's
// table, act_nsv <= 4 special values) or null: with it, x is fake-quantized
// in the load.  nt is the token tile (8,
// 16, 24, 32, 48, 64, 96 or 128); K is split into `splits` (1 ... MAX_SPLITS) runs of
// k_tiles_per_split 64-deep steps, none empty.  K must be a multiple of
// BK, N of out_chunks, and E * splits at most 65535.  One launch; returns
// cudaErrorInvalidValue on arguments it does not take, else
// cudaGetLastError() after the launch.
template <typename Tag>
cudaError_t launch_grouped(const void* x, int x_is_bf16, const void* codes, const void* scale_meta, void* out,
                           int E, int M, int K, int N, int nt, int splits, int k_tiles_per_split,
                           int out_chunks, float m0, float m1, const float* act_table, int act_nsv,
                           cudaStream_t st) {
  const int k_tiles = K / BK;
  if (E < 1 || M < 1 || N < 1 || K < BK || K % BK || splits < 1 || splits > MAX_SPLITS ||
      k_tiles_per_split < 1 || (splits - 1) * k_tiles_per_split >= k_tiles ||
      splits * k_tiles_per_split < k_tiles || static_cast<long long>(E) * splits > 65535 ||
      out_chunks < 1 || N % out_chunks || act_nsv < 0 || act_nsv > razer_act::MAX_SV)
    return cudaErrorInvalidValue;
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  Params p;
  p.x = x;
  p.codes = static_cast<const uint8_t*>(codes);
  p.scale_meta = static_cast<const uint8_t*>(scale_meta);
  p.out = static_cast<float*>(out);
  p.E = E, p.M = M, p.K = K, p.N = N, p.splits = splits, p.k_tiles_per_split = k_tiles_per_split;
  p.out_chunks = out_chunks, p.m0 = m0, p.m1 = m1;
  p.x_is_bf16 = x_is_bf16;
  p.vec_x = x_is_bf16 && aligned(x);
  p.vec_w = N % 16 == 0 && aligned(codes) && aligned(scale_meta);
  p.act_table = act_table;
  p.act_nsv = act_nsv;
  const dim3 grid((N + BN - 1) / BN, (M + nt - 1) / nt, E * splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  switch (nt) {
    case 8: return launch_nt<Tag, 8>(p, grid, st);
    case 16: return launch_nt<Tag, 16>(p, grid, st);
    case 24: return launch_nt<Tag, 24>(p, grid, st);
    case 32: return launch_nt<Tag, 32>(p, grid, st);
    case 48: return launch_nt<Tag, 48>(p, grid, st);
    case 64: return launch_nt<Tag, 64>(p, grid, st);
    case 96: return launch_nt<Tag, 96>(p, grid, st);
    case 128: return launch_nt<Tag, 128>(p, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace razer_tile
