// Grouped GEMMs over e4m3 or int8 operands, with one scale per group (expert):
//   scatter:  out[slot] = (x[row_idx[slot]] . W[grp[slot / tm]]^T) * y_scale[grp[slot / tm]]
//   aligned:  out[row_blk[t] * tm + i] = (x[row_blk[t] * tm + i] . W[grp[t]]^T) * y_scale[grp[t]]
// or with blockwise scales (one per (row, 128-group of K) of x, one per
// 128 x 128 block of each weight), over the same two row sources:
//   out[s, n] = sum_kg (x[r, kg] . W[g, n, kg]) * sx[r, kg] * sw[g, n / 128, kg]
// with r the row behind slot s and kg the k-th 128-wide group of K.
// e4m3 products accumulate in float32, int8 products in exact int32 sums
// that are then converted to float32 (round to nearest); the result is bf16.
// The scatter GEMM over int8 also has the MoE gate-up epilogue ("act"):
//   codes[slot, c] = clip(rint(silu(gate) * up * act_scale[0]), +-127) as int8
// where gate and up are the bf16-rounded, scaled accumulators of the gate
// row and the matching up row of the interleaved weight.
//
// Replaces: hpc_ops_tpu/ops/group_gemm.py:_gg_scatter_kernel (the Pallas
// kernel behind _gg_scatter_pallas: group_gemm_fp8_scatter, the packed
// group_gemm_pertensor_* entry points and the GEMMs of
// ops/moe.py:fuse_moe_pertensor_fp8, its act_fuse epilogue included),
// hpc_ops_tpu/ops/group_gemm.py:_gg_pertensor_kernel (_gg_pertensor_pallas:
// the down GEMM of the fused int8 MoE and both GEMMs of impl="gather"), and
// the blockwise ones: _gg_bw_scatter_kernel (_gg_bw_scatter_pallas, the
// default scheme of group_gemm_blockwise_* and fuse_moe_blockwise_*) by the
// blockwise scatter form, _gg_blockwise_kernel and _gg_bw_prescale_kernel
// (the aligned-row schemes "fp8", "int8" and "prescale") by the blockwise
// aligned form. The TPU kernels fold both scale sets into bf16 operands
// (about 2^-9 relative error each) because per-group promotion breaks the
// v5e MXU's accumulation chain; here each 128-wide K stage is exactly one
// scale group, so its tensor-core partial is promoted into a float32
// accumulator exactly (DeepGEMM's structure): acc + (partial * sx) * sw,
// groups in order, no FMA, the plain version's order.
//
// Contract, as there: output rows come in m-tiles of tm slots, each tile
// owned by one group (expert) grp[tile]. Scatter: row_idx[slot] names the
// row of x that slot computes on (x is never gathered in memory), -1 marks
// an empty slot whose output row may hold anything. Aligned: tile t reads and
// writes row block row_blk[t] of x and out, every row of it real. Tiles at or
// past num_valid_tiles[0] (a device scalar, so the host never reads it) do
// nothing at all. The act epilogue's weight is interleaved in pairs of
// 2 * pair rows (pair gate rows, then the pair matching up rows), so output
// column j * pair + c pairs weight rows j * 2 * pair + c and + pair; its
// output has n / 2 columns. The blockwise x scales are read through the same
// row as x (sx[row_idx[slot]] or sx[row_blk[t] * tm + i]); an empty slot's
// scales are never read.
//
// Bound on the card: bytes at decode shapes (a handful of rows per expert:
// every hit expert's whole weight is streamed for almost no arithmetic),
// operations at prefill shapes (hundreds of rows per expert: 2 M N K
// operations against (M + N) K bytes; Mixtral's gate-up GEMM at 2048 tokens
// is 0.486 ms of work at the 8-bit tensor-core rate of an H100, 0.972 at the
// 16-bit rate the e4m3 per-tensor forms run at, against 0.16 ms of bytes).
//
// Three bodies, chosen by the wrapper from host integers
// (ops/group_gemm.py:gg_form):
//  - the 8-bit wgmma body: the int8 forms and the blockwise forms;
//  - the register-operand wgmma body: the e4m3 per-tensor forms at m-tiles
//    of 64 slots and more (prefill);
//  - the mma.sync body: the e4m3 per-tensor forms at m-tiles of 32 (decode).
//
// Precision of the e4m3 forms. Hopper's fp8 wgmma sums into a narrower
// accumulator (about 14 bits, DeepSeek-V3's report). Even with each 128-K
// stage promoted into float32, 5.4-6.9% of the bf16 outputs of an e4m3
// per-tensor GEMM landed a step off the plain version's on an H100 at K 256
// to 14336; behind the MoE's e4m3 activation codes that moved the fp8 MoE
// card test 0.015 past its bar of 0.02 + 2%. So the per-tensor forms
// multiply fp16 values in the 16-bit tensor cores: an e4m3 value converts to
// fp16 exactly (cvt.rn.f16x2.e4m3x2), a product of two is exact, and the
// sums run in float32, as the plain version's (scripts/gg_precision.py: 0-
// 0.04% of outputs a step off on both bodies at m-tiles of 32 to 512, the
// MoE within its bar at 32 and 512 tokens).
// The blockwise e4m3 forms keep fp8 products with each stage's partial
// promoted, acc + (partial * sx) * sw (DeepGEMM's structure; their plain
// version promotes the same groups). int8 sums are exact in s32 (14336 *
// 127^2 < 2^31): the per-tensor int8 forms sum all of K in s32 and convert
// once, the blockwise ones promote each stage as the plain version does, so
// both stay bit-equal to it.
//
// The 8-bit wgmma body. wgmma.mma_async m64n128k32, A (rows of x) and B
// (weight rows) K-major in shared memory in the 128-byte swizzle: .s32.s8.s8
// for int8, .f32.e4m3.e4m3 for the blockwise e4m3 forms. A block takes 64
// rows of one m-tile for each of its WG consumer warpgroups by 128 weight
// rows: 128 output columns, or with the act epilogue the 64 gate rows and
// the 64 matching up rows of 64 output columns. WG is 2 for the int8
// per-tensor forms at m-tiles of 128 slots or more, else 1. K walks
// 128-byte stages through a ring in shared memory; a stage is one row of the
// 128-byte swizzle, four k32 products and one blockwise scale group. The
// ring holds 4 stages of 24 KiB at WG 1 and 3 of 32 KiB at WG 2, so two
// blocks share an SM either way (the int8 per-tensor forms hold 95 registers
// a thread, the blockwise ones 255 at 128 threads) and one block's barrier,
// promotion and epilogue overlap the other's products. On an H100 at 2048
// tokens (scripts/time_gg_scatter.py, time_gg_bw.py) the per-tensor forms
// ran 6-30% faster at WG 2 than at WG 1, and the blockwise forms 9-35%
// faster at WG 1 than in one block of two warpgroups and 5 stages an SM,
// which their registers force.
//  - Weights by TMA: a 2D tensor map over w viewed as [groups * n, k] bytes,
//    two boxes of 64 rows x 128 bytes a stage in the 128-byte swizzle,
//    issued by thread 0 and completing on the slot's mbarrier. K past k and
//    rows past the weight's end arrive as zeros; rows past n inside w are
//    the next group's and feed only columns that are never stored. The map
//    is encoded on the host for each call (cuTensorMapEncodeTiled through
//    cudaGetDriverEntryPoint: the library is not linked against libcuda) and
//    passed as a __grid_constant__ parameter. Against a cp.async ring for the
//    weights it was 7-22% faster at every shape measured.
//  - Rows of x by 16-byte cp.async, each warpgroup its own 64 rows, fetched
//    by their index into the same swizzled layout (TMA cannot gather rows);
//    empty slots, rows past the tile and K past k are zero-filled by
//    cp.async's src-size 0.
//  - One loop for every thread: wait for stage kt (this thread's cp.async
//    groups, the slot's mbarrier), one __syncthreads, issue stage kt's
//    products, refill a free slot while they run, then wait for them and
//    promote. (A pipeline per warpgroup, named barriers and an "empty"
//    mbarrier a slot in place of the __syncthreads, measured 13-19% slower
//    at 2048 tokens.)
//  - A warpgroup whose 64 rows hold no real row skips its products as a
//    whole; its predicate is broadcast from lane 0 so that ptxas sees it
//    warp-uniform (a wgmma on a divergent path serialises every wgmma of the
//    kernel, advisory C7520). A block with no real row returns before it
//    streams any weight.
//  - The act epilogue: gate column c and up column c + 64 of a block are
//    accumulator registers 4j + i and 4(j + 8) + i of one thread, so no
//    exchange through shared memory is needed. Its arithmetic is that of
//    csrc/activation.cu (expf, an IEEE division, __fmul_rn, rintf; no
//    contraction into FMA), so the codes equal the plain version's.
//  - Registers: 64 float32 or s32 sums a thread, and 64 promoted sums in the
//    blockwise forms.
//  - The blocks of one m-tile sit side by side in the grid's fast dimension,
//    and the tiles of one group are consecutive, so the blocks that share a
//    weight panel run together and it is read from device memory about once.
//  - Known limits: no warp specialisation, no TMA multicast, no persistent
//    grid, and each stage waits for its own products before the next is
//    issued, so only the SM's other block keeps the tensor cores busy
//    through a barrier, a promotion or an epilogue.
//
// The register-operand body (the e4m3 per-tensor forms from m-tiles of 64).
// The body it replaced converted every stage of both operands to fp16 in
// shared memory before an all-shared-memory wgmma: a 128 x 128 block wrote
// 64 KiB of fp16 and its products read 96 KiB for every 128-K stage of 4.2
// M operations, at 26% of the fp16 rate. Here the weights never pass
// through shared memory as fp16:
//  - The tile is computed transposed. A block takes 256 weight rows (two
//    64-row m-tiles for each of two consumer warpgroups, on wgmma's 64-row
//    side) by up to 128 slots of one m-tile (wgmma's N), and writes
//    out[slot, weight row].
//  - Weights as A from registers: a stage (64 K bytes) of the block's
//    weight rows arrives by TMA as e4m3 (one box of 256 rows x 64 bytes,
//    rows 64 bytes apart: each quarter-warp's 16-byte loads hit every bank
//    once); each consumer thread loads its fragments, 16 bytes of each of
//    its four rows, converts them in registers and feeds wgmma m64nNk16
//    .f32.f16.f16. A thread's 16 bytes hold its A columns of four k16 steps,
//    so K is taken in a permuted order within a stage: step j, column 2q + e
//    (+ 8 h) is K byte 16 q + 4 j + 2 h + e. Sums over K do not depend on
//    that order beyond float32 rounding, and the outputs measured bit-equal
//    to the plain version's at every case tried.
//  - Token rows as B in shared memory: TMA cannot gather rows, so thread t
//    of a producer warpgroup gathers row t of the block by 16-byte cp.async
//    into an e4m3 landing ring two stages ahead, then converts it once to
//    fp16, in the same permuted K order, into the stage's B tile (K-major,
//    128-byte swizzle), where both consumer warpgroups read it. (Converting
//    x to fp16 rows on the device before the GEMM would double the token
//    bytes every block reads from L2 and need a workspace of up to 235 MB at
//    2048 tokens for the down GEMM's input.)
//  - The producer warpgroup (thread 0 issues the weight boxes) keeps a ring
//    of 6 slots of fp16 token rows and a weight box, guarded by "full"
//    mbarriers (129 arrivals: its 128 threads and the TMA's byte count) and
//    "empty" ones (one arrival from each of the 8 consumer warps). The
//    consumers only convert, multiply and write: a stage's A fragments are
//    converted into one of two register sets while the previous stage's
//    products, which read the other, are in flight, and a slot is handed
//    back as soon as the products that read it have retired. setmaxnreg
//    gives the consumers 224 registers a thread and the producer 56.
//  - N follows the rows: a block multiplies its slots up to its last real
//    one in steps of 64 (wgmma N 64 or 128, a branch taken uniformly by the
//    block), gathers and converts only real rows, and returns at once if it
//    has none. An empty slot's column of the products holds anything and is
//    never stored.
//  - Shared memory: 6 x (16 KiB of fp16 token rows + 16 KiB of weights) + 3 x
//    8 KiB of landing rows + 512 bytes of row indices: one block an SM.
//    Registers: 168 a thread at launch, no spills; ptxas gives advisory
//    C7513 (a stage's A fragments are written while the previous stage's
//    products run), and a form that converts only under wait_group 0,
//    without the advisory, measured no faster.
//  - Grid: as the 8-bit body's, not persistent.
//  - Measured on an H100 (700 W; scripts/time_gg_scatter.py), gate-up +
//    down at Mixtral's widths, against the replaced body in the same call:
//    2048 tokens (m-tiles of 512) 3.26-3.29 ms against 5.34-5.42, 1024
//    (288) 1.81-1.82 against 2.93-2.98, 512 (160) 1.03-1.04 against
//    1.86-1.88, 200 (64) 0.54 against 0.66.
//    What bounds it, from variants that each leave out one part of the work
//    (wrong outputs, timing only), in a first shape of 128 weight rows by
//    256 slots at 2048 tokens (3.5 ms): the products alone 2.35 ms (72-78%
//    of the fp16 rate over the slots they compute); the gathers of token rows
//    cost 1.0 ms more, the weight boxes 0.3, the producer's conversions 0.4,
//    the consumers' and the stores nothing measurable. 256 weight rows by
//    128 slots halve the gathers and conversions of token rows for each
//    operation: 3.1 ms. Tried and slower: converting by integer bit
//    operations (4.0 ms), weights in a ring of their own issued 8 stages
//    ahead (5.9), gathering four threads a row (5.0, 4.4 at two), token rows
//    by 1D bulk copies (8.2); deeper landing or token rings changed nothing.
//
// The mma.sync body (the e4m3 per-tensor forms at m-tiles of 32): below,
// with its own note.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>
#include <type_traits>

#include "tma.cuh"    // mbarriers, TMA box loads, the tensor-map encoder
#include "wgmma.cuh"  // cp.async, the wgmma fence, commit and wait, descriptors

namespace {

constexpr int BN = 128;  // weight rows of a block
constexpr int BK = 128;  // K bytes of a stage: one 128-byte swizzle row, four k32 products

enum Mode { kScatter = 0, kScatterAct = 1, kAligned = 2, kBwScatter = 3, kBwAligned = 4 };
__host__ __device__ constexpr bool is_bw(int mode) {
  return mode == kBwScatter || mode == kBwAligned;
}
struct E4m3 {};
struct I8 {};
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<I8> { using type = int; };

// the e4m3 per-tensor forms: fp16 products of exact e4m3 values, on the
// register-operand body (gg_form 3) or the mma.sync body (gg_form 0)
template <typename T, int MODE>
__host__ __device__ constexpr bool pertensor_e4m3() {
  return std::is_same<T, E4m3>::value && (MODE == kScatter || MODE == kAligned);
}
// a float32 accumulator beside the tensor cores' per-stage partials
template <typename T, int MODE>
__host__ __device__ constexpr bool promotes() {
  return is_bw(MODE);
}
template <typename T, int MODE, int WG>
struct Layout {
  static_assert(!pertensor_e4m3<T, MODE>(), "the e4m3 per-tensor forms have bodies of their own");
  static constexpr int BM = 64 * WG;  // rows of a block, 64 a consumer warpgroup
  static constexpr int THREADS = 128 * WG;
  static constexpr int STAGES = WG == 1 ? 4 : 3;
  static_assert(WG == 1 || !promotes<T, MODE>(), "blocks of two warpgroups sum in float32 only");
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE = A_BYTES + BN * BK;  // a multiple of 1024: the swizzle's period
  static constexpr int SMEM = 1024 + STAGES * STAGE;  // 1024: alignment
};

struct Params {
  const uint8_t* x;
  const uint8_t* w;
  const float* y_scale;
  const float* act_scale;
  const int32_t* rows;  // row_idx (scatter) or row_blk (aligned)
  const int32_t* grp;
  const int32_t* num_valid_tiles;
  void* out;
  int num_tiles, tm, subtiles, n, k, pair, bf16_mul;
  const float* sx;  // blockwise: [rows of x, sx_stride], column kg is group kg
  const float* sw;  // blockwise: [groups, n / 128, sw_stride]
  int sx_stride, sw_stride;
};

// Keeps the compiler from moving uses of the registers an in-flight wgmma
// reads (a register A operand) or writes (its sums) across the fence,
// commit and wait.
template <typename A, int R>
__device__ __forceinline__ void fence_regs(A (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<A, float>::value) asm volatile("" : "+f"(d[i])::"memory");
    else asm volatile("" : "+r"(d[i])::"memory");
  }
}
#define GG_D64                                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define GG_OP8(c, d, i)                                                                        \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])
#define GG_OP64(c, d)                                                                         \
  GG_OP8(c, d, 0), GG_OP8(c, d, 8), GG_OP8(c, d, 16), GG_OP8(c, d, 24), GG_OP8(c, d, 32), \
      GG_OP8(c, d, 40), GG_OP8(c, d, 48), GG_OP8(c, d, 56)

// One k32 product of a warpgroup, 64 rows by 128 columns, A and B K-major
// from shared memory; accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_k32(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " GG_D64 ", %64, %65, p, 1, 1;\n}\n"
      : GG_OP64("+f", d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " GG_D64 ", %64, %65, p;\n}\n"
      : GG_OP64("+r", d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// Two e4m3 bytes (the low 16 bits) -> two fp16 values in one register, exactly.
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t two_bytes) {
  uint32_t out;
  const unsigned short in = static_cast<unsigned short>(two_bytes);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(out) : "h"(in));
  return out;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

// silu(gate) * up * act_scale -> an int8 code, as csrc/activation.cu computes it.
__device__ __forceinline__ int8_t act_code(float gate, float up, float act_scale, int bf16_mul) {
  const float act = gate * (1.f / (1.f + expf(-gate)));
  float prod;
  if (bf16_mul) {
    // the product of two bf16 values is exact in float32: one rounding
    prod = __bfloat162float(
        __float2bfloat16(__fmul_rn(__bfloat162float(__float2bfloat16(act)), up)));
  } else {
    prod = __fmul_rn(act, up);
  }
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(prod, act_scale)), -127.f), 127.f));
}

// Scaled accumulator, rounded to bf16 and back: the GEMM's output value.
__device__ __forceinline__ float scaled_bf16(float acc, float scale) {
  return __bfloat162float(__float2bfloat16(__fmul_rn(acc, scale)));
}

template <typename T, int MODE, int WG>
__device__ __forceinline__ void gg_body(const Params& p, const CUtensorMap& wmap) {
  using L = Layout<T, MODE, WG>;
  using Acc = typename AccOf<T>::type;
  constexpr int BM = L::BM, STAGES = L::STAGES, AHEAD = STAGES - 1;
  constexpr bool ACT = MODE == kScatterAct;
  constexpr bool ALIGNED = MODE == kAligned || MODE == kBwAligned;
  constexpr bool BW = is_bw(MODE);
  constexpr bool PROMOTE = promotes<T, MODE>();
  const int tm = p.tm, n = p.n, k = p.k;

  const int tile = blockIdx.x / p.subtiles;
  if (tile >= p.num_valid_tiles[0]) return;
  const int sub = blockIdx.x - tile * p.subtiles;
  const int tid = threadIdx.x, lane = tid & 31;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  __shared__ int32_t s_src[BM];   // row of x behind each row of the block, -1: none
  __shared__ int s_any[BM / 32];  // does this 32-row group hold a real row
  __shared__ __align__(8) uint64_t s_full[STAGES];  // the weight boxes of a slot have landed

  // The block's weight rows: 128 from g0 on, or (act) 64 gate rows from g0
  // on and the 64 up rows from g0 + pair on, for output columns c0 .. c0 + 63.
  const int c0 = blockIdx.y * (ACT ? BN / 2 : BN);
  const int g0 = ACT ? (c0 / p.pair) * 2 * p.pair + c0 % p.pair : c0;
  // the first row of x and of out behind row 0 of this block
  const int64_t row0 = static_cast<int64_t>(ALIGNED ? p.rows[tile] : tile) * tm + sub * BM;

  int src = -1;
  if (tid < BM) {
    const int in_tile = sub * BM + tid;
    if (in_tile < tm) {
      src = ALIGNED ? static_cast<int>(row0 + tid) : p.rows[static_cast<int64_t>(tile) * tm + in_tile];
    }
    s_src[tid] = src;
  }
  const unsigned real = __ballot_sync(0xffffffffu, src >= 0);
  if (tid < BM && lane == 0) s_any[tid >> 5] = real != 0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&s_full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!__syncthreads_or(src >= 0)) return;  // no real row: stream no weights

  const int wg = tid >> 7, wt = tid & 127;  // warpgroup, thread in it
  // does this warpgroup's 64 rows hold a real row; from lane 0, warp-uniform
  const bool live = __shfl_sync(0xffffffffu, s_any[2 * wg] | s_any[2 * wg + 1], 0) != 0;
  const int group = p.grp[tile];
  const int wrow = group * n + g0;  // the block's first weight row in the [groups * n, k] view
  const int kt_total = (k + BK - 1) / BK;

  // This thread's 16-byte chunk j of its warpgroup's rows wt / 8 + 16 i of a
  // stage of x: its source row (null: zeros) and its swizzled offset.
  const int j = wt & 7;
  const uint8_t* arow[4];
  uint32_t adst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wg * 64 + (wt >> 3) + i * 16;
    const int s = s_src[r];
    arow[i] = s >= 0 ? p.x + static_cast<int64_t>(s) * k + j * 16 : nullptr;
    adst[i] = r * 128 + ((j ^ (r & 7)) << 4);
  }
  auto load_rows = [&](int slot, int kt) {  // this warpgroup's rows of x, stage kt
    const int k0 = kt * BK;
    uint8_t* sa = smem + slot * L::STAGE;
    const bool kin = k0 + j * 16 < k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = arow[i] != nullptr && kin;
      cp_async16(smem_u32(sa + adst[i]), ok ? arow[i] + k0 : p.x, ok);
    }
  };
  auto load_weights = [&](int slot, int kt) {  // thread 0: the block's weight boxes, stage kt
    const uint32_t bar = smem_u32(&s_full[slot]);
    const uint32_t sb = s_base + slot * L::STAGE + L::A_BYTES;
    mbar_expect_tx(bar, BN * BK);
    tma_load_2d(sb, &wmap, kt * BK, wrow, bar);
    tma_load_2d(sb + 64 * BK, &wmap, kt * BK, wrow + (ACT ? p.pair : 64), bar);
  };
  // This thread's accumulator rows (64-row wgmma layout: warp w of the
  // warpgroup holds rows 16w .. 16w + 15, lane l rows l / 4 and l / 4 + 8;
  // register 4c + 2h + e is row + 8h, column 8c + 2(l % 4) + e).
  const int r_a = wg * 64 + (wt >> 5) * 16 + (lane >> 2);
  const int src_a = s_src[r_a], src_b = s_src[r_a + 8];

  Acc part[64];
  float acc[PROMOTE ? 64 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0;
#pragma unroll
  for (int i = 0; i < (PROMOTE ? 64 : 1); ++i) acc[i] = 0.f;

  const uint64_t da = desc_sw128(s_base + wg * 64 * BK);
  const uint64_t db = desc_sw128(s_base + L::A_BYTES);

  auto refill = [&](int slot, int kt) {  // stage kt into a free slot, if there is one
    if (kt < kt_total) {
      load_rows(slot, kt);
      if (tid == 0) load_weights(slot, kt);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) refill(s, s);

  for (int kt = 0; kt < kt_total; ++kt) {
    const int slot = kt % STAGES;
    cp_async_wait<AHEAD - 1>();
    mbar_wait(smem_u32(&s_full[slot]), (kt / STAGES) & 1);
    fence_proxy_async();
    __syncthreads();  // stage kt has landed; stage kt - 1 has been read by all
    float sxa = 0.f, sxb = 0.f, swv = 0.f;
    if (live) {
      if constexpr (BW) {  // stage kt is scale group kt; read while the products run
        if (src_a >= 0) sxa = p.sx[static_cast<int64_t>(src_a) * p.sx_stride + kt];
        if (src_b >= 0) sxb = p.sx[static_cast<int64_t>(src_b) * p.sx_stride + kt];
        swv = p.sw[(static_cast<int64_t>(group) * (n / BN) + blockIdx.y) * p.sw_stride + kt];
      }
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t off = slot * L::STAGE + ks * 32;
        wgmma_k32(part, desc_at(da, off), desc_at(db, off), PROMOTE ? ks > 0 : (kt | ks) > 0);
      }
      wgmma_commit();
    }
    // into the slot stage kt - 1 has freed
    refill((kt + AHEAD) % STAGES, kt + AHEAD);
    if (live) {
      wgmma_wait<0>();
      fence_regs(part);
      if constexpr (BW) {  // acc += (partial * sx[row]) * sw, rounded step by step
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float sx = (i & 2) ? sxb : sxa;
          acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(to_float(part[i]), sx), swv));
        }
      } else if constexpr (PROMOTE) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], to_float(part[i]));
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;

  float scale = 1.f;  // the blockwise forms have applied their scales
  if constexpr (!BW) scale = p.y_scale[group];
  const int q2 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_a + 8 * h;
    if ((h ? src_b : src_a) < 0) continue;  // an empty slot, or a row past the tile
    if constexpr (ACT) {
      const float am = p.act_scale[0];
      int8_t* orow = static_cast<int8_t*>(p.out) + (row0 + r) * (n / 2);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint16_t two = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gate = scaled_bf16(to_float(part[4 * c + 2 * h + e]), scale);
          const float up = scaled_bf16(to_float(part[4 * (c + 8) + 2 * h + e]), scale);
          two |= static_cast<uint16_t>(static_cast<uint8_t>(act_code(gate, up, am, p.bf16_mul)))
                 << (8 * e);
        }
        *reinterpret_cast<uint16_t*>(orow + c0 + 8 * c + q2) = two;
      }
    } else {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) + (row0 + r) * n;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int col = c0 + 8 * c + q2;
        if (col < n) {
          const int i = 4 * c + 2 * h;
          float v0, v1;
          if constexpr (BW) {
            v0 = acc[i];
            v1 = acc[i + 1];
          } else if constexpr (PROMOTE) {
            v0 = __fmul_rn(acc[i], scale);
            v1 = __fmul_rn(acc[i + 1], scale);
          } else {
            v0 = __fmul_rn(to_float(part[i]), scale);
            v1 = __fmul_rn(to_float(part[i + 1]), scale);
          }
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// ---- The mma.sync body: the e4m3 per-tensor forms at decode m-tiles (wg 0).
// Each e4m3 fragment is converted to fp16 (exact) in registers and
// multiplied with mma.sync.m16n8k16 into float32, as the register-operand
// body multiplies them. A block takes 32 rows of an m-tile by 128 weight rows, 4
// warps of 32 x 32, through a 4-stage cp.async ring of 128-byte stages
// stored as two [rows][64] byte planes (conflict-free 16-byte fragment
// loads); 16-row groups with no real row skip their products.
constexpr int PLANE = 64;    // bytes of a row in one plane of a stage
constexpr int MMA_BM = 32;   // rows of a block
constexpr int MMA_STAGES = 4;
constexpr int MMA_STAGE = (MMA_BM + BN) * BK;
constexpr int MMA_SMEM = MMA_STAGES * MMA_STAGE;

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <int MODE>
__device__ __forceinline__ void gg_mma_body(const Params& p) {
  constexpr int MI = 2, NI = 4;  // a warp's 16-row and 8-column fragments
  constexpr bool ALIGNED = MODE == kAligned;
  const int tm = p.tm, n = p.n, k = p.k;
  const int tile = blockIdx.x / p.subtiles;
  if (tile >= p.num_valid_tiles[0]) return;
  const int sub = blockIdx.x - tile * p.subtiles;
  const int tid = threadIdx.x, lane = tid & 31, wn = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row (A, C) or column (B); quad lane
  const int n0 = blockIdx.y * BN;
  const int64_t row0 = static_cast<int64_t>(ALIGNED ? p.rows[tile] : tile) * tm + sub * MMA_BM;

  extern __shared__ __align__(16) uint8_t smem_mma[];
  __shared__ int32_t s_src[MMA_BM];
  int src = -1;
  if (tid < MMA_BM) {
    const int in_tile = sub * MMA_BM + tid;
    if (in_tile < tm) {
      src = ALIGNED ? static_cast<int>(row0 + tid) : p.rows[static_cast<int64_t>(tile) * tm + in_tile];
    }
    s_src[tid] = src;
  }
  if (!__syncthreads_or(src >= 0)) return;  // no real row: stream no weights
  bool live[MI];  // does this 16-row group hold a real row
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    live[mi] = __ballot_sync(0xffffffffu, lane < 16 && s_src[mi * 16 + lane] >= 0) != 0;
  }
  const int group = p.grp[tile];
  const uint8_t* wgt = p.w + static_cast<int64_t>(group) * n * k;
  const int kt_total = (k + BK - 1) / BK;

  // Piece c of a [2][rows][64] stage lies at byte 16 * c: plane c / (4 rows),
  // row (c / 4) % rows, 16-byte quarter c % 4.
  auto load_stage = [&](int slot, int kt) {
    uint8_t* sa = smem_mma + slot * MMA_STAGE;
    uint8_t* sb = sa + MMA_BM * BK;
    const int k0 = kt * BK;
    for (int c = tid; c < MMA_BM * 8; c += 128) {
      const int plane = c / (MMA_BM * 4), rem = c - plane * (MMA_BM * 4);
      const int kk = k0 + plane * PLANE + (rem & 3) * 16;
      const int r = s_src[rem >> 2];
      const bool ok = r >= 0 && kk < k;
      cp_async16(smem_u32(sa + c * 16), ok ? p.x + static_cast<int64_t>(r) * k + kk : p.x, ok);
    }
    for (int c = tid; c < BN * 8; c += 128) {
      const int plane = c / (BN * 4), rem = c - plane * (BN * 4);
      const int kk = k0 + plane * PLANE + (rem & 3) * 16;
      const int wrow = n0 + (rem >> 2);
      const bool ok = wrow < n && kk < k;
      cp_async16(smem_u32(sb + c * 16), ok ? wgt + static_cast<int64_t>(wrow) * k + kk : wgt, ok);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.f;

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < kt_total) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 has been read by all
    const int next = kt + MMA_STAGES - 1;
    if (next < kt_total) load_stage(next % MMA_STAGES, next);
    cp_async_commit();
    const uint8_t* sa = smem_mma + (kt % MMA_STAGES) * MMA_STAGE;
    const uint8_t* sb = sa + MMA_BM * BK;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      // a lane's 16-byte piece holds its operands of four consecutive k16 steps
      uint4 a_lo[MI], a_hi[MI], b[NI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (!live[mi]) continue;
        const uint8_t* pa = sa + plane * MMA_BM * PLANE + (mi * 16 + gq) * PLANE + tq * 16;
        a_lo[mi] = *reinterpret_cast<const uint4*>(pa);
        a_hi[mi] = *reinterpret_cast<const uint4*>(pa + 8 * PLANE);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        b[ni] = *reinterpret_cast<const uint4*>(sb + plane * BN * PLANE +
                                                (wn * 32 + ni * 8 + gq) * PLANE + tq * 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t v = word(b[ni], j);
          bf[ni][0] = e4m3x2_to_f16x2(v);
          bf[ni][1] = e4m3x2_to_f16x2(v >> 16);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          if (!live[mi]) continue;
          const uint32_t lo = word(a_lo[mi], j), hi = word(a_hi[mi], j);
          const uint32_t af[4] = {e4m3x2_to_f16x2(lo), e4m3x2_to_f16x2(hi),
                                  e4m3x2_to_f16x2(lo >> 16), e4m3x2_to_f16x2(hi >> 16)};
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_f16(acc[mi][ni], af, bf[ni]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const float scale = p.y_scale[group];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (!live[mi]) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mi * 16 + gq + half * 8;
      if (s_src[r] < 0) continue;  // an empty slot, or a row past the tile
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) + (row0 + r) * n;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tq * 2;
        if (col < n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              __fmul_rn(acc[mi][ni][half * 2], scale), __fmul_rn(acc[mi][ni][half * 2 + 1], scale));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(128, 1) gg_scatter_e4m3_mma_kernel(const Params p) {
  gg_mma_body<kScatter>(p);
}
__global__ void __launch_bounds__(128, 1) gg_pertensor_e4m3_mma_kernel(const Params p) {
  gg_mma_body<kAligned>(p);
}

// More than 48 KB of dynamic shared memory for `kernel`: an attribute of
// each device, granted once a device (`configured`: a bit a device).
template <typename K>
int grant_smem(K kernel, int bytes, std::atomic<unsigned long long>& configured) {
  int dev = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return static_cast<int>(c);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if ((configured.load(std::memory_order_relaxed) & bit) == 0 || bit == 0) {
    c = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (c != cudaSuccess) return static_cast<int>(c);
    configured.fetch_or(bit, std::memory_order_relaxed);
  }
  return 0;
}

template <int MODE>
int launch_mma(Params p, cudaStream_t stream) {
  auto kernel = MODE == kAligned ? gg_pertensor_e4m3_mma_kernel : gg_scatter_e4m3_mma_kernel;
  static std::atomic<unsigned long long> configured{0};
  const int c = grant_smem(kernel, MMA_SMEM, configured);
  if (c != 0) return c;
  p.subtiles = (p.tm + MMA_BM - 1) / MMA_BM;
  const dim3 grid(static_cast<unsigned>(p.num_tiles) * p.subtiles, (p.n + BN - 1) / BN);
  kernel<<<grid, 128, MMA_SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- The register-operand body: the e4m3 per-tensor forms at m-tiles of
// 64 slots and more (gg_form 3; the design in the note at the top). The
// tile is computed transposed: weight rows on wgmma's 64-row side, A from
// registers, and the block's slots on its N side, B in shared memory.
constexpr int RS_BK = 64;                  // K bytes of a stage: four k16 products
constexpr int RS_MT = 2;                   // 64-row m-tiles of weight rows a consumer warpgroup
constexpr int RS_WROWS = 128 * RS_MT;      // weight rows of a block
constexpr int RS_SLOTS = 128;              // slots of a block at most (wgmma's N), one a producer thread
constexpr int RS_TOK = RS_SLOTS * RS_BK * 2;    // fp16 token rows of a stage, 16 KiB
constexpr int RS_WBOX = RS_WROWS * RS_BK;       // the e4m3 weight box of a stage, 16 KiB
constexpr int RS_LAND_BYTES = RS_SLOTS * RS_BK;  // gathered e4m3 token rows of a stage, 8 KiB
constexpr int RS_STAGE = RS_TOK + RS_WBOX;      // a slot of the ring: token rows, then weights
constexpr int RS_STAGES = 6;  // slots of the ring
constexpr int RS_LSTAGES = 3;  // slots of the landing ring of gathered token rows
constexpr int RS_SMEM = 1024 + RS_STAGES * RS_STAGE + RS_LSTAGES * RS_LAND_BYTES;  // 1024: alignment
constexpr int RS_THREADS = 384;  // two consumer warpgroups, then the producer's
constexpr int RS_CONSUMER_REGS = 224, RS_PRODUCER_REGS = 56;  // 384 x 168 in all
static_assert(RS_STAGE % 1024 == 0, "slots on the 128-byte swizzle's period");

#define GG_OP32(c, d) GG_OP8(c, d, 0), GG_OP8(c, d, 8), GG_OP8(c, d, 16), GG_OP8(c, d, 24)

// One k16 product of a warpgroup, 64 weight rows by N slots: A (fp16, the
// m16n8k16 fragment layout per warp) from registers, B K-major from shared
// memory; float32 sums, accumulate 0 overwrites d.
template <int N>
struct RsMma;
template <>
struct RsMma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : GG_OP32("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct RsMma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t* a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : GG_OP64("+f", d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
// The consumer warpgroups, 128 weight rows each: a thread's four rows of a
// stage (16 bytes each, fp16 in registers), four k16 products of each of
// the warpgroup's two m-tiles over the stage's N token rows, one stage in
// flight while the next is converted; then the sums, scaled and rounded to
// bf16, into out[row0 + slot, c0 + weight row].
template <int N>
__device__ __forceinline__ void rs_consume(const Params& p, uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, const int32_t* s_src, int kt_total,
                                           int group, int c0, int64_t row0) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // this thread's weight rows: w + 64 m and w + 64 m + 8 for each of the warpgroup's m-tiles
  const int w = (tid >> 7) * 64 * RS_MT + ((tid >> 5) & 3) * 16 + gq;
  const uint64_t db = desc_sw128(smem_u32(smem));
  float acc[RS_MT][N / 2];
  uint32_t a0[RS_MT][16], a1[RS_MT][16];  // A of two stages: one in flight, one being converted
#pragma unroll
  for (int m = 0; m < RS_MT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
  auto fence_all = [&](float (&d)[RS_MT][N / 2]) {
#pragma unroll
    for (int m = 0; m < RS_MT; ++m) fence_regs(d[m]);
  };
  auto fence_a = [&](uint32_t (&a)[RS_MT][16]) {
#pragma unroll
    for (int m = 0; m < RS_MT; ++m) fence_regs(a[m]);
  };

  // Stage kt into a (the A operand of wgmma's m64k16 for four k16 steps, an
  // m-tile each): this thread's 16-byte piece tq of its rows. Word j of the
  // piece feeds k16 step j, its low two bytes A's k columns 2 tq and 2 tq +
  // 1, its high two bytes columns 2 tq + 8 and 2 tq + 9, so step j takes K
  // bytes 16 q + 4 j + {0, 1, 2, 3} for q = 0..3; the producer lays the
  // token rows out in the same order.
  auto stage = [&](int kt, uint32_t(&a)[RS_MT][16], uint32_t(&prev)[RS_MT][16]) {
    const int slot = kt % RS_STAGES;
    mbar_wait(smem_u32(&full[slot]), (kt / RS_STAGES) & 1);
    const uint8_t* wb = smem + slot * RS_STAGE + RS_TOK;
#pragma unroll
    for (int m = 0; m < RS_MT; ++m) {
      const uint4 lo = *reinterpret_cast<const uint4*>(wb + (w + 64 * m) * RS_BK + tq * 16);
      const uint4 hi = *reinterpret_cast<const uint4*>(wb + (w + 64 * m + 8) * RS_BK + tq * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t l = word(lo, j), h = word(hi, j);
        a[m][4 * j] = e4m3x2_to_f16x2(l);
        a[m][4 * j + 1] = e4m3x2_to_f16x2(h);
        a[m][4 * j + 2] = e4m3x2_to_f16x2(l >> 16);
        a[m][4 * j + 3] = e4m3x2_to_f16x2(h >> 16);
      }
    }
    fence_all(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int m = 0; m < RS_MT; ++m) {
        RsMma<N>::run(acc[m], a[m] + 4 * j, desc_at(db, slot * RS_STAGE + 32 * j), (kt | j) > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage kt - 1's products are done: its registers and slot are free
    fence_a(prev);
    if (kt > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % RS_STAGES]));
  };
  for (int kt = 0; kt < kt_total; kt += 2) {
    stage(kt, a0, a1);
    if (kt + 1 < kt_total) stage(kt + 1, a1, a0);
  }
  wgmma_wait<0>();
  fence_a(a0);
  fence_a(a1);
  fence_all(acc);

  // register 4c + 2h + e of m-tile m: weight row w + 64 m + 8h, slot 8c + 2 tq + e
  const float scale = p.y_scale[group];
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 8 * c + 2 * tq + e;
      if (s_src[s] < 0) continue;  // an empty slot, or one past the tile
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) + (row0 + s) * p.n;
#pragma unroll
      for (int m = 0; m < RS_MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c0 + w + 64 * m + 8 * h;
          if (col < p.n) orow[col] = __float2bfloat16(__fmul_rn(acc[m][4 * c + 2 * h + e], scale));
        }
      }
    }
  }
}

// The producer warpgroup: thread 0 brings each stage's weight box by TMA;
// thread t gathers token row t of the block by 16-byte cp.async into the
// landing ring, two stages ahead, converts it to fp16 in the order
// rs_consume's fragments take K once the stage's "empty" barrier says the
// consumers are done with the slot, and arrives on its "full" barrier.
__device__ __forceinline__ void rs_produce(const Params& p, const CUtensorMap& wmap, uint8_t* smem,
                                           uint64_t* full, uint64_t* empty, const int32_t* s_src,
                                           int kt_total, int wrow, int rows) {
  const int t = threadIdx.x - 2 * 128, k = p.k;
  // this thread's token row t of the block; null: an empty slot, or one past the block's last
  const int row = t < rows ? s_src[t] : -1;
  const uint8_t* const src = row >= 0 ? p.x + static_cast<int64_t>(row) * k : nullptr;
  uint8_t* const land = smem + RS_STAGES * RS_STAGE;
  // This thread's row of stage kt into landing slot kt % RS_LSTAGES, four 16-byte pieces:
  // piece c of row r lies at r * 64 + (c ^ (r / 2 % 4)) * 16, where the conversion's 16-byte
  // reads of eight consecutive rows hit every bank once. K past k is zero-filled.
  auto gather = [&](int kt) {
    if (kt < kt_total && src != nullptr) {
      const int k0 = kt * RS_BK;
      uint8_t* ls = land + (kt % RS_LSTAGES) * RS_LAND_BYTES;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool kin = k0 + 16 * c < k;
        cp_async16(smem_u32(ls + t * RS_BK + ((c ^ ((t >> 1) & 3)) << 4)), kin ? src + k0 + 16 * c : p.x,
                   kin);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < RS_LSTAGES - 1; ++s) gather(s);

  for (int kt = 0; kt < kt_total; ++kt) {
    const int slot = kt % RS_STAGES;
    gather(kt + RS_LSTAGES - 1);  // into the landing slot this thread emptied last stage
    if (kt >= RS_STAGES) mbar_wait(smem_u32(&empty[slot]), ((kt / RS_STAGES) + 1) & 1);
    if (t == 0) {
      const uint32_t bar = smem_u32(&full[slot]);
      mbar_expect_tx(bar, RS_WBOX);
      tma_load_2d(smem_u32(smem + slot * RS_STAGE + RS_TOK), &wmap, kt * RS_BK, wrow, bar);
    }
    cp_async_wait<RS_LSTAGES - 1>();  // this thread's row of stage kt has landed
    const uint8_t* ls = land + (kt % RS_LSTAGES) * RS_LAND_BYTES;
    uint8_t* ts = smem + slot * RS_STAGE;
    if (src != nullptr) {  // else its column of the products is never stored
      const int r = t;
      uint4 v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = *reinterpret_cast<const uint4*>(ls + r * RS_BK + ((c ^ ((r >> 1) & 3)) << 4));
      }
      // k16 step j's 16 columns: piece q's bytes 4 j, 4 j + 1 at columns 2 q, 2 q + 1 (16-byte
      // chunk 2 j of the row) and bytes 4 j + 2, 4 j + 3 at 2 q + 8, 2 q + 9 (chunk 2 j + 1),
      // chunks in the 128-byte swizzle
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w0 = word(v[0], j), w1 = word(v[1], j), w2 = word(v[2], j), w3 = word(v[3], j);
        const uint4 lo = make_uint4(e4m3x2_to_f16x2(w0), e4m3x2_to_f16x2(w1), e4m3x2_to_f16x2(w2),
                                    e4m3x2_to_f16x2(w3));
        const uint4 hi = make_uint4(e4m3x2_to_f16x2(w0 >> 16), e4m3x2_to_f16x2(w1 >> 16),
                                    e4m3x2_to_f16x2(w2 >> 16), e4m3x2_to_f16x2(w3 >> 16));
        *reinterpret_cast<uint4*>(ts + r * 128 + (((2 * j) ^ (r & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(ts + r * 128 + (((2 * j + 1) ^ (r & 7)) << 4)) = hi;
      }
    }
    fence_proxy_async();  // the fp16 rows, before the consumers' wgmmas read them
    mbar_arrive(smem_u32(&full[slot]));
  }
  cp_async_wait<0>();
}

template <int MODE>
__device__ __forceinline__ void gg_rs_body(const Params& p, const CUtensorMap& wmap) {
  constexpr bool ALIGNED = MODE == kAligned;
  const int tm = p.tm;
  const int tile = blockIdx.x / p.subtiles;
  if (tile >= p.num_valid_tiles[0]) return;
  const int sub = blockIdx.x - tile * p.subtiles;
  const int tid = threadIdx.x;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ int32_t s_src[RS_SLOTS];  // row of x behind each slot of the block, -1: none
  __shared__ int s_end[RS_SLOTS / 32];  // one past the last real slot of each 32
  __shared__ __align__(8) uint64_t s_full[RS_STAGES], s_empty[RS_STAGES];

  // the first row of x and of out behind slot 0 of this block, and its slots inside the tile
  const int64_t row0 = static_cast<int64_t>(ALIGNED ? p.rows[tile] : tile) * tm + sub * RS_SLOTS;
  const int slots = min(RS_SLOTS, tm - sub * RS_SLOTS);
  if (tid < RS_SLOTS) {
    int src = -1;
    if (tid < slots) {
      src = ALIGNED ? static_cast<int>(row0 + tid)
                    : p.rows[static_cast<int64_t>(tile) * tm + sub * RS_SLOTS + tid];
    }
    s_src[tid] = src;
    const unsigned real = __ballot_sync(0xffffffffu, src >= 0);
    if ((tid & 31) == 0) s_end[tid >> 5] = real ? (tid & ~31) + 32 - __clz(real) : 0;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < RS_STAGES; ++s) {
      mbar_init(smem_u32(&s_full[s]), 128 + 1);  // the producer's threads and its byte count
      mbar_init(smem_u32(&s_empty[s]), 8);       // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int end = 0;
#pragma unroll
  for (int i = 0; i < RS_SLOTS / 32; ++i) end = max(end, s_end[i]);
  // wgmma's N: the block's slots up to its last real one, in steps of 64;
  // from lane 0, so that ptxas sees the branch below warp-uniform
  const int chunks = __shfl_sync(0xffffffffu, (end + 63) / 64, 0);
  if (chunks == 0) return;  // no real row: stream no weights

  const int group = p.grp[tile];
  const int c0 = blockIdx.y * RS_WROWS;
  const int kt_total = (p.k + RS_BK - 1) / RS_BK;
  if (tid >= 2 * 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(RS_PRODUCER_REGS));
    rs_produce(p, wmap, smem, s_full, s_empty, s_src, kt_total, group * p.n + c0, chunks * 64);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(RS_CONSUMER_REGS));
    if (chunks == 1) {
      rs_consume<64>(p, smem, s_full, s_empty, s_src, kt_total, group, c0, row0);
    } else {
      rs_consume<128>(p, smem, s_full, s_empty, s_src, kt_total, group, c0, row0);
    }
  }
}

__global__ void __launch_bounds__(RS_THREADS, 1)
    gg_scatter_e4m3_rs_kernel(const Params p, const __grid_constant__ CUtensorMap wmap) {
  gg_rs_body<kScatter>(p, wmap);
}
__global__ void __launch_bounds__(RS_THREADS, 1)
    gg_pertensor_e4m3_rs_kernel(const Params p, const __grid_constant__ CUtensorMap wmap) {
  gg_rs_body<kAligned>(p, wmap);
}

// One kernel name for each form, so that a profile tells them apart.
#define GG_KERNEL(NAME, T, MODE)                                                       \
  template <int WG>                                                                   \
  __global__ void __launch_bounds__(WG * 128, 1)                                      \
      NAME(const Params p, const __grid_constant__ CUtensorMap wmap) {               \
    gg_body<T, MODE, WG>(p, wmap);                                                    \
  }
GG_KERNEL(gg_scatter_i8_kernel, I8, kScatter)
GG_KERNEL(gg_scatter_i8_act_kernel, I8, kScatterAct)
GG_KERNEL(gg_pertensor_i8_kernel, I8, kAligned)
GG_KERNEL(gg_bw_scatter_e4m3_kernel, E4m3, kBwScatter)
GG_KERNEL(gg_bw_scatter_i8_kernel, I8, kBwScatter)
GG_KERNEL(gg_bw_aligned_e4m3_kernel, E4m3, kBwAligned)
GG_KERNEL(gg_bw_aligned_i8_kernel, I8, kBwAligned)
#undef GG_KERNEL

template <typename T, int MODE, int WG>
auto kernel_of() {
  constexpr bool I8_OPS = std::is_same<T, I8>::value;
  if constexpr (MODE == kScatterAct) {
    return gg_scatter_i8_act_kernel<WG>;
  } else if constexpr (MODE == kAligned) {
    static_assert(I8_OPS, "the e4m3 per-tensor forms have bodies of their own");
    return gg_pertensor_i8_kernel<WG>;
  } else if constexpr (MODE == kBwScatter) {
    if constexpr (I8_OPS) return gg_bw_scatter_i8_kernel<WG>;
    else return gg_bw_scatter_e4m3_kernel<WG>;
  } else if constexpr (MODE == kBwAligned) {
    if constexpr (I8_OPS) return gg_bw_aligned_i8_kernel<WG>;
    else return gg_bw_aligned_e4m3_kernel<WG>;
  } else {
    static_assert(I8_OPS, "the e4m3 per-tensor forms have bodies of their own");
    return gg_scatter_i8_kernel<WG>;
  }
}

// The weights [groups, n, k] bytes as a 2D tensor of groups * n rows of k
// bytes, read in boxes of box_rows rows x box_k bytes (the 8-bit wgmma
// body: 64 x 128 in the 128-byte swizzle; the register-operand body: 128 x
// 64, rows 64 bytes apart); out-of-bounds elements arrive as zeros.
int weight_map(CUtensorMap* map, const void* w, int groups, int n, int k, int box_k, int box_rows,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(groups) * static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of an m-tile side by side in x, the blocks of output columns in y.
template <typename T, int MODE, int WG>
int launch(Params p, int groups, cudaStream_t stream) {
  using L = Layout<T, MODE, WG>;
  auto kernel = kernel_of<T, MODE, WG>();
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const int e = weight_map(&map, p.w, groups, p.n, p.k, BK, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  static std::atomic<unsigned long long> configured{0};
  const int c = grant_smem(kernel, L::SMEM, configured);
  if (c != 0) return c;
  p.subtiles = (p.tm + L::BM - 1) / L::BM;
  const int cols = MODE == kScatterAct ? p.n / 2 : p.n;
  const int per_block = MODE == kScatterAct ? BN / 2 : BN;
  const dim3 grid(static_cast<unsigned>(p.num_tiles) * p.subtiles, (cols + per_block - 1) / per_block);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(p, map);
  return static_cast<int>(cudaGetLastError());
}

// The register-operand body: blocks of 128 weight rows by 256 slots of an
// m-tile side by side in x, the blocks of output columns in y.
template <int MODE>
int launch_rs(Params p, int groups, cudaStream_t stream) {
  auto kernel = MODE == kAligned ? gg_pertensor_e4m3_rs_kernel : gg_scatter_e4m3_rs_kernel;
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const int e = weight_map(&map, p.w, groups, p.n, p.k, RS_BK, RS_WROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  static std::atomic<unsigned long long> configured{0};
  const int c = grant_smem(kernel, RS_SMEM, configured);
  if (c != 0) return c;
  p.subtiles = (p.tm + RS_SLOTS - 1) / RS_SLOTS;
  const dim3 grid(static_cast<unsigned>(p.num_tiles) * p.subtiles, (p.n + RS_WROWS - 1) / RS_WROWS);
  kernel<<<grid, RS_THREADS, RS_SMEM, stream>>>(p, map);
  return static_cast<int>(cudaGetLastError());
}

// wg (ops/group_gemm.py:gg_form): the e4m3 per-tensor forms take 0, the
// mma.sync body (32-row blocks), or 3, the register-operand body; the
// others take the 8-bit wgmma body with 1 consumer warpgroup a block (64
// rows), or 2 (the int8 per-tensor forms).
template <typename T, int MODE>
int dispatch(const Params& a, int groups, int wg, void* stream) {
  if (a.num_tiles == 0 || a.n == 0) return 0;
  const int cols = MODE == kScatterAct ? a.n / 2 : a.n;
  if (a.tm < 1 || a.k < 16 || a.k % 16 != 0 || a.n % 2 != 0 || (cols + 63) / 64 > 65535 ||
      groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (MODE == kScatterAct && (a.pair < 64 || a.pair % 64 != 0 || a.n % (2 * a.pair) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bw(MODE) && (a.k % BK != 0 || a.n % BN != 0 || a.sx_stride < a.k / BK ||
                      a.sw_stride < a.k / BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (pertensor_e4m3<T, MODE>()) {
    if (wg == 0) return launch_mma<MODE>(a, s);
    if (wg == 3) return launch_rs<MODE>(a, groups, s);
  } else {
    if (wg == 1) return launch<T, MODE, 1>(a, groups, s);
    if constexpr (!promotes<T, MODE>()) {
      if (wg == 2) return launch<T, MODE, 2>(a, groups, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Params params(const void* x, const void* w, const void* y_scale, const void* act_scale,
              const void* rows, const void* grp, const void* num_valid_tiles, void* out,
              int num_tiles, int tm, int n, int k, int pair, int bf16_mul) {
  return Params{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
                static_cast<const float*>(y_scale), static_cast<const float*>(act_scale),
                static_cast<const int32_t*>(rows), static_cast<const int32_t*>(grp),
                static_cast<const int32_t*>(num_valid_tiles), out, num_tiles, tm, 0, n, k,
                pair, bf16_mul};
}

}  // namespace

// Every launcher ends in (groups, wg): the groups of w, and the body and
// block (ops/group_gemm.py:gg_form). The e4m3 per-tensor forms: 0, the
// mma.sync body (32-row blocks), or 3, the register-operand body (128
// weight rows by 256 slots). The others: the 8-bit wgmma body with 1 (64
// rows a block) or, the int8 per-tensor forms, 2 consumer warpgroups (128).
//
// x [rows_x, k] e4m3, w [groups, n, k] e4m3, y_scale [groups] f32,
// row_idx [num_tiles * tm] i32, grp [num_tiles] i32, num_valid_tiles [1] i32,
// out [num_tiles * tm, n] bf16; all contiguous, k a multiple of 16, n even.
extern "C" int hpc_gg_scatter_e4m3(const void* x, const void* w, const void* y_scale,
                                   const void* row_idx, const void* grp,
                                   const void* num_valid_tiles, void* out, int num_tiles, int tm,
                                   int n, int k, void* stream, int groups, int wg) {
  return dispatch<E4m3, kScatter>(params(x, w, y_scale, nullptr, row_idx, grp, num_valid_tiles,
                                         out, num_tiles, tm, n, k, 0, 0),
                                  groups, wg, stream);
}

// The same over int8 x and w.
extern "C" int hpc_gg_scatter_i8(const void* x, const void* w, const void* y_scale,
                                 const void* row_idx, const void* grp, const void* num_valid_tiles,
                                 void* out, int num_tiles, int tm, int n, int k, void* stream,
                                 int groups, int wg) {
  return dispatch<I8, kScatter>(params(x, w, y_scale, nullptr, row_idx, grp, num_valid_tiles, out,
                                       num_tiles, tm, n, k, 0, 0),
                                groups, wg, stream);
}

// int8 x and interleaved w [groups, n, k] (pairs of `pair` gate rows and
// `pair` up rows), act_scale [1] f32, out [(num_tiles + 1) * tm, n / 2] int8
// codes (rows past num_tiles * tm and of empty slots are not written);
// pair a multiple of 64 dividing n / 2; bf16_mul: round silu(gate) to bf16
// and multiply by up as a bf16 product.
extern "C" int hpc_gg_scatter_i8_act(const void* x, const void* w, const void* y_scale,
                                     const void* act_scale, const void* row_idx, const void* grp,
                                     const void* num_valid_tiles, void* out, int num_tiles, int tm,
                                     int n, int k, int pair, int bf16_mul, void* stream, int groups,
                                     int wg) {
  return dispatch<I8, kScatterAct>(params(x, w, y_scale, act_scale, row_idx, grp, num_valid_tiles,
                                          out, num_tiles, tm, n, k, pair, bf16_mul),
                                   groups, wg, stream);
}

// x_al [rows, k] and w [groups, n, k], both int8 (elem 0) or both e4m3
// (elem 1), y_scale [groups] f32, grp and row_blk [num_tiles] i32,
// num_valid_tiles [1] i32, out [rows, n] bf16: tile t < num_valid_tiles[0]
// reads and writes rows row_blk[t] * tm .. + tm - 1, which must lie in x_al.
extern "C" int hpc_gg_pertensor(const void* x, const void* w, const void* y_scale, const void* grp,
                                const void* row_blk, const void* num_valid_tiles, void* out,
                                int num_tiles, int tm, int n, int k, int elem, void* stream,
                                int groups, int wg) {
  const Params a = params(x, w, y_scale, nullptr, row_blk, grp, num_valid_tiles, out, num_tiles,
                          tm, n, k, 0, 0);
  if (elem == 0) return dispatch<I8, kAligned>(a, groups, wg, stream);
  if (elem == 1) return dispatch<E4m3, kAligned>(a, groups, wg, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blockwise scales: x [rows_x, k] and w [groups, n, k], both int8 (_i8)
// or both e4m3 (_e4m3), sx [rows_x, sx_stride] f32 (column kg: the scale of
// group kg of that row), sw [groups, n / 128, sw_stride] f32 (one scale per
// 128 x 128 block), grp [num_tiles] i32, num_valid_tiles [1] i32; k and n
// multiples of 128, both strides at least k / 128.
// Scatter: rows = row_idx [num_tiles * tm] i32, out [num_tiles * tm, n] bf16.
// Aligned: rows = row_blk [num_tiles] i32, out [rows_x, n] bf16; tile t <
// num_valid_tiles[0] reads and writes rows row_blk[t] * tm .. + tm - 1 of x,
// sx and out, which must lie in x.
namespace {
template <typename T, int MODE>
int launch_bw(const void* x, const void* w, const void* sx, const void* sw, const void* rows,
              const void* grp, const void* num_valid_tiles, void* out, int num_tiles, int tm,
              int n, int k, int sx_stride, int sw_stride, void* stream, int groups, int wg) {
  Params a = params(x, w, nullptr, nullptr, rows, grp, num_valid_tiles, out, num_tiles, tm, n, k,
                    0, 0);
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(sw);
  a.sx_stride = sx_stride;
  a.sw_stride = sw_stride;
  return dispatch<T, MODE>(a, groups, wg, stream);
}
}  // namespace

#define GG_BW_LAUNCHER(NAME, T, MODE)                                                            \
  extern "C" int NAME(const void* x, const void* w, const void* sx, const void* sw,             \
                      const void* rows, const void* grp, const void* num_valid_tiles, void* out, \
                      int num_tiles, int tm, int n, int k, int sx_stride, int sw_stride,         \
                      void* stream, int groups, int wg) {                                        \
    return launch_bw<T, MODE>(x, w, sx, sw, rows, grp, num_valid_tiles, out, num_tiles, tm, n, k, \
                              sx_stride, sw_stride, stream, groups, wg);                         \
  }
GG_BW_LAUNCHER(hpc_gg_bw_scatter_i8, I8, kBwScatter)
GG_BW_LAUNCHER(hpc_gg_bw_scatter_e4m3, E4m3, kBwScatter)
GG_BW_LAUNCHER(hpc_gg_bw_aligned_i8, I8, kBwAligned)
GG_BW_LAUNCHER(hpc_gg_bw_aligned_e4m3, E4m3, kBwAligned)
#undef GG_BW_LAUNCHER
