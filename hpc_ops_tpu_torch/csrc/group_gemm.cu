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
// is 0.486 ms of work at the 8-bit tensor-core rate of an H100 against 0.16
// ms of bytes).
//
// Design. Products on Hopper's tensor cores by wgmma.mma_async m64n128, A
// (rows of x) and B (weight rows) K-major in shared memory in the 128-byte
// swizzle: .s32.s8.s8 (k32) for int8 and .f32.e4m3.e4m3 (k32) for the
// blockwise e4m3 forms; the per-tensor e4m3 forms convert each stage to fp16
// in shared memory (exact) and run .f32.f16.f16 (k16), for precision (below).
// A block takes 64 rows of one m-tile for each of its WG consumer
// warpgroups by 128 weight rows: 128 output columns, or with the act
// epilogue the 64 gate rows and the 64 matching up rows of 64 output
// columns. WG is 2 for the per-tensor forms at m-tiles of 128 slots or
// more, else 1 (the wrapper's choice: ops/group_gemm.py:gg_form). K walks
// 128-byte stages through a ring in shared memory; a stage is one row of
// the 128-byte swizzle, four k32 products and one blockwise scale group.
// The ring holds 4 stages of 24 KiB at WG 1 and 3 of 32 KiB at WG 2, so two
// blocks share an SM either way (the int8 per-tensor forms hold 95
// registers a thread, the blockwise ones 255 at 128 threads) and one block's
// barrier, promotion and epilogue overlap the other's products; the fp16
// forms hold 2 stages and the fp16 copy of one (48 KiB at WG 1, 64 at WG 2;
// 109 registers). On an H100 at 2048 tokens (scripts/time_gg_scatter.py,
// time_gg_bw.py) the per-tensor forms ran 6-30% faster at WG 2 than at WG 1,
// and the blockwise forms 9-35% faster at WG 1 than in one block of two
// warpgroups and 5 stages an SM, which their registers force.
//  - Weights by TMA: a 2D tensor map over w viewed as [groups * n, k] bytes,
//    two boxes of 64 rows x 128 bytes a stage in the 128-byte swizzle,
//    issued by thread 0 and completing on the slot's mbarrier. K past
//    k and rows past the weight's end arrive as zeros; rows past n inside w
//    are the next group's and feed only columns that are never stored. The
//    map is encoded on the host for each call (cuTensorMapEncodeTiled
//    through cudaGetDriverEntryPoint: the library is not linked against
//    libcuda) and passed as a __grid_constant__ parameter. Against a
//    cp.async ring for the weights it was 7-22% faster at every shape
//    measured (scripts/time_gg_scatter.py on an H100).
//  - Rows of x by 16-byte cp.async, each warpgroup its own 64 rows, fetched
//    by their index into the same swizzled layout (TMA cannot gather rows);
//    empty slots, rows past the tile and K past k are zero-filled by
//    cp.async's src-size 0.
//  - One loop for every thread: wait for stage kt (this thread's cp.async
//    groups, the slot's mbarrier), one __syncthreads, (fp16 forms: convert
//    the stage, a second __syncthreads, its slot is free) issue stage kt's
//    products, refill a free slot while they run, then wait for them and
//    promote. (A pipeline per warpgroup, named barriers and an "empty"
//    mbarrier a slot in place of the __syncthreads, measured 13-19% slower
//    at 2048 tokens.)
//  - Precision: Hopper's fp8 wgmma sums into a narrower accumulator (about
//    14 bits, DeepSeek-V3's report). Even with each 128-K stage promoted
//    into float32, 5.4-6.9% of the bf16 outputs of an e4m3 per-tensor GEMM
//    landed a step off the plain version's on an H100 at K 256 to 14336;
//    behind the MoE's e4m3 activation codes that moved the fp8 MoE card
//    test 0.015 past its bar of 0.02 + 2%. Over fp16 copies the share is
//    0-0.03% and the MoE matches its CPU run at 32 and 512 tokens
//    (scripts/gg_precision.py), for 2-2.3x the fp8 body's time at 512-2048
//    tokens. The blockwise e4m3 forms keep fp8 products with each stage's
//    partial promoted, acc + (partial * sx) * sw (DeepGEMM's structure;
//    their plain version promotes the same groups). int8 sums are exact in
//    s32 (14336 * 127^2 < 2^31): the per-tensor int8 forms sum all of K in
//    s32 and convert once, the blockwise ones promote each stage as the
//    plain version does, so both stay bit-equal to it.
//  - A warpgroup whose 64 rows hold no real row skips its products as a
//    whole; its predicate is broadcast from lane 0 so that ptxas sees it
//    warp-uniform (a wgmma on a divergent path serialises every wgmma of
//    the kernel, advisory C7520). A block with no real row returns before
//    it streams any weight.
//  - The act epilogue: gate column c and up column c + 64 of a block are
//    accumulator registers 4j + i and 4(j + 8) + i of one thread, so no
//    exchange through shared memory is needed. Its arithmetic is that of
//    csrc/activation.cu (expf, an IEEE division, __fmul_rn, rintf; no
//    contraction into FMA), so the codes equal the plain version's.
//  - Registers: 64 float32 or s32 sums a thread, and 64 promoted sums in
//    the blockwise forms.
//  - The e4m3 per-tensor forms at decode m-tiles (32 slots) take a second
//    body, mma.sync over the same exact fp16 values (wg 0; its note below).
//    On an H100 at 8 tokens it ran the gate-up GEMM in 0.330 ms against the
//    fp16 wgmma body's 0.375, whose conversions fall behind the weights'
//    stream there; at 200 tokens (m-tiles of 64) 0.829 against 0.435.
//  - The blocks of one m-tile sit side by side in the grid's fast
//    dimension, and the tiles of one group are consecutive, so the blocks
//    that share a weight panel run together and it is read from device
//    memory about once. (Groups of row blocks whose rows of x fit 16 MiB of
//    L2, each sweeping all column blocks, measured no faster at 2048 tokens
//    on an H100: chip_smoke.py, the down GEMM 0.99 ms both ways.)
// Known limits: no warp specialisation, no TMA multicast across a cluster
// (a 64-row block brings 24 KiB from L2 for every 2.1 M operations, a
// 128-row one 32 KiB for 4.2 M), no persistent grid (every block pays its
// prologue and epilogue), and each stage waits for its own products before
// the next is issued, so only the SM's other block keeps the tensor cores
// busy through a barrier, a promotion or an epilogue. The fp16 forms
// convert each stage before its products, one block an SM at WG 2: a
// 128-row stage writes 64 KiB of fp16 and its products read 96 KiB of
// shared memory for 4.2 M operations, so shared memory, not the fp16 rate,
// bounds them (A from registers, converted there, would halve it).

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

// a float32 accumulator beside the tensor cores' per-stage partials
template <typename T, int MODE>
__host__ __device__ constexpr bool promotes() {
  return is_bw(MODE);
}
// e4m3 operands multiplied as fp16 (the per-tensor forms): each stage is
// converted in shared memory and fed to the 16-bit wgmma
template <typename T, int MODE>
__host__ __device__ constexpr bool via_f16() {
  return std::is_same<T, E4m3>::value && !is_bw(MODE);
}
template <typename T, int MODE, int WG>
struct Layout {
  static constexpr bool F16 = via_f16<T, MODE>();
  static constexpr int BM = 64 * WG;  // rows of a block, 64 a consumer warpgroup
  static constexpr int THREADS = 128 * WG;
  static constexpr int STAGES = F16 ? 2 : WG == 1 ? 4 : 3;
  // stages loaded ahead of the one in use: a converted stage frees its slot at once
  static constexpr int AHEAD = F16 ? STAGES : STAGES - 1;
  static_assert(WG == 1 || !promotes<T, MODE>(), "blocks of two warpgroups sum in float32 only");
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE = A_BYTES + BN * BK;  // a multiple of 1024: the swizzle's period
  // the fp16 copy of a stage: two K halves of 64 elements, each STAGE bytes
  static constexpr int SMEM = 1024 + STAGES * STAGE + (F16 ? 2 * STAGE : 0);  // 1024: alignment
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
// writes across the fence, commit and wait.
template <typename A>
__device__ __forceinline__ void fence_acc(A (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
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
// One k16 product over fp16 operands, float32 sums.
__device__ __forceinline__ void wgmma_k16_f16(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " GG_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GG_OP64("+f", d)
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
  constexpr int BM = L::BM, STAGES = L::STAGES, AHEAD = L::AHEAD;
  constexpr bool ACT = MODE == kScatterAct;
  constexpr bool ALIGNED = MODE == kAligned || MODE == kBwAligned;
  constexpr bool BW = is_bw(MODE);
  constexpr bool PROMOTE = promotes<T, MODE>();
  constexpr bool F16 = L::F16;
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
  // All threads: a slot's e4m3 rows (x, then the weight's), chunk j of row
  // r at r * 128 + (j ^ (r & 7)) * 16, into the fp16 copy: K elements 0-63
  // and 64-127 in two halves of the same layout, 128 bytes a row each.
  auto to_f16 = [&](int slot) {
    const uint8_t* src = smem + slot * L::STAGE;
    uint8_t* const cvt = smem + STAGES * L::STAGE;
#pragma unroll
    for (int i = 0; i < (BM + BN) * 8 / L::THREADS; ++i) {
      const int c = tid + i * L::THREADS;
      const int r = c >> 3, jc = c & 7, sw = r & 7, h0 = (jc & 3) * 2;
      const uint4 v = *reinterpret_cast<const uint4*>(src + r * 128 + ((jc ^ sw) << 4));
      uint8_t* d = cvt + (jc >> 2) * L::STAGE + r * 128;
      const uint4 lo = make_uint4(e4m3x2_to_f16x2(v.x), e4m3x2_to_f16x2(v.x >> 16),
                                  e4m3x2_to_f16x2(v.y), e4m3x2_to_f16x2(v.y >> 16));
      const uint4 hi = make_uint4(e4m3x2_to_f16x2(v.z), e4m3x2_to_f16x2(v.z >> 16),
                                  e4m3x2_to_f16x2(v.w), e4m3x2_to_f16x2(v.w >> 16));
      *reinterpret_cast<uint4*>(d + ((h0 ^ sw) << 4)) = lo;
      *reinterpret_cast<uint4*>(d + (((h0 + 1) ^ sw) << 4)) = hi;
    }
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
    if constexpr (F16) {
      to_f16(slot);
      fence_proxy_async();
      __syncthreads();  // the fp16 copy of stage kt is whole; its slot is free
    }
    float sxa = 0.f, sxb = 0.f, swv = 0.f;
    if (live) {
      if constexpr (BW) {  // stage kt is scale group kt; read while the products run
        if (src_a >= 0) sxa = p.sx[static_cast<int64_t>(src_a) * p.sx_stride + kt];
        if (src_b >= 0) sxb = p.sx[static_cast<int64_t>(src_b) * p.sx_stride + kt];
        swv = p.sw[(static_cast<int64_t>(group) * (n / BN) + blockIdx.y) * p.sw_stride + kt];
      }
      fence_acc(part);
      wgmma_fence();
      if constexpr (F16) {  // eight k16 steps, four in each K half of the copy
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const uint32_t off = STAGES * L::STAGE + (ks >> 2) * L::STAGE + (ks & 3) * 32;
          wgmma_k16_f16(part, desc_at(da, off), desc_at(db, off), (kt | ks) > 0);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t off = slot * L::STAGE + ks * 32;
          wgmma_k32(part, desc_at(da, off), desc_at(db, off), PROMOTE ? ks > 0 : (kt | ks) > 0);
        }
      }
      wgmma_commit();
    }
    // into the slot stage kt - 1 has freed, or (fp16 copy) the one stage kt has
    refill((kt + AHEAD) % STAGES, kt + AHEAD);
    if (live) {
      wgmma_wait<0>();
      fence_acc(part);
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
// multiplied with mma.sync.m16n8k16 into float32, as the wgmma body's fp16
// copies are. A block takes 32 rows of an m-tile by 128 weight rows, 4
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

template <int MODE>
int launch_mma(Params p, cudaStream_t stream) {
  auto kernel = MODE == kAligned ? gg_pertensor_e4m3_mma_kernel : gg_scatter_e4m3_mma_kernel;
  // more than 48 KB of dynamic shared memory: an attribute of each device
  static std::atomic<unsigned long long> configured{0};  // a bit a device
  int dev = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return static_cast<int>(c);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if ((configured.load(std::memory_order_relaxed) & bit) == 0 || bit == 0) {
    c = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (c != cudaSuccess) return static_cast<int>(c);
    configured.fetch_or(bit, std::memory_order_relaxed);
  }
  p.subtiles = (p.tm + MMA_BM - 1) / MMA_BM;
  const dim3 grid(static_cast<unsigned>(p.num_tiles) * p.subtiles, (p.n + BN - 1) / BN);
  kernel<<<grid, 128, MMA_SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One kernel name for each form, so that a profile tells them apart.
#define GG_KERNEL(NAME, T, MODE)                                                       \
  template <int WG>                                                                   \
  __global__ void __launch_bounds__(WG * 128, 1)                                      \
      NAME(const Params p, const __grid_constant__ CUtensorMap wmap) {               \
    gg_body<T, MODE, WG>(p, wmap);                                                    \
  }
GG_KERNEL(gg_scatter_e4m3_kernel, E4m3, kScatter)
GG_KERNEL(gg_scatter_i8_kernel, I8, kScatter)
GG_KERNEL(gg_scatter_i8_act_kernel, I8, kScatterAct)
GG_KERNEL(gg_pertensor_e4m3_kernel, E4m3, kAligned)
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
    if constexpr (I8_OPS) return gg_pertensor_i8_kernel<WG>;
    else return gg_pertensor_e4m3_kernel<WG>;
  } else if constexpr (MODE == kBwScatter) {
    if constexpr (I8_OPS) return gg_bw_scatter_i8_kernel<WG>;
    else return gg_bw_scatter_e4m3_kernel<WG>;
  } else if constexpr (MODE == kBwAligned) {
    if constexpr (I8_OPS) return gg_bw_aligned_i8_kernel<WG>;
    else return gg_bw_aligned_e4m3_kernel<WG>;
  } else {
    if constexpr (I8_OPS) return gg_scatter_i8_kernel<WG>;
    else return gg_scatter_e4m3_kernel<WG>;
  }
}

// The weights [groups, n, k] bytes as a 2D tensor of groups * n rows of k
// bytes, read in boxes of 64 rows x 128 bytes in the 128-byte swizzle;
// out-of-bounds elements arrive as zeros.
int weight_map(CUtensorMap* map, const void* w, int groups, int n, int k) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(groups) * static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {BK, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
  const int e = weight_map(&map, p.w, groups, p.n, p.k);
  if (e != 0) return e;
  // more than 48 KB of dynamic shared memory: an attribute of each device
  static std::atomic<unsigned long long> configured{0};  // a bit a device
  int dev = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return static_cast<int>(c);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if ((configured.load(std::memory_order_relaxed) & bit) == 0 || bit == 0) {
    c = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (c != cudaSuccess) return static_cast<int>(c);
    configured.fetch_or(bit, std::memory_order_relaxed);
  }
  p.subtiles = (p.tm + L::BM - 1) / L::BM;
  const int cols = MODE == kScatterAct ? p.n / 2 : p.n;
  const int per_block = MODE == kScatterAct ? BN / 2 : BN;
  const dim3 grid(static_cast<unsigned>(p.num_tiles) * p.subtiles, (cols + per_block - 1) / per_block);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(p, map);
  return static_cast<int>(cudaGetLastError());
}

// wg: consumer warpgroups a block (64 rows each), 1, or 2 for the
// per-tensor forms; 0 takes the mma.sync body (32-row blocks), which only
// the e4m3 per-tensor forms have.
template <typename T, int MODE>
int dispatch(const Params& a, int groups, int wg, void* stream) {
  if (a.num_tiles == 0 || a.n == 0) return 0;
  const int cols = MODE == kScatterAct ? a.n / 2 : a.n;
  if (a.tm < 1 || a.k < 16 || a.k % 16 != 0 || a.n % 2 != 0 || (cols + 63) / 64 > 65535 ||
      groups < 1 || wg < 0 || wg > 2) {
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
  if (wg == 0) {  // the mma.sync body: the e4m3 per-tensor forms only
    if constexpr (std::is_same<T, E4m3>::value && (MODE == kScatter || MODE == kAligned)) {
      return launch_mma<MODE>(a, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (wg == 2) {  // the int8 per-tensor forms only
    if constexpr (!promotes<T, MODE>()) {
      return launch<T, MODE, 2>(a, groups, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch<T, MODE, 1>(a, groups, s);
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

// Every launcher ends in (groups, wg): the groups of w, and the consumer
// warpgroups of a block (1: 64 rows; 2: 128 rows, the per-tensor forms; 0:
// the mma.sync body of the e4m3 per-tensor forms, 32 rows).
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
