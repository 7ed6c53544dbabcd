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
// every expert's whole weight is streamed for almost no arithmetic),
// operations at prefill shapes (hundreds of rows per expert).
//
// Design: a block computes BM rows of one m-tile by 128 weight rows (128
// output columns, or 64 with the act epilogue). The K loop walks 128-byte
// stages through a cp.async ring in shared memory (3 or 4 stages: enough
// bytes in flight to cover the memory latency when the kernel only streams
// weights). Rows of x are fetched by their index straight into the ring, 16
// bytes a thread; empty slots and ragged edges are zero-filled by cp.async
// itself. A stage is stored as two [rows][64] byte planes, so a lane's
// shared-memory reads are conflict-free 16-byte loads of one row:
// - e4m3 stays e4m3 in shared memory; a warp converts its fragments to fp16
//   in registers (cvt.rn.f16x2.e4m3x2: every e4m3 value, subnormals
//   included, is exact in fp16) and multiplies with mma.sync.m16n8k16 into
//   float32, so each product is exact and only the order of the sum differs
//   from a float32 reference. A lane's 16-byte piece holds its operands of
//   four consecutive k16 steps (bytes 4j..4j+3 for step j).
// - int8 goes to mma.sync.m16n8k32.s8 as it is, with int32 sums: exact. A
//   k32 fragment wants 8 bytes of a row from each lane (two 4-byte words,
//   logical k 4q..4q+3 and 16+4q..16+4q+3 for lane q of its quad), so a
//   lane's 16-byte piece holds two k32 steps: words 2s and 2s+1 for step s.
// Either way k is permuted inside a stage the same way for A and for B,
// which a dot product does not see.
// Blockwise forms: a stage also carries its BM x scales and its block's w
// scale (4-byte cp.asyncs into the same ring slot), the MMA partials of a
// stage go into a fresh accumulator (int32 sums of a 128-group stay below
// 128 * 127^2 < 2^24, so the conversion to float32 is exact) and are
// promoted into a second, float32 accumulator. Two accumulator sets cost
// registers, so these forms use the 32- and 64-row blocks only (MI = 2),
// held to two blocks an SM where that spills nothing.
// The act epilogue: a block's 128 weight rows are 64 gate rows and the 64
// matching up rows; warp column w takes gate rows 16w..16w+15 as its
// fragments 0 and 1 and the up rows 64+16w.. as fragments 2 and 3, so a
// thread holds gate and up of the same output columns in fragments ni and
// ni + 2 and the epilogue needs no exchange through shared memory. Its
// arithmetic is that of csrc/activation.cu (expf, an IEEE division,
// __fmul_rn, rintf; no contraction into FMA), so the codes equal the plain
// version's.
// 16-row groups of a block that hold no real row are skipped, so a decode
// tile of 32 slots with two real rows pays for 16 (in the scatter gate-up
// GEMMs; the down GEMMs compute every row of a valid tile). Blocks of one
// m-tile sit side by side in the grid's fast dimension, so the blocks that
// share a weight panel run together and it is read from device memory about
// once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 128;   // weight rows of a block
constexpr int BK = 128;   // K elements (bytes) of a stage
constexpr int PLANE = 64; // bytes of a row in one plane of a stage

enum Mode { kScatter = 0, kScatterAct = 1, kAligned = 2, kBwScatter = 3, kBwAligned = 4 };
__host__ __device__ constexpr bool is_bw(int mode) {
  return mode == kBwScatter || mode == kBwAligned;
}
// Bytes of one ring slot: the x rows and weight rows of a stage and, in the
// blockwise forms, the stage's BM x scales and its block's w scale (padded
// to 16 bytes).
template <int MODE, int BM>
__host__ __device__ constexpr int stage_bytes() {
  return (BM + BN) * BK + (is_bw(MODE) ? BM * 4 + 16 : 0);
}
struct E4m3 {};
struct I8 {};
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<I8> { using type = int; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;  // 0: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two e4m3 bytes -> two fp16 values in one register.
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t two_bytes) {
  uint32_t out;
  const unsigned short in = static_cast<unsigned short>(two_bytes);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(out) : "h"(in));
  return out;
}

__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

// The products of one 64-byte plane of a stage: four k16 steps (e4m3) ...
template <int MI, int NI>
__device__ __forceinline__ void plane_mma(E4m3, float (&acc)[MI][NI][4], const uint4 (&a_lo)[MI],
                                          const uint4 (&a_hi)[MI], const uint4 (&b)[NI],
                                          const bool (&live)[MI]) {
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
      const uint32_t lo = word(a_lo[mi], j);
      const uint32_t hi = word(a_hi[mi], j);
      const uint32_t af[4] = {e4m3x2_to_f16x2(lo), e4m3x2_to_f16x2(hi),
                              e4m3x2_to_f16x2(lo >> 16), e4m3x2_to_f16x2(hi >> 16)};
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_f16(acc[mi][ni], af, bf[ni]);
    }
  }
}

// ... or two k32 steps (int8).
template <int MI, int NI>
__device__ __forceinline__ void plane_mma(I8, int (&acc)[MI][NI][4], const uint4 (&a_lo)[MI],
                                          const uint4 (&a_hi)[MI], const uint4 (&b)[NI],
                                          const bool (&live)[MI]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t bf[NI][2];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      bf[ni][0] = word(b[ni], 2 * s);
      bf[ni][1] = word(b[ni], 2 * s + 1);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!live[mi]) continue;
      const uint32_t af[4] = {word(a_lo[mi], 2 * s), word(a_hi[mi], 2 * s),
                              word(a_lo[mi], 2 * s + 1), word(a_hi[mi], 2 * s + 1)};
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af, bf[ni]);
    }
  }
}

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

// BM rows by BN weight rows a block, WARPS_M x 4 warps, each (BM / WARPS_M) x 32.
template <typename T, int MODE, int BM, int WARPS_M, int STAGES>
__device__ __forceinline__ void gg_body(const Params& p) {
  const uint8_t* __restrict__ x = p.x;
  const uint8_t* __restrict__ w = p.w;
  const int32_t* __restrict__ rows = p.rows;
  const int tm = p.tm, n = p.n, k = p.k, pair = p.pair;
  using Acc = typename AccOf<T>::type;
  constexpr int THREADS = WARPS_M * 4 * 32;
  constexpr int WM = BM / WARPS_M;
  constexpr int MI = WM / 16;
  constexpr int NI = 4;
  constexpr int A_BYTES = BM * BK;
  constexpr int STAGE_BYTES = stage_bytes<MODE, BM>();
  constexpr bool ACT = MODE == kScatterAct;
  constexpr bool ALIGNED = MODE == kAligned || MODE == kBwAligned;
  constexpr bool BW = is_bw(MODE);

  const int tile = blockIdx.x / p.subtiles;
  if (tile >= p.num_valid_tiles[0]) return;
  const int sub = blockIdx.x - tile * p.subtiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp / 4) * WM;
  const int wn = warp % 4;
  const int gq = lane >> 2;  // fragment row (A, C) or column (B)
  const int tq = lane & 3;

  // The block's weight rows: BN from n0 on, or (act) 64 gate rows from g0 on
  // and the 64 up rows from g0 + pair on, for output columns c0 .. c0 + 63.
  const int c0 = blockIdx.y * (ACT ? BN / 2 : BN);
  const int n0 = c0;
  const int g0 = ACT ? (c0 / pair) * 2 * pair + c0 % pair : 0;
  // the first row of x and of out behind row 0 of this block
  const int64_t row0 =
      static_cast<int64_t>(ALIGNED ? rows[tile] : tile) * tm + sub * BM;

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_src[BM];  // row of x behind each row of the block, -1: none

  int mine_real = 0;
  for (int r = tid; r < BM; r += THREADS) {
    const int in_tile = sub * BM + r;
    int src = -1;
    if (in_tile < tm) {
      src = ALIGNED ? static_cast<int>(row0 + r)
                             : rows[static_cast<int64_t>(tile) * tm + in_tile];
    }
    s_src[r] = src;
    mine_real |= src >= 0;
  }
  if (!__syncthreads_or(mine_real)) return;  // no real row: stream no weights

  bool live[MI];  // does this 16-row group of the warp hold any real row
  bool any_live = false;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const bool mine = lane < 16 && s_src[wm0 + mi * 16 + lane] >= 0;
    live[mi] = __ballot_sync(0xffffffffu, mine) != 0;
    any_live |= live[mi];
  }

  const int group = p.grp[tile];
  const uint8_t* wg = w + static_cast<int64_t>(group) * n * k;
  const int kt_total = (k + BK - 1) / BK;

  // Piece c of a [2][rows][64] stage lies at byte 16 * c: plane c / (4 rows),
  // row (c / 4) % rows, 16-byte quarter c % 4.
  auto load_stage = [&](int slot, int kt) {
    uint8_t* sa = smem + slot * STAGE_BYTES;
    uint8_t* sb = sa + A_BYTES;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * 8; c += THREADS) {
      const int plane = c / (BM * 4);
      const int rem = c - plane * (BM * 4);
      const int kk = k0 + plane * PLANE + (rem & 3) * 16;
      const int src = s_src[rem >> 2];
      const bool ok = src >= 0 && kk < k;
      cp_async16(sa + c * 16, ok ? x + static_cast<int64_t>(src) * k + kk : x, ok);
    }
    for (int c = tid; c < BN * 8; c += THREADS) {
      const int plane = c / (BN * 4);
      const int rem = c - plane * (BN * 4);
      const int kk = k0 + plane * PLANE + (rem & 3) * 16;
      const int r = rem >> 2;
      const int wrow = ACT ? (r < BN / 2 ? g0 + r : g0 + pair + r - BN / 2) : n0 + r;
      const bool ok = wrow < n && kk < k;
      cp_async16(sb + c * 16, ok ? wg + static_cast<int64_t>(wrow) * k + kk : wg, ok);
    }
    if constexpr (BW) {  // stage kt is scale group kt: BM x scales, then the w scale
      float* ss = reinterpret_cast<float*>(sb + BN * BK);
      for (int r = tid; r < BM; r += THREADS) {
        const int src = s_src[r];
        cp_async4(ss + r, src >= 0 ? p.sx + static_cast<int64_t>(src) * p.sx_stride + kt : p.sx,
                  src >= 0);
      }
      if (tid == 0) {
        cp_async4(ss + BM,
                  p.sw + (static_cast<int64_t>(group) * (n / BN) + blockIdx.y) * p.sw_stride + kt,
                  true);
      }
    }
  };

  // the block's B row of fragment ni of this warp
  int b_row[NI];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    b_row[ni] = ACT ? (ni >> 1) * (BN / 2) + wn * 16 + (ni & 1) * 8 + gq : wn * 32 + ni * 8 + gq;
  }

  // the MMA accumulators; in the blockwise forms one stage's partials, which
  // are promoted into bw after each stage
  Acc acc[MI][NI][4];
  float bw[BW ? MI : 1][BW ? NI : 1][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mi][ni][i] = 0;
        if constexpr (BW) bw[mi][ni][i] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_total) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 has been read by all
    const int next = kt + STAGES - 1;
    if (next < kt_total) load_stage(next % STAGES, next);
    cp_async_commit();
    if (!any_live) continue;

    const uint8_t* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const uint8_t* sb = sa + A_BYTES;
    if constexpr (BW) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;
    }
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      uint4 a_lo[MI], a_hi[MI], b[NI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (!live[mi]) continue;
        const uint8_t* pa = sa + plane * BM * PLANE + (wm0 + mi * 16 + gq) * PLANE + tq * 16;
        a_lo[mi] = *reinterpret_cast<const uint4*>(pa);
        a_hi[mi] = *reinterpret_cast<const uint4*>(pa + 8 * PLANE);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        b[ni] = *reinterpret_cast<const uint4*>(sb + plane * BN * PLANE + b_row[ni] * PLANE +
                                                tq * 16);
      }
      plane_mma(T{}, acc, a_lo, a_hi, b, live);
    }
    if constexpr (BW) {  // bw += (partial * sx[row]) * sw, rounded step by step
      const float* ss = reinterpret_cast<const float*>(sb + BN * BK);
      const float swv = ss[BM];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (!live[mi]) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float sxv = ss[wm0 + mi * 16 + gq + half * 8];
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& f = bw[mi][ni][half * 2 + e];
              f = __fadd_rn(f, __fmul_rn(__fmul_rn(to_float(acc[mi][ni][half * 2 + e]), sxv), swv));
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  float scale = 1.f;  // the blockwise forms have applied their scales
  if constexpr (!BW) scale = p.y_scale[group];
  if constexpr (ACT) {
    const float am = p.act_scale[0];
    const int width = n / 2;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm0 + mi * 16 + gq + half * 8;
        if (s_src[r] < 0) continue;  // an empty slot, or a row past the tile
        int8_t* orow = static_cast<int8_t*>(p.out) + (row0 + r) * width;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int col = c0 + wn * 16 + ni * 8 + tq * 2;
          uint16_t two = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gate = scaled_bf16(to_float(acc[mi][ni][half * 2 + e]), scale);
            const float up = scaled_bf16(to_float(acc[mi][ni + 2][half * 2 + e]), scale);
            two |= static_cast<uint16_t>(static_cast<uint8_t>(act_code(gate, up, am, p.bf16_mul)))
                   << (8 * e);
          }
          *reinterpret_cast<uint16_t*>(orow + col) = two;
        }
      }
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!live[mi]) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm0 + mi * 16 + gq + half * 8;
        if (s_src[r] < 0) continue;  // an empty slot, or a row past the tile
        __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) + (row0 + r) * n;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int col = n0 + wn * 32 + ni * 8 + tq * 2;
          if (col < n) {
            float v0, v1;
            if constexpr (BW) {
              v0 = bw[mi][ni][half * 2];
              v1 = bw[mi][ni][half * 2 + 1];
            } else {
              v0 = __fmul_rn(to_float(acc[mi][ni][half * 2]), scale);
              v1 = __fmul_rn(to_float(acc[mi][ni][half * 2 + 1]), scale);
            }
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// One kernel name for each form, so that a profile tells them apart. The
// act epilogue's 128-row block is held to two blocks an SM (128 registers a
// thread, as the plain int8 GEMM uses): unbounded it took 164, one block an
// SM, and on an H100 ran slower than the plain GEMM and the activation
// kernel one after the other. The blockwise forms are held the same way:
// unbounded their 64-row block took 160-168 registers, one block an SM, and
// the serving path's decode GEMMs ran 1.3-1.5x slower (scripts/time_gg_bw.py).
// The e4m3 aligned form is left unbounded: held to 128 registers it spills.
#define GG_KERNEL(NAME, T, MODE, MIN_BLOCKS)                                        \
  template <int BM, int WARPS_M, int STAGES>                                       \
  __global__ void __launch_bounds__(WARPS_M * 4 * 32, MIN_BLOCKS) NAME(const Params p) { \
    gg_body<T, MODE, BM, WARPS_M, STAGES>(p);                                      \
  }
GG_KERNEL(gg_scatter_e4m3_kernel, E4m3, kScatter, 1)
GG_KERNEL(gg_scatter_i8_kernel, I8, kScatter, 1)
GG_KERNEL(gg_scatter_i8_act_kernel, I8, kScatterAct, BM == 128 ? 2 : 1)
GG_KERNEL(gg_pertensor_e4m3_kernel, E4m3, kAligned, 1)
GG_KERNEL(gg_pertensor_i8_kernel, I8, kAligned, 1)
GG_KERNEL(gg_bw_scatter_e4m3_kernel, E4m3, kBwScatter, 2)
GG_KERNEL(gg_bw_scatter_i8_kernel, I8, kBwScatter, 2)
GG_KERNEL(gg_bw_aligned_e4m3_kernel, E4m3, kBwAligned, 1)  // bounded, it spills
GG_KERNEL(gg_bw_aligned_i8_kernel, I8, kBwAligned, 2)
#undef GG_KERNEL

template <typename T, int MODE, int BM, int WARPS_M, int STAGES>
auto kernel_of() {
  constexpr bool I8_OPS = std::is_same<T, I8>::value;
  if constexpr (MODE == kScatterAct) {
    return gg_scatter_i8_act_kernel<BM, WARPS_M, STAGES>;
  } else if constexpr (MODE == kAligned) {
    if constexpr (I8_OPS) return gg_pertensor_i8_kernel<BM, WARPS_M, STAGES>;
    else return gg_pertensor_e4m3_kernel<BM, WARPS_M, STAGES>;
  } else if constexpr (MODE == kBwScatter) {
    if constexpr (I8_OPS) return gg_bw_scatter_i8_kernel<BM, WARPS_M, STAGES>;
    else return gg_bw_scatter_e4m3_kernel<BM, WARPS_M, STAGES>;
  } else if constexpr (MODE == kBwAligned) {
    if constexpr (I8_OPS) return gg_bw_aligned_i8_kernel<BM, WARPS_M, STAGES>;
    else return gg_bw_aligned_e4m3_kernel<BM, WARPS_M, STAGES>;
  } else {
    if constexpr (I8_OPS) return gg_scatter_i8_kernel<BM, WARPS_M, STAGES>;
    else return gg_scatter_e4m3_kernel<BM, WARPS_M, STAGES>;
  }
}

template <typename T, int MODE, int BM, int WARPS_M, int STAGES>
int launch(Params p, cudaStream_t stream) {
  constexpr int SMEM = STAGES * stage_bytes<MODE, BM>();
  auto kernel = kernel_of<T, MODE, BM, WARPS_M, STAGES>();
  static bool configured = false;  // more than 48 KB of dynamic shared memory
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  p.subtiles = (p.tm + BM - 1) / BM;
  const int cols = MODE == kScatterAct ? p.n / 2 : p.n;
  const int per_block = MODE == kScatterAct ? BN / 2 : BN;
  const dim3 grid(static_cast<unsigned>(p.num_tiles) * p.subtiles,
                  (cols + per_block - 1) / per_block);
  kernel<<<grid, WARPS_M * 4 * 32, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The block height follows the m-tile: 128 rows (8 warps, 3 stages) for
// tiles of 128 slots or more, 64 (8 warps) and 32 (4 warps, 4 stages) below;
// the blockwise forms stop at 64 rows (two accumulator sets).
template <typename T, int MODE>
int dispatch(const Params& a, void* stream) {
  if (a.num_tiles == 0 || a.n == 0) return 0;
  const int cols = MODE == kScatterAct ? a.n / 2 : a.n;
  if (a.tm < 1 || a.k < 16 || a.k % 16 != 0 || a.n % 2 != 0 || (cols + 63) / 64 > 65535) {
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
  if constexpr (!is_bw(MODE)) {
    if (a.tm >= 128) return launch<T, MODE, 128, 2, 3>(a, s);
  }
  if (a.tm >= 64) return launch<T, MODE, 64, 2, 4>(a, s);
  return launch<T, MODE, 32, 1, 4>(a, s);
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

// x [rows_x, k] e4m3, w [groups, n, k] e4m3, y_scale [groups] f32,
// row_idx [num_tiles * tm] i32, grp [num_tiles] i32, num_valid_tiles [1] i32,
// out [num_tiles * tm, n] bf16; all contiguous, k a multiple of 16, n even.
extern "C" int hpc_gg_scatter_e4m3(const void* x, const void* w, const void* y_scale,
                                   const void* row_idx, const void* grp,
                                   const void* num_valid_tiles, void* out, int num_tiles, int tm,
                                   int n, int k, void* stream) {
  return dispatch<E4m3, kScatter>(params(x, w, y_scale, nullptr, row_idx, grp, num_valid_tiles,
                                         out, num_tiles, tm, n, k, 0, 0),
                                  stream);
}

// The same over int8 x and w.
extern "C" int hpc_gg_scatter_i8(const void* x, const void* w, const void* y_scale,
                                 const void* row_idx, const void* grp, const void* num_valid_tiles,
                                 void* out, int num_tiles, int tm, int n, int k, void* stream) {
  return dispatch<I8, kScatter>(params(x, w, y_scale, nullptr, row_idx, grp, num_valid_tiles, out,
                                       num_tiles, tm, n, k, 0, 0),
                                stream);
}

// int8 x and interleaved w [groups, n, k] (pairs of `pair` gate rows and
// `pair` up rows), act_scale [1] f32, out [(num_tiles + 1) * tm, n / 2] int8
// codes (rows past num_tiles * tm and of empty slots are not written);
// pair a multiple of 64 dividing n / 2; bf16_mul: round silu(gate) to bf16
// and multiply by up as a bf16 product.
extern "C" int hpc_gg_scatter_i8_act(const void* x, const void* w, const void* y_scale,
                                     const void* act_scale, const void* row_idx, const void* grp,
                                     const void* num_valid_tiles, void* out, int num_tiles, int tm,
                                     int n, int k, int pair, int bf16_mul, void* stream) {
  return dispatch<I8, kScatterAct>(params(x, w, y_scale, act_scale, row_idx, grp, num_valid_tiles,
                                          out, num_tiles, tm, n, k, pair, bf16_mul),
                                   stream);
}

// x_al [rows, k] and w [groups, n, k], both int8 (elem 0) or both e4m3
// (elem 1), y_scale [groups] f32, grp and row_blk [num_tiles] i32,
// num_valid_tiles [1] i32, out [rows, n] bf16: tile t < num_valid_tiles[0]
// reads and writes rows row_blk[t] * tm .. + tm - 1, which must lie in x_al.
extern "C" int hpc_gg_pertensor(const void* x, const void* w, const void* y_scale, const void* grp,
                                const void* row_blk, const void* num_valid_tiles, void* out,
                                int num_tiles, int tm, int n, int k, int elem, void* stream) {
  const Params a = params(x, w, y_scale, nullptr, row_blk, grp, num_valid_tiles, out, num_tiles,
                          tm, n, k, 0, 0);
  if (elem == 0) return dispatch<I8, kAligned>(a, stream);
  if (elem == 1) return dispatch<E4m3, kAligned>(a, stream);
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
              int n, int k, int sx_stride, int sw_stride, void* stream) {
  Params a = params(x, w, nullptr, nullptr, rows, grp, num_valid_tiles, out, num_tiles, tm, n, k,
                    0, 0);
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(sw);
  a.sx_stride = sx_stride;
  a.sw_stride = sw_stride;
  return dispatch<T, MODE>(a, stream);
}
}  // namespace

#define GG_BW_LAUNCHER(NAME, T, MODE)                                                            \
  extern "C" int NAME(const void* x, const void* w, const void* sx, const void* sw,             \
                      const void* rows, const void* grp, const void* num_valid_tiles, void* out, \
                      int num_tiles, int tm, int n, int k, int sx_stride, int sw_stride,         \
                      void* stream) {                                                            \
    return launch_bw<T, MODE>(x, w, sx, sw, rows, grp, num_valid_tiles, out, num_tiles, tm, n, k, \
                              sx_stride, sw_stride, stream);                                     \
  }
GG_BW_LAUNCHER(hpc_gg_bw_scatter_i8, I8, kBwScatter)
GG_BW_LAUNCHER(hpc_gg_bw_scatter_e4m3, E4m3, kBwScatter)
GG_BW_LAUNCHER(hpc_gg_bw_aligned_i8, I8, kBwAligned)
GG_BW_LAUNCHER(hpc_gg_bw_aligned_e4m3, E4m3, kBwAligned)
#undef GG_BW_LAUNCHER
