// Scatter grouped GEMM over e4m3 operands:
//   out[slot] = (x[row_idx[slot]] . W[grp[slot / tm]]^T) * y_scale[grp[slot / tm]]
// with float32 accumulation and a bf16 result.
//
// Replaces: hpc_ops_tpu/ops/group_gemm.py:_gg_scatter_kernel (the Pallas
// kernel behind _gg_scatter_pallas / group_gemm_fp8_scatter and both GEMMs of
// ops/moe.py:fuse_moe_pertensor_fp8), without its act_fuse epilogue.
//
// Contract, as there: output rows come in m-tiles of tm slots, each tile
// owned by one group (expert) grp[tile]; row_idx[slot] names the row of x
// that slot computes on (x is never gathered in memory), -1 marks an empty
// slot whose output row may hold anything; tiles at or past num_valid_tiles[0]
// (a device scalar, so the host never reads it) do nothing at all.
//
// Bound on the card: bytes at decode shapes (a handful of rows per expert:
// every expert's whole weight is streamed for almost no arithmetic),
// operations at prefill shapes (hundreds of rows per expert).
//
// Design: a block computes BM rows of one m-tile by 128 output columns. The
// K loop walks 128-element stages through a cp.async ring in shared memory
// (3 or 4 stages: enough bytes in flight to cover the memory latency when
// the kernel only streams weights). Rows of x are fetched by their index
// straight into the ring, 16 bytes a thread; empty slots and ragged edges
// are zero-filled by cp.async itself. e4m3 stays e4m3 in shared memory; a
// warp converts its fragments to fp16 in registers (cvt.rn.f16x2.e4m3x2:
// every e4m3 value, subnormals included, is exact in fp16) and multiplies
// with mma.sync.m16n8k16 into float32, so each product is exact and only
// the order of the sum differs from a float32 reference. A stage is stored
// as two [rows][64] byte planes: a lane reads one 16-byte piece of a row and
// finds in it its operands of four consecutive k16 steps. That permutes k
// inside a step the same way for A and for B, which a dot product does not
// see, and makes every shared-memory read a conflict-free 16-byte load.
// 16-row groups of a block that hold no real row are skipped, so a decode
// tile of 32 slots with two real rows pays for 16 (in the MoE's gate-up GEMM;
// its down GEMM passes identity row indices, so every slot counts as real
// there). Blocks of one m-tile sit
// side by side in the grid's fast dimension, so the blocks that share a
// weight panel run together and it is read from device memory about once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;   // output columns of a block
constexpr int BK = 128;   // K elements (bytes) of a stage
constexpr int PLANE = 64; // bytes of a row in one plane of a stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// BM rows by BN columns a block, WARPS_M x 4 warps, each (BM / WARPS_M) x 32.
template <int BM, int WARPS_M, int STAGES>
__global__ void __launch_bounds__(WARPS_M * 4 * 32)
gg_scatter_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ y_scale, const int32_t* __restrict__ row_idx,
                  const int32_t* __restrict__ grp, const int32_t* __restrict__ num_valid_tiles,
                  __nv_bfloat16* __restrict__ out, int tm, int subtiles, int n, int k) {
  constexpr int THREADS = WARPS_M * 4 * 32;
  constexpr int WM = BM / WARPS_M;
  constexpr int MI = WM / 16;
  constexpr int NI = 4;
  constexpr int A_BYTES = BM * BK;
  constexpr int STAGE_BYTES = A_BYTES + BN * BK;

  const int tile = blockIdx.x / subtiles;
  if (tile >= num_valid_tiles[0]) return;
  const int sub = blockIdx.x - tile * subtiles;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = (warp / 4) * WM;
  const int wn0 = (warp % 4) * 32;
  const int gq = lane >> 2;  // fragment row (A, C) or column (B)
  const int tq = lane & 3;

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_src[BM];  // row of x behind each row of the block, -1: none

  int mine_real = 0;
  for (int r = tid; r < BM; r += THREADS) {
    const int in_tile = sub * BM + r;
    const int src = in_tile < tm ? row_idx[static_cast<int64_t>(tile) * tm + in_tile] : -1;
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

  const int group = grp[tile];
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
      const bool p = src >= 0 && kk < k;
      cp_async16(sa + c * 16, p ? x + static_cast<int64_t>(src) * k + kk : x, p);
    }
    for (int c = tid; c < BN * 8; c += THREADS) {
      const int plane = c / (BN * 4);
      const int rem = c - plane * (BN * 4);
      const int kk = k0 + plane * PLANE + (rem & 3) * 16;
      const int col = n0 + (rem >> 2);
      const bool p = col < n && kk < k;
      cp_async16(sb + c * 16, p ? wg + static_cast<int64_t>(col) * k + kk : wg, p);
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
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      uint4 a_lo[MI], a_hi[MI], b[NI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (!live[mi]) continue;
        const uint8_t* p = sa + plane * BM * PLANE + (wm0 + mi * 16 + gq) * PLANE + tq * 16;
        a_lo[mi] = *reinterpret_cast<const uint4*>(p);
        a_hi[mi] = *reinterpret_cast<const uint4*>(p + 8 * PLANE);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        b[ni] = *reinterpret_cast<const uint4*>(sb + plane * BN * PLANE +
                                                (wn0 + ni * 8 + gq) * PLANE + tq * 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // the four k16 steps of this plane
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
  }
  cp_async_wait<0>();

  const float scale = y_scale[group];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (!live[mi]) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mi * 16 + gq + half * 8;
      if (s_src[r] < 0) continue;  // an empty slot, or a row past the tile
      __nv_bfloat16* orow = out + (static_cast<int64_t>(tile) * tm + sub * BM + r) * n;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn0 + ni * 8 + tq * 2;
        if (col < n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
              acc[mi][ni][half * 2] * scale, acc[mi][ni][half * 2 + 1] * scale);
        }
      }
    }
  }
}

template <int BM, int WARPS_M, int STAGES>
int launch(const void* x, const void* w, const void* y_scale, const void* row_idx,
           const void* grp, const void* num_valid_tiles, void* out, int num_tiles, int tm, int n,
           int k, cudaStream_t stream) {
  constexpr int SMEM = STAGES * (BM + BN) * BK;
  auto kernel = gg_scatter_kernel<BM, WARPS_M, STAGES>;
  static bool configured = false;  // more than 48 KB of dynamic shared memory
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int subtiles = (tm + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(num_tiles) * subtiles, (n + BN - 1) / BN);
  kernel<<<grid, WARPS_M * 4 * 32, SMEM, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(y_scale), static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(grp), static_cast<const int32_t*>(num_valid_tiles),
      static_cast<__nv_bfloat16*>(out), tm, subtiles, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows_x, k] e4m3, w [groups, n, k] e4m3, y_scale [groups] f32,
// row_idx [num_tiles * tm] i32, grp [num_tiles] i32, num_valid_tiles [1] i32,
// out [num_tiles * tm, n] bf16; all contiguous, k a multiple of 16, n even.
extern "C" int hpc_gg_scatter_e4m3(const void* x, const void* w, const void* y_scale,
                                   const void* row_idx, const void* grp,
                                   const void* num_valid_tiles, void* out, int num_tiles, int tm,
                                   int n, int k, void* stream) {
  if (num_tiles == 0 || n == 0) return 0;
  if (tm < 1 || k < 16 || k % 16 != 0 || n % 2 != 0 || (n + BN - 1) / BN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm >= 128) {
    return launch<128, 2, 3>(x, w, y_scale, row_idx, grp, num_valid_tiles, out, num_tiles, tm, n,
                             k, s);
  }
  if (tm >= 64) {
    return launch<64, 2, 4>(x, w, y_scale, row_idx, grp, num_valid_tiles, out, num_tiles, tm, n,
                            k, s);
  }
  return launch<32, 1, 4>(x, w, y_scale, row_idx, grp, num_valid_tiles, out, num_tiles, tm, n, k,
                          s);
}
