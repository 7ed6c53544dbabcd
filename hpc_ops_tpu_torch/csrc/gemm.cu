// Route GEMM, float32-accurate through split bf16 weights:
//   out[m, n] = sum_k x[m, k] * w_high[n, k] + scale * sum_k x[m, k] * w_low[n, k]
// with x [M, K], w_high and w_low [N, K] bf16 (K contiguous), two float32
// accumulators, and out [M, N] bf16 or float32.
//
// Replaces: hpc_ops_tpu/ops/gemm.py:_route_gemm_kernel (reached through
// _route_gemm_pallas from gemm_bf16xfp32; launcher hpc_route_gemm). As there,
// one load of each x tile feeds both products and the output is written once.
//
// Bound on the card: operations at prefill and square shapes (2 * 2 * M * N * K
// bf16 operations); bytes at router decode shapes (N = 256 experts: the
// weights, 2 * 2 * N * K bytes, dominate).
//
// Design: a block of 4 warps computes a 64 x 64 output tile. The K loop walks
// 32-wide stages through a 4-stage cp.async ring in shared memory (x, w_high
// and w_low tiles of 64 rows x 64 bytes each, rows padded to 80 bytes so the
// 32-bit fragment reads of a warp hit 32 distinct banks); ragged rows and K
// tails are zero-filled by cp.async itself. Each warp owns a 32 x 32 quarter:
// per 16-wide k step it reads its A fragments once and issues
// mma.sync.m16n8k16 (bf16 in, float32 out) against the w_high and the w_low
// fragments into two accumulator sets. The epilogue forms hi + scale * lo
// with one rounding each (no FMA), as the plain version does.
//
// Known limits: mma.sync, not wgmma/TMA; no split-K, so at N = 256 and small
// M the grid leaves most of the 132 SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32;  // BK in bf16 elements (64 bytes)
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kPitch = 40;                // bf16 per shared row: 32 + 8 of padding
constexpr int kTileElems = 64 * kPitch;   // one 64-row operand tile
constexpr int kStageElems = 3 * kTileElems;

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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool kFp32Out>
__global__ void __launch_bounds__(kThreads) route_gemm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wh,
    const __nv_bfloat16* __restrict__ wl, const float* __restrict__ scale, void* __restrict__ out,
    int m, int n, int k) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int kt_total = (k + BK - 1) / BK;

  // 3 tiles x 64 rows x 4 pieces of 16 bytes: 6 pieces a thread
  auto load_stage = [&](int slot, int kt) {
    __nv_bfloat16* s = smem + slot * kStageElems;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int piece = tid + i * kThreads;
      const int t = piece >> 8, row = (piece >> 2) & 63, q = piece & 3;
      const int kk = k0 + q * 8;
      const __nv_bfloat16* src;
      bool pred;
      if (t == 0) {
        pred = m0 + row < m && kk < k;
        src = x + static_cast<int64_t>(pred ? m0 + row : 0) * k + (pred ? kk : 0);
      } else {
        pred = n0 + row < n && kk < k;
        src = (t == 1 ? wh : wl) + static_cast<int64_t>(pred ? n0 + row : 0) * k + (pred ? kk : 0);
      }
      cp_async16(s + t * kTileElems + row * kPitch + q * 8, src, pred);
    }
  };

  float hi[2][4][4], lo[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[i][j][e] = lo[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_total) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; the slot refilled below is free
    if (kt + kStages - 1 < kt_total) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* sx = smem + (kt % kStages) * kStageElems;
    const __nv_bfloat16* sh = sx + kTileElems;
    const __nv_bfloat16* sl = sh + kTileElems;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = sx + (wm + mi * 16 + gq) * kPitch + kk + tq * 2;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * kPitch);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * kPitch + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int off = (wn + ni * 8 + gq) * kPitch + kk + tq * 2;
        const uint32_t bh[2] = {ld32(sh + off), ld32(sh + off + 8)};
        const uint32_t bl[2] = {ld32(sl + off), ld32(sl + off + 8)};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(hi[mi][ni], a[mi], bh);
          mma_bf16(lo[mi][ni], a[mi], bl);
        }
      }
    }
  }
  cp_async_wait<0>();

  const float s = scale[0];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mi * 16 + gq + half * 8;
        const int c = n0 + wn + ni * 8 + tq * 2;
        if (r >= m) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= n) continue;
          const float v = __fadd_rn(hi[mi][ni][half * 2 + e], __fmul_rn(s, lo[mi][ni][half * 2 + e]));
          const int64_t at = static_cast<int64_t>(r) * n + c + e;
          if constexpr (kFp32Out) {
            static_cast<float*>(out)[at] = v;
          } else {
            static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(v);
          }
        }
      }
}

template <bool kFp32Out>
int launch(const void* x, const void* wh, const void* wl, const void* scale, void* out, int m,
           int n, int k, cudaStream_t stream) {
  const int smem = kStages * kStageElems * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t e = cudaFuncSetAttribute(route_gemm_kernel<kFp32Out>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  route_gemm_kernel<kFp32Out><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wh),
      static_cast<const __nv_bfloat16*>(wl), static_cast<const float*>(scale), out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [m, k], w_high and w_low: [n, k] bf16, each row-contiguous with k a
// multiple of 8 (16-byte rows); scale: [1] float32 on the device; out:
// [m, n] float32 (fp32_out) or bf16. Returns a cudaError_t code.
extern "C" int hpc_route_gemm(const void* x, const void* w_high, const void* w_low,
                              const void* scale, void* out, int m, int n, int k, int fp32_out,
                              void* stream) {
  if (k % 8 != 0 || m < 0 || n < 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  if (m > 65535 * BM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32_out ? launch<true>(x, w_high, w_low, scale, out, m, n, k, s)
                  : launch<false>(x, w_high, w_low, scale, out, m, n, k, s);
}
