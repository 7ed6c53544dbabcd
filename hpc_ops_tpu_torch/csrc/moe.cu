// Top-k weighted combine of expert rows:
//   out[s] = sum_j [pos[s,j] >= 0] * scale[s,j] * x[pos[s,j]]  (+ shared[s])
// in float32, written as bf16.
//
// Replaces: hpc_ops_tpu/ops/moe.py:_reduce_kernel (the Pallas gather-combine
// behind ops/moe.py:reduce, the last stage of fuse_moe_pertensor_fp8).
//
// A slot with pos < 0 (a token routed to an expert of another rank) is left
// out by a branch, never multiplied by 0: rows of x that no valid slot
// points at may hold anything, NaN included. The sum starts from the shared
// expert's row (or 0) and adds the k slots in order, each as a rounded
// product and a rounded add, so it equals the plain float32 version bit for
// bit.
//
// Bound on the card: bytes (k rows of h bf16 read and one written per
// token). Design: one block per token, 8 columns a thread (16-byte loads
// and stores), the token's k indices and weights read through the cache by
// every thread; nothing is shared and nothing is atomic, since each output
// row gathers its own inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
moe_reduce_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ pos,
                  const float* __restrict__ scale, const __nv_bfloat16* __restrict__ shared,
                  __nv_bfloat16* __restrict__ out, int k, int h) {
  const int64_t s = blockIdx.x;
  for (int col = threadIdx.x * 8; col < h; col += kThreads * 8) {
    float acc[8];
    if (shared != nullptr) {
      const uint4 v = *reinterpret_cast<const uint4*>(shared + s * h + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __bfloat162float(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    }
    for (int j = 0; j < k; ++j) {
      const int32_t p = pos[s * k + j];
      if (p < 0) continue;
      const float wgt = scale[s * k + j];
      const uint4 v = *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(p) * h + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__bfloat162float(e[i]), wgt));
      }
    }
    __align__(16) __nv_bfloat16 res[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) res[i] = __float2bfloat16(acc[i]);
    *reinterpret_cast<uint4*>(out + s * h + col) = *reinterpret_cast<const uint4*>(res);
  }
}

}  // namespace

// x [rows, h] bf16, pos [tokens, k] i32, scale [tokens, k] f32, shared
// [tokens, h] bf16 or null, out [tokens, h] bf16; contiguous, h a multiple of 8.
extern "C" int hpc_moe_reduce(const void* x, const void* pos, const void* scale,
                              const void* shared, void* out, int tokens, int k, int h,
                              void* stream) {
  if (tokens == 0 || h == 0) return 0;
  if (h % 8 != 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  moe_reduce_kernel<<<tokens, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(pos),
      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(shared),
      static_cast<__nv_bfloat16*>(out), k, h);
  return static_cast<int>(cudaGetLastError());
}
