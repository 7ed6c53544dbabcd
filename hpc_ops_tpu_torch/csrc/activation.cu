// silu(gate) * up * scale -> e4m3 (or int8), row by row.
//
// Replaces: hpc_ops_tpu/ops/activation.py:_act_quant_kernel (the Pallas
// kernel behind act_mul_and_quant, the stage between the two grouped GEMMs
// of ops/moe.py:fuse_moe_pertensor_fp8).
//
// gate_up is [rows, 2*c] bf16, gate in the first c columns and up in the
// last; out is [rows, c]. silu runs in float32; with bf16_mul the activation
// is rounded to bf16 and multiplied by the bf16 up value as a bf16 product
// (the reference's default), else the product stays float32. The product
// times scale[0] is clamped to +-448 and rounded to e4m3 (nearest even), or
// rounded half to even and clamped to +-127 for int8. Rows at or past
// num_valid[0] (a device scalar: the MoE's count of real rows, never read
// by the host) are left untouched.
//
// Bound on the card: bytes (4*c read and c written per row against a dozen
// operations per element). Design: one block row per matrix row, a thread
// per 8 columns: two 16-byte loads, one 8-byte store, nothing shared.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t quantise(float v, uint8_t*) {
  v = fminf(fmaxf(v, -448.f), 448.f);
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
}
__device__ __forceinline__ uint8_t quantise(float v, int8_t*) {
  return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f)));
}

template <typename OutT, bool BF16_MUL>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const __nv_bfloat16* __restrict__ gate_up, const float* __restrict__ scale,
                 const int32_t* __restrict__ num_valid, OutT* __restrict__ out, int c) {
  const int64_t row = blockIdx.x;
  if (num_valid != nullptr && row >= num_valid[0]) return;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * 8;
  if (col >= c) return;
  const __nv_bfloat16* g = gate_up + row * 2 * c + col;
  const uint4 gv = *reinterpret_cast<const uint4*>(g);
  const uint4 uv = *reinterpret_cast<const uint4*>(g + c);
  const __nv_bfloat16* gate = reinterpret_cast<const __nv_bfloat16*>(&gv);
  const __nv_bfloat16* up = reinterpret_cast<const __nv_bfloat16*>(&uv);
  const float s = scale[0];
  __align__(8) uint8_t codes[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = __bfloat162float(gate[i]);
    const float act = x * (1.f / (1.f + expf(-x)));
    float prod;
    if (BF16_MUL) {
      // the product of two bf16 values is exact in float32: one rounding
      prod = __bfloat162float(__float2bfloat16(
          __fmul_rn(__bfloat162float(__float2bfloat16(act)), __bfloat162float(up[i]))));
    } else {
      prod = __fmul_rn(act, __bfloat162float(up[i]));
    }
    codes[i] = quantise(__fmul_rn(prod, s), static_cast<OutT*>(nullptr));
  }
  *reinterpret_cast<uint2*>(out + row * c + col) = *reinterpret_cast<const uint2*>(codes);
}

template <typename OutT>
int launch(const void* gate_up, const void* scale, const void* num_valid, void* out, int rows,
           int c, int bf16_mul, cudaStream_t stream) {
  const dim3 grid(rows, (c / 8 + kThreads - 1) / kThreads);
  auto* gu = static_cast<const __nv_bfloat16*>(gate_up);
  auto* sc = static_cast<const float*>(scale);
  auto* nv = static_cast<const int32_t*>(num_valid);
  if (bf16_mul) {
    act_quant_kernel<OutT, true><<<grid, kThreads, 0, stream>>>(gu, sc, nv, static_cast<OutT*>(out), c);
  } else {
    act_quant_kernel<OutT, false><<<grid, kThreads, 0, stream>>>(gu, sc, nv, static_cast<OutT*>(out), c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gate_up [rows, 2*c] bf16, scale [1] f32, num_valid [1] i32 or null (all
// rows), out [rows, c] e4m3 bytes (to_int8 = 0) or int8; contiguous, c a
// multiple of 8.
extern "C" int hpc_act_mul_quant(const void* gate_up, const void* scale, const void* num_valid,
                                 void* out, int rows, int c, int bf16_mul, int to_int8,
                                 void* stream) {
  if (rows == 0 || c == 0) return 0;
  if (c % 8 != 0 || (c / 8 + kThreads - 1) / kThreads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return to_int8 ? launch<int8_t>(gate_up, scale, num_valid, out, rows, c, bf16_mul, s)
                 : launch<uint8_t>(gate_up, scale, num_valid, out, rows, c, bf16_mul, s);
}
