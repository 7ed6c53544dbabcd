// Fused RMSNorm + scale -> e4m3: for each row x of a [n, h] bf16 input,
//   norm = x * (1 / sqrt(mean(x^2) + eps)) * weight       (float32)
//   y0 = e4m3(norm * (1 / scale[0]))  and, with the MoE outputs,
//   y1 = e4m3(norm * (1 / scale[1])), plus norm itself as float32.
// The conversion rounds to nearest even and saturates at +-448 (the clip of
// the TPU kernel); NaN stays NaN.
//
// Replaces: hpc_ops_tpu/ops/normalization.py:_rmsnorm_kernel (reached through
// _fused_rmsnorm_pallas from fused_rmsnorm_with_scale; launcher
// hpc_rmsnorm_quant). Like that kernel it multiplies by the float32
// reciprocal of each scale (its reference divides).
//
// Bound on the card: bytes (2 bytes in and 1 out per element, 4 + 1 more
// with the MoE outputs; a handful of operations each).
//
// Design: one block of 256 threads per row, 8 elements (16 bytes) a thread
// and load. The first pass sums the squares in double: the square of a
// bf16 value has at most 16 significant bits, so the sum is exact, whatever
// its order, unless the row's squares span more than 53 bits; the plain
// version sums the same way and gets the same float32 mean. Every later
// step is a single correctly rounded float32 operation (__fadd_rn,
// __fsqrt_rn, __fdiv_rn, __fmul_rn), in the plain version's order. The second pass reads the row again (from L1/L2) and writes 8
// codes (8 bytes) a thread and store.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Eight floats -> eight e4m3 codes in one 8-byte word.
__device__ __forceinline__ uint2 to_e4m3x8(const float* v) {
  uint8_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = __nv_cvt_float_to_fp8(v[i], __NV_SATFINITE, __NV_E4M3);
  uint2 u;
  u.x = c[0] | (c[1] << 8) | (c[2] << 16) | (static_cast<uint32_t>(c[3]) << 24);
  u.y = c[4] | (c[5] << 8) | (c[6] << 16) | (static_cast<uint32_t>(c[7]) << 24);
  return u;
}

__global__ void __launch_bounds__(kThreads) rmsnorm_quant_kernel(
    const __nv_bfloat16* __restrict__ a, const float* __restrict__ weight,
    const float* __restrict__ scale, uint8_t* __restrict__ y0, float* __restrict__ norm_out,
    uint8_t* __restrict__ y1, int h, float eps) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * h;
  const __nv_bfloat16* x = a + base;
  double ss = 0.0;
  for (int c = threadIdx.x * 8; c < h; c += kThreads * 8) {
    float f[8];
    load8(x + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += static_cast<double>(f[i]) * static_cast<double>(f[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ double part[kThreads / 32];
  __shared__ float rstd_s;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += part[i];
    const float mean = static_cast<float>(t / static_cast<double>(h));
    rstd_s = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, eps)));
  }
  __syncthreads();
  const float rstd = rstd_s;
  const float inv0 = __fdiv_rn(1.f, scale[0]);
  const float inv1 = y1 != nullptr ? __fdiv_rn(1.f, scale[1]) : 0.f;
  for (int c = threadIdx.x * 8; c < h; c += kThreads * 8) {
    float f[8], y[8];
    load8(x + c, f);
    const float4 w0 = *reinterpret_cast<const float4*>(weight + c);
    const float4 w1 = *reinterpret_cast<const float4*>(weight + c + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = __fmul_rn(__fmul_rn(f[i], rstd), w[i]);
      y[i] = __fmul_rn(f[i], inv0);
    }
    *reinterpret_cast<uint2*>(y0 + base + c) = to_e4m3x8(y);
    if (norm_out != nullptr) {
      float4* dst = reinterpret_cast<float4*>(norm_out + base + c);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    if (y1 != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __fmul_rn(f[i], inv1);
      *reinterpret_cast<uint2*>(y1 + base + c) = to_e4m3x8(y);
    }
  }
}

}  // namespace

// a: [n, h] bf16, h a multiple of 8; weight: [h] float32; scale: [1] or
// (with y1) [2] float32 on the device; y0 (and y1): [n, h] e4m3 codes;
// norm_out: [n, h] float32 or null. Returns a cudaError_t code.
extern "C" int hpc_rmsnorm_quant(const void* a, const void* weight, const void* scale, void* y0,
                                 void* norm_out, void* y1, int n, int h, float eps,
                                 void* stream) {
  if (h % 8 != 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  rmsnorm_quant_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const float*>(weight),
      static_cast<const float*>(scale), static_cast<uint8_t*>(y0), static_cast<float*>(norm_out),
      static_cast<uint8_t*>(y1), h, eps);
  return static_cast<int>(cudaGetLastError());
}
