// Fused RMSNorm + scale -> e4m3: for each row x of a [n, h] bf16 input,
//   norm = x * (1 / sqrt(mean(x^2) + eps)) * weight       (float32)
//   y0 = e4m3(norm * (1 / scale[0]))  and, with the MoE outputs,
//   y1 = e4m3(norm * (1 / scale[1])), plus norm itself as float32.
// The conversion rounds to nearest even and saturates at +-448 (the clip of
// the TPU kernel); NaN stays NaN. The weight is bf16 or float32, read in its
// own type (widening bf16 to float32 is exact), so a call is one launch.
//
// Replaces: hpc_ops_tpu/ops/normalization.py:_rmsnorm_kernel (reached through
// _fused_rmsnorm_pallas from fused_rmsnorm_with_scale; launcher
// hpc_rmsnorm_quant). Like that kernel it multiplies by the float32
// reciprocal of each scale (its reference divides).
//
// Bound on the card: bytes (2 bytes in and 1 out per element, 4 + 1 more
// with the MoE outputs; a handful of operations each).
//
// Design: one block of 256 threads per row, VEC elements a thread and load:
// 8 (16 bytes of bf16), or 4, 2 or 1 where a's or the weight's alignment
// asks (ops/normalization.py:norm_form). The first pass sums the squares in
// double: the square of a bf16 value has at most 16 significant bits, so
// the sum is exact, whatever its order, unless the row's squares span more
// than 53 bits; the plain version sums the same way and gets the same
// float32 mean. Every later step is a single correctly rounded float32
// operation (__fadd_rn, __fsqrt_rn, __fdiv_rn, __fmul_rn), in the plain
// version's order. The second pass reads the row again (from L1/L2) and
// writes VEC codes a thread and store. At 2048 rows this design reaches
// 0.67-0.71 of the bytes bound in device time on an H100 (700 W;
// scripts/time_norm_combine.py), so it keeps its two passes.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int kBytes> struct Word;
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// VEC elements of type E at p (aligned to VEC elements, or 16 bytes) as floats.
template <typename E, int VEC>
__device__ __forceinline__ void load_vec(const E* p, float* f) {
  constexpr int kBytes = static_cast<int>(sizeof(E)) * VEC;
  constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  using P = typename Word<kPiece>::T;
  P raw[kBytes / kPiece];
#pragma unroll
  for (int i = 0; i < kBytes / kPiece; ++i) raw[i] = reinterpret_cast<const P*>(p)[i];
  const E* e = reinterpret_cast<const E*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_float(e[i]);
}

// VEC floats -> VEC e4m3 codes in one store of VEC bytes.
template <int VEC>
__device__ __forceinline__ void store_e4m3(uint8_t* dst, const float* v) {
  uint32_t c[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) c[i] = __nv_cvt_float_to_fp8(v[i], __NV_SATFINITE, __NV_E4M3);
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24),
                                                c[4] | (c[5] << 8) | (c[6] << 16) | (c[7] << 24));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(dst) = c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(c[0] | (c[1] << 8));
  } else {
    *dst = static_cast<uint8_t>(c[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_floats(float* dst, const float* v) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}

template <int VEC, typename WT>
__global__ void __launch_bounds__(kThreads) rmsnorm_quant_kernel(
    const __nv_bfloat16* __restrict__ a, const WT* __restrict__ weight,
    const float* __restrict__ scale, uint8_t* __restrict__ y0, float* __restrict__ norm_out,
    uint8_t* __restrict__ y1, int h, float eps) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * h;
  const __nv_bfloat16* x = a + base;
  double ss = 0.0;
  for (int c = threadIdx.x * VEC; c < h; c += kThreads * VEC) {
    float f[VEC];
    load_vec<__nv_bfloat16, VEC>(x + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss += static_cast<double>(f[i]) * static_cast<double>(f[i]);
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
  for (int c = threadIdx.x * VEC; c < h; c += kThreads * VEC) {
    float f[VEC], w[VEC], y[VEC];
    load_vec<__nv_bfloat16, VEC>(x + c, f);
    load_vec<WT, VEC>(weight + c, w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      f[i] = __fmul_rn(__fmul_rn(f[i], rstd), w[i]);
      y[i] = __fmul_rn(f[i], inv0);
    }
    store_e4m3<VEC>(y0 + base + c, y);
    if (norm_out != nullptr) store_floats<VEC>(norm_out + base + c, f);
    if (y1 != nullptr) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) y[i] = __fmul_rn(f[i], inv1);
      store_e4m3<VEC>(y1 + base + c, y);
    }
  }
}

template <typename WT>
int launch(int vec, const void* a, const void* weight, const void* scale, void* y0, void* norm_out,
           void* y1, int n, int h, float eps, cudaStream_t s) {
  const auto* x = static_cast<const __nv_bfloat16*>(a);
  const auto* w = static_cast<const WT*>(weight);
  const auto* sc = static_cast<const float*>(scale);
  auto* c0 = static_cast<uint8_t*>(y0);
  auto* no = static_cast<float*>(norm_out);
  auto* c1 = static_cast<uint8_t*>(y1);
  switch (vec) {
    case 8: rmsnorm_quant_kernel<8, WT><<<n, kThreads, 0, s>>>(x, w, sc, c0, no, c1, h, eps); break;
    case 4: rmsnorm_quant_kernel<4, WT><<<n, kThreads, 0, s>>>(x, w, sc, c0, no, c1, h, eps); break;
    case 2: rmsnorm_quant_kernel<2, WT><<<n, kThreads, 0, s>>>(x, w, sc, c0, no, c1, h, eps); break;
    case 1: rmsnorm_quant_kernel<1, WT><<<n, kThreads, 0, s>>>(x, w, sc, c0, no, c1, h, eps); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: [n, h] bf16, h a multiple of 8; weight: [h] bf16 (w_float 0) or
// float32 (w_float 1); scale: [1] or (with y1) [2] float32 on the device;
// y0 (and y1): [n, h] e4m3 codes; norm_out: [n, h] float32 or null. vec: the
// elements a load (8, 4, 2 or 1; ops/normalization.py:norm_form), a
// aligned to 2 * vec bytes and the weight to its element size times vec (at
// most 16). Returns a cudaError_t code.
extern "C" int hpc_rmsnorm_quant(const void* a, const void* weight, int w_float, const void* scale,
                                 void* y0, void* norm_out, void* y1, int n, int h, float eps,
                                 int vec, void* stream) {
  if (h % 8 != 0 || h <= 0 || (vec != 1 && vec != 2 && vec != 4 && vec != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t w_bytes = (w_float ? 4 : 2) * vec;
  if (reinterpret_cast<uintptr_t>(a) % (2 * vec) ||
      reinterpret_cast<uintptr_t>(weight) % (w_bytes < 16 ? w_bytes : 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_float ? launch<float>(vec, a, weight, scale, y0, norm_out, y1, n, h, eps, s)
                 : launch<__nv_bfloat16>(vec, a, weight, scale, y0, norm_out, y1, n, h, eps, s);
}
