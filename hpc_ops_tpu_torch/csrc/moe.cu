// Top-k weighted combine of expert rows:
//   out[s] = sum_j [pos[s,j] >= 0] * scale[s,j] * x[pos[s,j]]  (+ shared[s])
// in float32, written as bf16.
//
// Replaces: hpc_ops_tpu/ops/moe.py:_reduce_kernel (the Pallas gather-combine
// behind ops/moe.py:reduce, the last stage of fuse_moe_pertensor_fp8).
//
// A slot with pos < 0 (a token routed to an expert of another rank) is left
// out by a select, never multiplied by 0: rows of x that no valid slot
// points at may hold anything, NaN included, and are never loaded. The sum
// starts from the shared expert's row (or 0) and adds the k slots in order
// j = 0..k-1, each as a rounded product and a rounded add, so it equals the
// plain float32 version bit for bit.
//
// Bound on the card: bytes (k rows of h bf16 read and one written per
// token). Design: a block owns one token's chunk of columns and its threads
// walk the chunk's 8-column groups (16-byte loads and stores); the host
// splits a token's row into as many chunks as it takes for the grid to hold
// two blocks an SM (ops/moe.py:reduce_form), so a decode step of 8 tokens at
// h 4096 is 64 blocks of 64 threads, one group a thread, and a prefill of
// hundreds of tokens one block of 256 a token. A thread reads its token's k
// (pos, scale) pairs once, then for each of its groups issues the shared
// row's load and every valid slot's row load before the first add:
// predicated loads, so the slots' round trips to memory overlap instead of
// following one another. The slots are taken kSlots at a time, kSlots the
// smallest of 2, 4 and 8 that holds k (a template argument), so top-2 keeps
// two rows in registers and the block's register use allows full
// occupancy. The output goes out with streaming (evict-first) stores: a
// prefill of 2048 tokens moves about as many bytes as the 50 MB L2 holds,
// and output lines kept there pushed out rows still to be read (on an H100
// plain stores lost to the one-block-a-token kernel this replaces). The
// row loads stay plain: a row the down GEMM has just written may still be
// in the L2. Nothing is shared and nothing is atomic: each output chunk
// gathers its own inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void add_row(float* acc, const uint4& v, float w) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(__bfloat162float(e[i]), w));
}

// Slots [0, n) of a token's (pos, scale) pairs, at most kSlots; the rest -1.
template <int kSlots>
__device__ __forceinline__ void load_slots(int32_t* p, float* w, const int32_t* ps, const float* ws,
                                           int n) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    p[j] = j < n ? ps[j] : -1;
    w[j] = j < n ? ws[j] : 0.f;
  }
}

template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads)
moe_reduce_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ pos,
                  const float* __restrict__ scale, const __nv_bfloat16* __restrict__ shared,
                  __nv_bfloat16* __restrict__ out, int k, int h, int chunks) {
  const int64_t s = blockIdx.x / chunks;
  const int c = static_cast<int>(blockIdx.x - s * chunks);
  const int groups = h / 8;
  const int per = (groups + chunks - 1) / chunks;
  const int end = min(groups, (c + 1) * per);
  const int32_t* ps = pos + s * k;
  const float* ws = scale + s * k;
  int32_t p[kSlots];
  float w[kSlots];
  if (k <= kSlots) load_slots<kSlots>(p, w, ps, ws, k);
  for (int g = c * per + threadIdx.x; g < end; g += blockDim.x) {
    const int col = g * 8;
    uint4 sh = make_uint4(0, 0, 0, 0);  // bf16 zeros
    if (shared != nullptr) sh = *reinterpret_cast<const uint4*>(shared + s * h + col);
    float acc[8];
    for (int j0 = 0;; j0 += kSlots) {  // one pass at least: k == 0 still sets acc
      if (k > kSlots) load_slots<kSlots>(p, w, ps + j0, ws + j0, k - j0);
      uint4 v[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        v[j] = make_uint4(0, 0, 0, 0);
        if (p[j] >= 0) v[j] = *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(p[j]) * h + col);
      }
      if (j0 == 0) {  // after the row loads are issued
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&sh);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __bfloat162float(e[i]);
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (p[j] >= 0) add_row(acc, v[j], w[j]);
      }
      if (j0 + kSlots >= k) break;
    }
    __align__(16) __nv_bfloat16 res[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) res[i] = __float2bfloat16(acc[i]);
    __stcs(reinterpret_cast<uint4*>(out + s * h + col), *reinterpret_cast<const uint4*>(res));
  }
}

}  // namespace

// x [rows, h] bf16, pos [tokens, k] i32, scale [tokens, k] f32, shared
// [tokens, h] bf16 or null, out [tokens, h] bf16; contiguous, h a multiple of
// 8; threads a block (a multiple of 32, at most 256) and chunks a token from
// ops/moe.py:reduce_form.
extern "C" int hpc_moe_reduce(const void* x, const void* pos, const void* scale,
                              const void* shared, void* out, int tokens, int k, int h,
                              int threads, int chunks, void* stream) {
  if (tokens == 0 || h == 0) return 0;
  if (h % 8 != 0 || k < 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      chunks < 1 || chunks > h / 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = static_cast<int64_t>(tokens) * chunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* sp = static_cast<const float*>(scale);
  const auto* hp = static_cast<const __nv_bfloat16*>(shared);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 2) {
    moe_reduce_kernel<2><<<grid, threads, 0, st>>>(xp, pp, sp, hp, op, k, h, chunks);
  } else if (k <= 4) {
    moe_reduce_kernel<4><<<grid, threads, 0, st>>>(xp, pp, sp, hp, op, k, h, chunks);
  } else {
    moe_reduce_kernel<8><<<grid, threads, 0, st>>>(xp, pp, sp, hp, op, k, h, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
