// Fused NeoX RoPE + optional per-head QK-RMSNorm + paged KV store (bf16).
//
// Replaces: hpc_ops_tpu/ops/rope_kernel.py:_rope_store_kernel (the Pallas
// kernel behind rope_store_rows / ops/rope.py:_rope_store_pallas).
//
// Bound on the card: bytes. Per token row it reads the qkv row
// ((Hq + 2*Hkv) * D bf16) and one cos|sin row (D f32), and writes the rotated
// q row (Hq * D bf16) plus one K row and one V row (Hkv * D bf16 each) into
// the cache. The arithmetic is a few FLOPs per element.
//
// Design: one block per token row, one warp per head (q heads, then k heads,
// then v heads, walked by the block's warps in turn). The block finds its
// row's request (binary search in q_index), position and cache slot itself,
// so the caller passes the step's tables once instead of per-row index
// arrays. As in the JAX package, a row that maps to no valid slot (past
// q_index[-1], or on a page id below 0) is sent to the last slot of the
// cache: the contract is that every row is a real token. A lane holds pairs
// (i, i + D/2) of its head in float32 registers, so the rotation needs no
// shared memory and the per-head RMSNorm is one warp-shuffle reduction. The
// K and V rows go straight to their (page, slot) address: the caller passes
// the cache strides, so one kernel serves the head-major
// HND cache ([Hkv, S, D], a token's head row is D contiguous elements) and
// the NHD cache ([S, Hkv, D], a token's row is Hkv*D contiguous elements).
// Only the addressed slots are written; every other cache byte is left as it
// was. Launch overhead dominates at decode batch sizes (rows = batch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairsPerLane = 8;  // D <= 2 * 32 * 8 = 512
constexpr float kNormEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Scales x1/x2 (this lane's pairs) by rsqrt(mean(x^2) + eps) * w.
__device__ __forceinline__ void head_rmsnorm(float* x1, float* x2, int half,
                                             int lane, const float* w, int d) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPairsPerLane; ++j) {
    const int p = lane + 32 * j;
    if (p < half) ss += x1[j] * x1[j] + x2[j] * x2[j];
  }
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + kNormEps);
#pragma unroll
  for (int j = 0; j < kMaxPairsPerLane; ++j) {
    const int p = lane + 32 * j;
    if (p < half) {
      x1[j] = x1[j] * inv * w[p];
      x2[j] = x2[j] * inv * w[p + half];
    }
  }
}

// Row -> (position, flat slot) exactly as ops/rope.py's _row_mapping and
// ops/kv_cache.py's flat_slot_ids, then the clip of rope.py to the cache.
__device__ __forceinline__ void row_slot(int row, const int32_t* q_index,
                                         const int32_t* seq_lens, const int32_t* tbl,
                                         int num_req, int max_blocks, int page_size,
                                         int64_t num_slots, int64_t* pos_out,
                                         int64_t* slot_out) {
  int lo = 0, hi = num_req;  // first req with q_index[req + 1] > row
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (q_index[mid + 1] > row) hi = mid; else lo = mid + 1;
  }
  const int req = min(lo, num_req - 1);
  const int q_start = q_index[req];
  const int q_len = q_index[req + 1] - q_start;
  const int64_t pos = static_cast<int64_t>(seq_lens[req]) - q_len + (row - q_start);
  const bool valid = row < q_index[num_req] && pos >= 0 && q_len > 0;
  int64_t slot = num_slots - 1;
  if (valid) {
    const int64_t blk = pos / page_size;
    if (blk < max_blocks) {
      const int phys = tbl[static_cast<int64_t>(req) * max_blocks + blk];
      if (phys >= 0) slot = min(static_cast<int64_t>(phys) * page_size + pos % page_size, num_slots - 1);
    }
  }
  *pos_out = pos;
  *slot_out = slot;
}

__global__ void rope_store_kernel(
    const __nv_bfloat16* __restrict__ qkv,  // [rows, (hq + 2*hkv) * d]
    const float* __restrict__ cos_sin,      // [max_pos, d]: cos | sin
    const int32_t* __restrict__ seq_lens,   // [num_req] tokens incl. new
    const int32_t* __restrict__ q_index,    // [num_req + 1] row prefix sums
    const int32_t* __restrict__ tbl,        // [num_req, max_blocks] page table
    const float* __restrict__ qw,           // [d] (policy != 0)
    const float* __restrict__ kw,           // [d]
    __nv_bfloat16* __restrict__ q_out,      // [rows, hq * d]
    __nv_bfloat16* __restrict__ kcache, __nv_bfloat16* __restrict__ vcache,
    int hq, int hkv, int d, int max_pos, int num_req, int max_blocks,
    int page_size, int64_t num_slots, int64_t k_head_stride,
    int64_t k_slot_stride, int64_t v_head_stride, int64_t v_slot_stride,
    int policy) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int half = d / 2;
  const int64_t hidden = static_cast<int64_t>(hq + 2 * hkv) * d;
  const __nv_bfloat16* x = qkv + row * hidden;

  int64_t p, slot;
  row_slot(row, q_index, seq_lens, tbl, num_req, max_blocks, page_size, num_slots, &p, &slot);
  p = p < 0 ? 0 : (p >= max_pos ? max_pos - 1 : p);
  const float* cs = cos_sin + p * d;

  for (int head = warp; head < hq + 2 * hkv; head += nwarps) {
    const __nv_bfloat16* xh = x + static_cast<int64_t>(head) * d;
    if (head >= hq + hkv) {  // v head: a plain copy into the cache
      const int j = head - hq - hkv;
      __nv_bfloat16* dst = vcache + j * v_head_stride + slot * v_slot_stride;
      for (int i = lane; i < d; i += 32) dst[i] = xh[i];
      continue;
    }
    float x1[kMaxPairsPerLane], x2[kMaxPairsPerLane];
#pragma unroll
    for (int j = 0; j < kMaxPairsPerLane; ++j) {
      const int q = lane + 32 * j;
      x1[j] = q < half ? __bfloat162float(xh[q]) : 0.f;
      x2[j] = q < half ? __bfloat162float(xh[q + half]) : 0.f;
    }
    const bool is_q = head < hq;
    const float* w = is_q ? qw : kw;
    if (policy == 2) head_rmsnorm(x1, x2, half, lane, w, d);
#pragma unroll
    for (int j = 0; j < kMaxPairsPerLane; ++j) {
      const int q = lane + 32 * j;
      if (q < half) {
        const float c = cs[q], s = cs[q + half];
        const float a = x1[j], b = x2[j];
        x1[j] = a * c - b * s;
        x2[j] = b * c + a * s;
      }
    }
    if (policy == 1) head_rmsnorm(x1, x2, half, lane, w, d);
    __nv_bfloat16* dst =
        is_q ? q_out + (row * static_cast<int64_t>(hq) + head) * d
             : kcache + (head - hq) * k_head_stride + slot * k_slot_stride;
#pragma unroll
    for (int j = 0; j < kMaxPairsPerLane; ++j) {
      const int q = lane + 32 * j;
      if (q < half) {
        dst[q] = __float2bfloat16(x1[j]);
        dst[q + half] = __float2bfloat16(x2[j]);
      }
    }
  }
}

}  // namespace

extern "C" int hpc_rope_store_bf16(
    const void* qkv, const void* cos_sin, const void* seq_lens, const void* q_index,
    const void* block_ids, const void* qw, const void* kw, void* q_out, void* kcache,
    void* vcache, int rows, int hq, int hkv, int d, int max_pos, int num_req,
    int max_blocks, int page_size, int64_t num_slots, int64_t k_head_stride,
    int64_t k_slot_stride, int64_t v_head_stride, int64_t v_slot_stride,
    int policy, void* stream) {
  if (rows == 0) return 0;
  if (d % 2 != 0 || d > 2 * 32 * kMaxPairsPerLane || num_req < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int heads = hq + 2 * hkv;
  int threads = 32 * (heads < 8 ? heads : 8);
  rope_store_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(cos_sin), static_cast<const int32_t*>(seq_lens),
      static_cast<const int32_t*>(q_index), static_cast<const int32_t*>(block_ids),
      static_cast<const float*>(qw), static_cast<const float*>(kw),
      static_cast<__nv_bfloat16*>(q_out), static_cast<__nv_bfloat16*>(kcache),
      static_cast<__nv_bfloat16*>(vcache), hq, hkv, d, max_pos, num_req, max_blocks,
      page_size, num_slots, k_head_stride, k_slot_stride, v_head_stride,
      v_slot_stride, policy);
  return static_cast<int>(cudaGetLastError());
}
