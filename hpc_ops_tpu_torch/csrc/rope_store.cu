// Fused NeoX RoPE + optional per-head QK-RMSNorm + paged KV store, into a
// bf16 cache or, quantising, into the int8 NHD_FUSED slab.
//
// Replaces: hpc_ops_tpu/ops/rope_kernel.py:_rope_store_kernel (the Pallas
// kernel behind rope_store_rows / ops/rope.py:_rope_store_pallas), both its
// bf16 branch and its int8 branch (rope_kernel.py:100-116, reached from
// ops/rope.py:rope_norm_store_kv_int8 with cache_layout="NHD_FUSED").
//
// Bound on the card: bytes. Per token row it reads the qkv row
// ((Hq + 2*Hkv) * D bf16) and one cos|sin row (D f32), and writes the rotated
// q row (Hq * D bf16) plus one K row and one V row (Hkv * D elements each,
// bf16 or int8) into the cache. The arithmetic is a few FLOPs per element.
//
// Design: one block per token row, one warp per head (q heads, then k heads,
// then v heads, walked by the block's warps in turn). The block finds its
// row's request (binary search in q_index), position and cache slot itself,
// so the caller passes the step's tables once instead of per-row index
// arrays. As in the JAX package, a row that maps to no valid slot (past
// q_index[-1], or on a page id below 0) is sent to the cache's last K slot:
// the contract is that every row is a real token. A lane holds pairs
// (i, i + D/2) of its head in float32 registers, so the rotation needs no
// shared memory and the per-head RMSNorm is one warp-shuffle reduction. The
// K and V rows go straight to their (page, slot) address: the caller passes
// the cache strides, so one kernel serves the head-major HND cache
// ([Hkv, S, D], a token's head row is D contiguous elements), the NHD cache
// ([S, Hkv, D], a token's row is Hkv*D contiguous elements) and the
// NHD_FUSED slab ([nb, 2*bs, Hkv*D]: a page spans 2*bs slots, its K rows
// first and its V rows bs slots later, so V goes to the K slot + bs of the
// same buffer). Only the addressed rows are written; every other cache byte
// is left as it was. Launch overhead dominates at decode batch sizes.
//
// int8: codes are clip(rint(x * inv), +-127) (rint rounds half to even, as
// jnp.round), with inv = __frcp_rn(scale), the correctly rounded float32
// reciprocal: the same number as the JAX package's and the plain version's
// 1 / scale, read from device memory so the caller launches nothing more.
// The rotation is written with __fmul_rn so that the compiler cannot
// contract it into FMAs: with QK-norm off the codes then equal those of the
// plain float32 version bit for bit.

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

// One cache element from a float32 value (inv: the inverse scale, int8 only).
__device__ __forceinline__ void put(__nv_bfloat16* p, float x, float) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(int8_t* p, float x, float inv) {
  *p = static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(x, inv)), -127.f), 127.f));
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

// Row -> (position, K slot) as ops/rope.py's _row_mapping and
// ops/kv_cache.py's flat_slot_ids, with pages of page_stride slots, then the
// clip into the cache: an invalid row, or a slot past max_slot, lands on
// max_slot.
__device__ __forceinline__ void row_slot(int row, const int32_t* q_index,
                                         const int32_t* seq_lens, const int32_t* tbl,
                                         int num_req, int max_blocks, int page_size,
                                         int64_t page_stride, int64_t max_slot,
                                         int64_t* pos_out, int64_t* slot_out) {
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
  int64_t slot = max_slot;
  if (valid) {
    const int64_t blk = pos / page_size;
    if (blk < max_blocks) {
      const int phys = tbl[static_cast<int64_t>(req) * max_blocks + blk];
      if (phys >= 0) slot = min(static_cast<int64_t>(phys) * page_stride + pos % page_size, max_slot);
    }
  }
  *pos_out = pos;
  *slot_out = slot;
}

template <typename T>
__global__ void rope_store_kernel(
    const __nv_bfloat16* __restrict__ qkv,  // [rows, (hq + 2*hkv) * d]
    const float* __restrict__ cos_sin,      // [max_pos, d]: cos | sin
    const int32_t* __restrict__ seq_lens,   // [num_req] tokens incl. new
    const int32_t* __restrict__ q_index,    // [num_req + 1] row prefix sums
    const int32_t* __restrict__ tbl,        // [num_req, max_blocks] page table
    const float* __restrict__ qw,           // [d] (policy != 0)
    const float* __restrict__ kw,           // [d]
    const float* __restrict__ k_scale,      // [1] int8 only
    const float* __restrict__ v_scale,      // [1] int8 only
    __nv_bfloat16* __restrict__ q_out,      // [rows, hq * d]
    T* kcache, T* vcache,                   // may alias (NHD_FUSED)
    int hq, int hkv, int d, int max_pos, int num_req, int max_blocks,
    int page_size, int64_t page_stride, int64_t v_slot_off, int64_t max_slot,
    int64_t k_head_stride, int64_t k_slot_stride, int64_t v_head_stride,
    int64_t v_slot_stride, int policy) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int half = d / 2;
  const int64_t hidden = static_cast<int64_t>(hq + 2 * hkv) * d;
  const __nv_bfloat16* x = qkv + row * hidden;
  const float kinv = k_scale ? __frcp_rn(*k_scale) : 1.f;
  const float vinv = v_scale ? __frcp_rn(*v_scale) : 1.f;

  int64_t p, slot;
  row_slot(row, q_index, seq_lens, tbl, num_req, max_blocks, page_size, page_stride,
           max_slot, &p, &slot);
  p = p < 0 ? 0 : (p >= max_pos ? max_pos - 1 : p);
  const float* cs = cos_sin + p * d;

  for (int head = warp; head < hq + 2 * hkv; head += nwarps) {
    const __nv_bfloat16* xh = x + static_cast<int64_t>(head) * d;
    if (head >= hq + hkv) {  // v head: a copy (or quantisation) into the cache
      const int j = head - hq - hkv;
      T* dst = vcache + j * v_head_stride + (slot + v_slot_off) * v_slot_stride;
      for (int i = lane; i < d; i += 32) put(dst + i, __bfloat162float(xh[i]), vinv);
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
        x1[j] = __fmul_rn(a, c) - __fmul_rn(b, s);
        x2[j] = __fmul_rn(b, c) + __fmul_rn(a, s);
      }
    }
    if (policy == 1) head_rmsnorm(x1, x2, half, lane, w, d);
    if (is_q) {
      __nv_bfloat16* dst = q_out + (row * static_cast<int64_t>(hq) + head) * d;
#pragma unroll
      for (int j = 0; j < kMaxPairsPerLane; ++j) {
        const int q = lane + 32 * j;
        if (q < half) {
          dst[q] = __float2bfloat16(x1[j]);
          dst[q + half] = __float2bfloat16(x2[j]);
        }
      }
    } else {
      T* dst = kcache + (head - hq) * k_head_stride + slot * k_slot_stride;
#pragma unroll
      for (int j = 0; j < kMaxPairsPerLane; ++j) {
        const int q = lane + 32 * j;
        if (q < half) {
          put(dst + q, x1[j], kinv);
          put(dst + q + half, x2[j], kinv);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* qkv, const void* cos_sin, const void* seq_lens, const void* q_index,
           const void* block_ids, const void* qw, const void* kw, const void* k_scale,
           const void* v_scale, void* q_out, void* kcache, void* vcache, int rows, int hq,
           int hkv, int d, int max_pos, int num_req, int max_blocks, int page_size,
           int64_t page_stride, int64_t v_slot_off, int64_t max_slot, int64_t k_head_stride,
           int64_t k_slot_stride, int64_t v_head_stride, int64_t v_slot_stride, int policy,
           void* stream) {
  if (rows == 0) return 0;
  if (d % 2 != 0 || d > 2 * 32 * kMaxPairsPerLane || num_req < 1 || max_slot < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int heads = hq + 2 * hkv;
  const int threads = 32 * (heads < 8 ? heads : 8);
  rope_store_kernel<T><<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(cos_sin),
      static_cast<const int32_t*>(seq_lens), static_cast<const int32_t*>(q_index),
      static_cast<const int32_t*>(block_ids), static_cast<const float*>(qw),
      static_cast<const float*>(kw), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(q_out),
      static_cast<T*>(kcache), static_cast<T*>(vcache), hq, hkv, d, max_pos, num_req,
      max_blocks, page_size, page_stride, v_slot_off, max_slot, k_head_stride,
      k_slot_stride, v_head_stride, v_slot_stride, policy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 K and V caches, flat views with num_slots slots of page_size pages;
// strides in elements.
extern "C" int hpc_rope_store_bf16(
    const void* qkv, const void* cos_sin, const void* seq_lens, const void* q_index,
    const void* block_ids, const void* qw, const void* kw, void* q_out, void* kcache,
    void* vcache, int rows, int hq, int hkv, int d, int max_pos, int num_req,
    int max_blocks, int page_size, int64_t num_slots, int64_t k_head_stride,
    int64_t k_slot_stride, int64_t v_head_stride, int64_t v_slot_stride,
    int policy, void* stream) {
  return launch<__nv_bfloat16>(qkv, cos_sin, seq_lens, q_index, block_ids, qw, kw, nullptr,
                               nullptr, q_out, kcache, vcache, rows, hq, hkv, d, max_pos,
                               num_req, max_blocks, page_size, page_size, 0, num_slots - 1,
                               k_head_stride, k_slot_stride, v_head_stride, v_slot_stride,
                               policy, stream);
}

// The int8 NHD_FUSED slab [num_pages, 2*page_size, hkv*d]: K of (page p,
// offset o) at slot p*2*page_size + o, V at that slot + page_size; invalid
// rows land on K slot num_pages*2*page_size - 1 - page_size, so their V row
// is the slab's last slot. k_scale and v_scale are [1] float32 device scalars.
extern "C" int hpc_rope_store_int8(
    const void* qkv, const void* cos_sin, const void* seq_lens, const void* q_index,
    const void* block_ids, const void* qw, const void* kw, const void* k_scale,
    const void* v_scale, void* q_out, void* kv_slab, int rows, int hq, int hkv, int d,
    int max_pos, int num_req, int max_blocks, int page_size, int64_t num_pages,
    int policy, void* stream) {
  const int64_t slot_stride = static_cast<int64_t>(hkv) * d;
  const int64_t page_stride = 2 * static_cast<int64_t>(page_size);
  return launch<int8_t>(qkv, cos_sin, seq_lens, q_index, block_ids, qw, kw, k_scale, v_scale,
                        q_out, kv_slab, kv_slab, rows, hq, hkv, d, max_pos, num_req,
                        max_blocks, page_size, page_stride, page_size,
                        num_pages * page_stride - 1 - page_size, d, slot_stride, d,
                        slot_stride, policy, stream);
}
