// Paged GQA decode attention with MTP draft rows, over a KV cache of bf16,
// int8 codes or e4m3 (per-tensor scales, or one K scale per token and kv
// head), split K and V caches, the head-major FUSED K|V slab or the
// NHD_FUSED K|V slab; and its task-map (split-KV) form with the combine.
//
// Replaces: hpc_ops_tpu/ops/attention/decode.py:_decode_kernel (reached
// through _decode_pallas; launcher hpc_paged_decode),
// hpc_ops_tpu/ops/attention/decode.py:_decode_fused_kernel and
// _decode_fused_packed_kernel (reached through _decode_fused_pallas and
// _decode_fused_packed_pallas; both served by hpc_paged_decode over strided
// views of the slab: the packed variant runs R (request, head) pairs per
// TPU program only to save the TPU's per-grid-step overhead at short KV,
// which a CUDA grid does not pay), hpc_ops_tpu/ops/attention/decode.py:
// _decode_nhd_fused_kernel (reached through _decode_nhd_fused_pallas;
// launcher hpc_paged_decode_nhd_fused), hpc_ops_tpu/ops/attention/decode.py:
// _decode_qt0_kernel (reached through _decode_qt0_pallas; launcher
// hpc_paged_decode_qt0), hpc_ops_tpu/ops/attention/decode.py:
// _decode_tasks_kernel (reached through _decode_tasks_pallas; launcher
// hpc_paged_decode_tasks) and the plain-jnp _segment_combine after it
// (launcher hpc_decode_combine).
//
// Bound on the card: bytes. Each (request, kv head) streams its kv_len K and
// V rows once (2 * kv_len * D elements, 2 bytes each in bf16, 1 in int8 and
// e4m3) for only G * sq query rows, so the work is about G * sq FLOPs per
// byte, far below the ~295 FLOPs per byte at which the H100's tensor cores,
// not its memory, would be the limit. One-byte elements halve the bytes; the
// per-token K scales add 4 * kgroups bytes a token.
//
// Design: one block per (request, kv head), or in the task form one block
// per task of a task map (a contiguous KV range [tile_start * tile,
// (tile_start + num_tiles) * tile) of one request and kv head). The block
// stages its G * sq query rows in shared memory (float32, pre-scaled by
// sm_scale * kscale) and walks its KV positions in tiles of kTile = 128
// tokens through the page table:
//   1. one thread per token of the tile reads the token's K row with 16-byte
//      vector loads (8 bf16, or 16 int8 or e4m3 codes per load, converted to
//      float in registers; all 128 rows of the tile in flight at once) and
//      forms the scores of all rows against it; with per-token K scales
//      (kTokenScale) the token's kgroups scales, each over D / kgroups
//      consecutive columns, are read through the page table like the row and
//      each multiplies its group's float32 partial dot, score = sum_g
//      kscale[g] * dot(q[g], k[g]) (kgroups = 1: one scale per token and kv
//      head, the score times the scale); the block copies the tile's V rows
//      (as stored) into shared memory at the same time;
//   2. one warp per query row updates the online softmax (running max m,
//      running sum l) and turns the scores into probabilities;
//   3. every thread owns output columns and adds p * v for all rows.
// The output is acc / l * vscale (one scale, or with kTokenScale one per kv
// head). The task form writes the unnormalised float32 acc and the row's m
// and l instead (a row that saw no key keeps m = -inf, l = 0, acc = 0; a
// sentinel task of batch < 0 writes exactly that), and the combine kernel
// merges a segment's partials: one block per (request, kv head) finds the
// segment's tasks in task order, weights each partial by exp(m - max m)
// (0 where m = -inf) and writes sum(w * acc) / sum(w * l) * vscale, rounded
// once to bf16. Positions at or past kv_len are never
// read: their scores are -inf before the exponential and their V rows are
// zeros in shared memory, and a probability of 0 never multiplies a V value,
// so a page that holds NaN past kv_len cannot leak. Page ids below 0 are
// read as page 0. Row r of the block is (g = r / sq, s = r % sq) and sees
// keys up to kv_len - sq + s. Page, slot and head strides are arguments, so
// the same kernel reads the head-major HND cache, the NHD cache, the FUSED
// slab ([Hkv, nb, 2*bs, D]: V at K's address + bs*D) and the NHD_FUSED
// slab ([nb, 2*bs, Hkv*D]: K of head h, page p, slot s at
// p*2*bs*Hkv*D + s*Hkv*D + h*D, V at the same address + bs*Hkv*D) in place;
// K/V rows must be 16-byte aligned.
//
// Int8 codes convert to float exactly, and so does every e4m3 code,
// subnormals included (cvt.rn.f16x2.e4m3x2 to fp16, then to float; the NaN
// codes 0x7f and 0xff never come out of a saturating store). The TPU
// kernels' grid of one program per request (all kv heads, to save DMA
// descriptors) and the dense, gathered scale rows of _decode_qt0_kernel are
// not copied: a block here reads its own pages and scales.
//
// Known limit: in the grid form B * Hkv blocks (64 at B = 8, Hkv = 8) cannot
// fill 132 SMs, and a long request's tiles run in order in one block; the
// task form splits them across blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

struct e4m3_t {
  uint8_t bits;
};

// Two e4m3 bytes -> two floats (exact).
__device__ __forceinline__ float2 e4m3x2_to_float2(uint16_t two_bytes) {
  uint32_t h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h2) : "h"(two_bytes));
  return __half22float2(*reinterpret_cast<const __half2*>(&h2));
}

constexpr int kTile = 128;
constexpr int kThreads = 128;  // one thread per token of a tile
constexpr int kWarps = kThreads / 32;

// 16 bytes of cache elements -> floats.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void to_f32(const uint4& u, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 t = __bfloat1622float2(p[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) { return __bfloat162float(x); }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void to_f32(const uint4& u, float* f) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = static_cast<float>(p[j]);
  }
  static __device__ __forceinline__ float one(int8_t x) { return static_cast<float>(x); }
};

template <>
struct Vec<e4m3_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void to_f32(const uint4& u, float* f) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 t = e4m3x2_to_float2(p[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
  static __device__ __forceinline__ float one(e4m3_t x) {
    return e4m3x2_to_float2(static_cast<uint16_t>(x.bits)).x;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four rows' partial dots over K columns [c_lo, c_hi) of one token's row,
// added to s[0..3] (rows r0..r0+3; rows past `rows` untouched).
template <typename T>
__device__ __forceinline__ void dot4(const T* krow, const float* q_s, int d, int r0, int rows,
                                     int c_lo, int c_hi, float* s) {
  constexpr int kVec = Vec<T>::N;
#pragma unroll (32 / kVec)
  for (int c = c_lo; c < c_hi; c += kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(krow + c);
    float kf[kVec];
    Vec<T>::to_f32(u, kf);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      if (r0 + rr < rows) {
        const float* qr = q_s + (r0 + rr) * d + c;
        float acc4 = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; j += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(qr + j);
          acc4 += qa.x * kf[j] + qa.y * kf[j + 1] + qa.z * kf[j + 2] + qa.w * kf[j + 3];
        }
        s[rr] += acc4;
      }
    }
  }
}

// The task form's map and partial outputs (unused by the grid form).
struct Tasks {
  const int32_t* batch;       // [cap] request, < 0 for a sentinel task
  const int32_t* head;        // [cap] kv head
  const int32_t* tile_start;  // [cap] first work tile
  const int32_t* num_tiles;   // [cap] work tiles
  int tile;                   // tokens per work tile
  float* o;                   // [cap, rows, dv] unnormalised
  float* m;                   // [cap, rows] running max
  float* l;                   // [cap, rows] running sum
};

template <typename T, bool kTokenScale, bool kTasks>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B * sq, hq, d]
    const T* __restrict__ kc, const T* __restrict__ vc,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const int32_t* __restrict__ block_ids,  // [B, max_blocks]
    const int32_t* __restrict__ kv_lens,    // [B]
    // kTokenScale: kscale [num_pages, page_size, hkv, kgroups] per token, kv
    // head and group of D / kgroups columns, vscale [hkv]; else [1] each.
    // Null is a scale of 1.
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    __nv_bfloat16* __restrict__ out,        // [B * sq, hq, dv] (grid form)
    Tasks tasks,                            // (task form)
    int max_blocks, int page_size, int sq, int hq, int hkv, int d, int dv,
    int kgroups, float scale) {
  constexpr int kVec = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g_per = hq / hkv;
  const int rows = g_per * sq;
  const int tid = threadIdx.x;
  // this block's request, kv head and KV positions [lo, hi)
  int b, h, lo = 0, hi = INT_MAX;
  if constexpr (kTasks) {
    const int task = blockIdx.x;
    b = tasks.batch[task];
    if (b < 0) {  // sentinel: neutral partials, which the combine skips
      float* o = tasks.o + static_cast<int64_t>(task) * rows * dv;
      for (int i = tid; i < rows * dv; i += kThreads) o[i] = 0.f;
      for (int r = tid; r < rows; r += kThreads) {
        tasks.m[task * rows + r] = -INFINITY;
        tasks.l[task * rows + r] = 0.f;
      }
      return;
    }
    h = tasks.head[task];
    lo = tasks.tile_start[task] * tasks.tile;
    hi = lo + tasks.num_tiles[task] * tasks.tile;
  } else {
    b = blockIdx.x;
    h = blockIdx.y;
  }
  T* v_s = reinterpret_cast<T*>(smem_raw);                   // [kTile, dv]
  float* q_s = reinterpret_cast<float*>(v_s + kTile * dv);  // [rows, d]
  float* p_s = q_s + rows * d;                              // [rows, kTile]
  float* acc = p_s + rows * kTile;                          // [rows, dv]
  float* m_s = acc + rows * dv;                             // [rows]
  float* l_s = m_s + rows;                                  // [rows]
  float* alpha_s = l_s + rows;                              // [rows]

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kv_len = kv_lens[b];
  const int32_t* tbl = block_ids + static_cast<int64_t>(b) * max_blocks;
  const float qscale = scale * (!kTokenScale && kscale ? *kscale : 1.f);

  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int g = r / sq, s = r % sq;
    const int64_t src = (static_cast<int64_t>(b * sq + s) * hq + h * g_per + g) * d + c;
    q_s[i] = __bfloat162float(q[src]) * qscale;
  }
  for (int i = tid; i < rows * dv; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int n_valid = min(hi, min(kv_len, max_blocks * page_size));
  for (int t0 = lo; t0 < n_valid; t0 += kTile) {
    // 1a. V rows of the tile -> shared memory as stored (zeros past kv_len)
    const int vchunks = dv / kVec;
    for (int i = tid; i < kTile * vchunks; i += kThreads) {
      const int t = i / vchunks, c0 = (i % vchunks) * kVec;
      const int kpos = t0 + t;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kpos < n_valid) {
        const int page = max(tbl[kpos / page_size], 0);
        val = *reinterpret_cast<const uint4*>(vc + h * v_head_stride + page * v_page_stride +
                                              (kpos % page_size) * v_slot_stride + c0);
      }
      *reinterpret_cast<uint4*>(v_s + t * dv + c0) = val;
    }
    // 1b. scores: one thread per token, all rows, four rows per pass
    {
      const int t = tid;
      const int kpos = t0 + t;
      if (kpos < n_valid) {
        const int page = max(tbl[kpos / page_size], 0);
        const T* krow =
            kc + h * k_head_stride + page * k_page_stride + (kpos % page_size) * k_slot_stride;
        const float* ks = kTokenScale
            ? kscale + ((static_cast<int64_t>(page) * page_size + kpos % page_size) * hkv + h) * kgroups
            : nullptr;
        for (int r0 = 0; r0 < rows; r0 += 4) {
          float sc[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (kTokenScale) {
            const int gw = d / kgroups;
            for (int g = 0; g < kgroups; ++g) {
              float gs[4] = {0.f, 0.f, 0.f, 0.f};
              dot4(krow, q_s, d, r0, rows, g * gw, (g + 1) * gw, gs);
              const float kg = ks[g];
#pragma unroll
              for (int rr = 0; rr < 4; ++rr) sc[rr] += gs[rr] * kg;
            }
          } else {
            dot4(krow, q_s, d, r0, rows, 0, d, sc);
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int r = r0 + rr;
            if (r < rows) {
              const int limit = kv_len - sq + (r % sq);  // causal w.r.t. draft row
              p_s[r * kTile + t] = kpos <= limit ? sc[rr] : -INFINITY;
            }
          }
        }
      } else {
        for (int r = 0; r < rows; ++r) p_s[r * kTile + t] = -INFINITY;
      }
    }
    __syncthreads();
    // 2. online softmax: one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      float* pr = p_s + r * kTile;
      float mx = -INFINITY;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float e = m_new == -INFINITY || pr[t] == -INFINITY ? 0.f : __expf(pr[t] - m_new);
        pr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_prev == -INFINITY ? 0.f : __expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * alpha + p @ v
    const int n_here = min(kTile, n_valid - t0);
    for (int i = tid; i < rows * dv; i += kThreads) {
      const int r = i / dv, c = i % dv;
      const float* pr = p_s + r * kTile;
      float a = 0.f;
      for (int t = 0; t < n_here; ++t) {
        const float pv = pr[t];
        if (pv != 0.f) a += pv * Vec<T>::one(v_s[t * dv + c]);
      }
      acc[i] = acc[i] * alpha_s[r] + a;
    }
    __syncthreads();
  }

  if constexpr (kTasks) {
    const int64_t task = blockIdx.x;
    for (int i = tid; i < rows * dv; i += kThreads) tasks.o[task * rows * dv + i] = acc[i];
    for (int r = tid; r < rows; r += kThreads) {
      tasks.m[task * rows + r] = m_s[r];
      tasks.l[task * rows + r] = l_s[r];
    }
    return;
  }
  const float oscale = vscale ? vscale[kTokenScale ? h : 0] : 1.f;
  for (int i = tid; i < rows * dv; i += kThreads) {
    const int r = i / dv, c = i % dv;
    const int g = r / sq, s = r % sq;
    const float l = l_s[r];
    const float o = l == 0.f ? 0.f : acc[i] / l * oscale;
    out[(static_cast<int64_t>(b * sq + s) * hq + h * g_per + g) * dv + c] = __float2bfloat16(o);
  }
}

// Grid form: one block per (request, kv head) into `out`; task form (a
// non-null tasks): one block per task of the map's `batch` (capacity) tasks
// into the partials.
template <typename T, bool kTokenScale = false>
int launch(const void* q, const void* kcache, const void* vcache, const int64_t* st,
           const void* block_ids, const void* kv_lens, const void* kscale, const void* vscale,
           void* out, int batch, int max_blocks, int page_size, int sq, int hq, int hkv, int d,
           int dv, float scale, cudaStream_t stream, const Tasks* tasks = nullptr,
           int kgroups = 1) {
  constexpr int kVec = Vec<T>::N;
  if (batch == 0) return 0;
  if (d % kVec != 0 || dv % kVec != 0 || hq % hkv != 0 || kgroups < 1 || d % kgroups != 0 ||
      (d / kgroups) % kVec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = (hq / hkv) * sq;
  const size_t smem = sizeof(T) * static_cast<size_t>(kTile) * dv +
                      sizeof(float) * (static_cast<size_t>(rows) * (d + kTile + dv) + 3 * rows);
  auto run = [&](auto kernel, dim3 grid, const Tasks& tk) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kcache),
        static_cast<const T*>(vcache), st[0], st[1], st[2], st[3], st[4], st[5],
        static_cast<const int32_t*>(block_ids), static_cast<const int32_t*>(kv_lens),
        static_cast<const float*>(kscale), static_cast<const float*>(vscale),
        static_cast<__nv_bfloat16*>(out), tk, max_blocks, page_size, sq, hq, hkv, d, dv, kgroups,
        scale);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (!kTokenScale) {
    if (tasks != nullptr) return run(paged_decode_kernel<T, false, true>, dim3(batch), *tasks);
  }
  return run(paged_decode_kernel<T, kTokenScale, false>, dim3(batch, hkv), Tasks{});
}

// Cache element types of the launchers' kv_type argument.
enum KvType { kBf16 = 0, kInt8 = 1, kE4m3 = 2 };

int launch_typed(int kv_type, const void* q, const void* kcache, const void* vcache,
                 int64_t v_off, const int64_t* st, const void* block_ids, const void* kv_lens,
                 const void* kscale, const void* vscale, void* out, int batch, int max_blocks,
                 int page_size, int sq, int hq, int hkv, int d, int dv, float scale,
                 cudaStream_t stream, const Tasks* tasks = nullptr) {
  // v_off: elements from vcache to the first V row (the slab's K|V offset)
  switch (kv_type) {
    case kBf16:
      return launch<__nv_bfloat16>(
          q, kcache, static_cast<const __nv_bfloat16*>(vcache) + v_off, st, block_ids, kv_lens,
          kscale, vscale, out, batch, max_blocks, page_size, sq, hq, hkv, d, dv, scale, stream,
          tasks);
    case kInt8:
      return launch<int8_t>(
          q, kcache, static_cast<const int8_t*>(vcache) + v_off, st, block_ids, kv_lens, kscale,
          vscale, out, batch, max_blocks, page_size, sq, hq, hkv, d, dv, scale, stream, tasks);
    case kE4m3:
      return launch<e4m3_t>(
          q, kcache, static_cast<const e4m3_t*>(vcache) + v_off, st, block_ids, kv_lens, kscale,
          vscale, out, batch, max_blocks, page_size, sq, hq, hkv, d, dv, scale, stream, tasks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One block per segment (request b, kv head h): merges the segment's task
// partials into out[b * sq + s, h * g_per + g, :] for row r = g * sq + s.
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ o,  // [cap, rows, dv]
    const float* __restrict__ m,  // [cap, rows]
    const float* __restrict__ l,  // [cap, rows]
    const int32_t* __restrict__ t_batch, const int32_t* __restrict__ t_seg, int cap,
    const float* __restrict__ vscale,  // [1] or null (a scale of 1)
    __nv_bfloat16* __restrict__ out, int sq, int hq, int hkv, int dv) {
  extern __shared__ int task_s[];  // [cap]: the segment's tasks in task order
  __shared__ int warp_n[kWarps];
  const int seg = blockIdx.x;
  const int b = seg / hkv, h = seg % hkv;
  const int g_per = hq / hkv;
  const int rows = g_per * sq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // ordered compaction: a ballot per warp, warps in order, chunks in order
  int n = 0;
  for (int base = 0; base < cap; base += kThreads) {
    const int t = base + tid;
    const bool mine = t < cap && t_batch[t] >= 0 && t_seg[t] == seg;
    const unsigned bal = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_n[warp] = __popc(bal);
    __syncthreads();
    int off = n;
    for (int w = 0; w < warp; ++w) off += warp_n[w];
    if (mine) task_s[off + __popc(bal & ((1u << lane) - 1u))] = t;
    for (int w = 0; w < kWarps; ++w) n += warp_n[w];
    __syncthreads();
  }
  const float vs = vscale ? *vscale : 1.f;
  for (int i = tid; i < rows * dv; i += kThreads) {
    const int r = i / dv, c = i % dv;
    float mx = -INFINITY;
    for (int k = 0; k < n; ++k) mx = fmaxf(mx, m[task_s[k] * rows + r]);
    float osum = 0.f, lsum = 0.f;
    for (int k = 0; k < n; ++k) {
      const int64_t tr = static_cast<int64_t>(task_s[k]) * rows + r;
      const float mt = m[tr];
      const float w = mt == -INFINITY ? 0.f : expf(mt - mx);
      lsum += w * l[tr];
      osum += w * o[tr * dv + c];
    }
    const int g = r / sq, s = r % sq;
    const float val = lsum == 0.f ? 0.f : osum / lsum * vs;
    out[(static_cast<int64_t>(b * sq + s) * hq + h * g_per + g) * dv + c] = __float2bfloat16(val);
  }
}

}  // namespace

// Split K and V caches of kv_type (0 bf16, 1 int8, 2 e4m3); (head, page,
// slot) strides in elements. kscale and vscale are [1] float32 device
// scalars or null (a scale of 1).
extern "C" int hpc_paged_decode(
    const void* q, const void* kcache, const void* vcache, int kv_type,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const void* kscale, const void* vscale, const void* block_ids, const void* kv_lens,
    void* out, int batch, int max_blocks, int page_size, int sq, int hq, int hkv, int d, int dv,
    float scale, void* stream) {
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  return launch_typed(kv_type, q, kcache, vcache, 0, st, block_ids, kv_lens, kscale, vscale, out,
                      batch, max_blocks, page_size, sq, hq, hkv, d, dv, scale,
                      static_cast<cudaStream_t>(stream));
}

// QuantType 0: e4m3 K and V caches, kscale [num_pages, page_size, hkv,
// kgroups] float32 (per token and kv head, kgroups scales each over d /
// kgroups consecutive columns, a multiple of 16; paged like the cache),
// vscale [hkv] float32 or null.
extern "C" int hpc_paged_decode_qt0(
    const void* q, const void* kcache, const void* vcache,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const void* kscale, const void* vscale, const void* block_ids, const void* kv_lens,
    void* out, int batch, int max_blocks, int page_size, int sq, int hq, int hkv, int d, int dv,
    int kgroups, float scale, void* stream) {
  if (kscale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  return launch<e4m3_t, true>(q, kcache, vcache, st, block_ids, kv_lens, kscale, vscale, out,
                              batch, max_blocks, page_size, sq, hq, hkv, d, dv, scale,
                              static_cast<cudaStream_t>(stream), nullptr, kgroups);
}

// The NHD_FUSED slab [num_pages, 2*page_size, hkv*d] of kv_type. kscale and
// vscale are [1] float32 device scalars or null (a scale of 1).
extern "C" int hpc_paged_decode_nhd_fused(
    const void* q, const void* kv_slab, int kv_type, const void* kscale, const void* vscale,
    const void* block_ids, const void* kv_lens, void* out, int batch, int max_blocks,
    int page_size, int sq, int hq, int hkv, int d, float scale, void* stream) {
  const int64_t slot = static_cast<int64_t>(hkv) * d;
  const int64_t page = 2 * page_size * slot;
  const int64_t st[6] = {d, page, slot, d, page, slot};
  // a page's V rows follow its page_size K rows
  return launch_typed(kv_type, q, kv_slab, kv_slab, page_size * slot, st, block_ids, kv_lens,
                      kscale, vscale, out, batch, max_blocks, page_size, sq, hq, hkv, d, d, scale,
                      static_cast<cudaStream_t>(stream));
}

// Task form: K and V of kv_type read as [hkv, num_pages, page_size, d] with
// the given (head, page, slot) strides in elements (HND, NHD and both fused
// slabs in place), one block per task of the map's `cap` entries; writes
// the float32 partials o [cap, G*sq, dv] (unnormalised), m and l
// [cap, G*sq]. kscale is a [1] float32 device scalar or null; the V scale
// is the combine's.
extern "C" int hpc_paged_decode_tasks(
    const void* q, const void* kcache, const void* vcache, int kv_type,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const void* kscale, const void* t_batch, const void* t_head, const void* t_tile_start,
    const void* t_num_tiles, int cap, int tile, const void* block_ids, const void* kv_lens,
    void* o, void* m, void* l, int max_blocks, int page_size, int sq, int hq, int hkv, int d,
    int dv, float scale, void* stream) {
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  const Tasks tasks{static_cast<const int32_t*>(t_batch), static_cast<const int32_t*>(t_head),
                    static_cast<const int32_t*>(t_tile_start),
                    static_cast<const int32_t*>(t_num_tiles), tile, static_cast<float*>(o),
                    static_cast<float*>(m), static_cast<float*>(l)};
  return launch_typed(kv_type, q, kcache, vcache, 0, st, block_ids, kv_lens, kscale, nullptr,
                      nullptr, cap, max_blocks, page_size, sq, hq, hkv, d, dv, scale,
                      static_cast<cudaStream_t>(stream), &tasks);
}

// Merges the task partials of hpc_paged_decode_tasks by segment (request *
// hkv + kv head; tasks with t_batch < 0 skipped) into out [B*sq, hq, dv]
// bf16, times vscale ([1] float32 or null).
extern "C" int hpc_decode_combine(
    const void* o, const void* m, const void* l, const void* t_batch, const void* t_seg, int cap,
    const void* vscale, void* out, int batch, int sq, int hq, int hkv, int dv, void* stream) {
  if (batch == 0) return 0;
  if (hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * static_cast<size_t>(cap);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_combine_kernel<<<batch * hkv, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const int32_t*>(t_batch), static_cast<const int32_t*>(t_seg), cap,
      static_cast<const float*>(vscale), static_cast<__nv_bfloat16*>(out), sq, hq, hkv, dv);
  return static_cast<int>(cudaGetLastError());
}
