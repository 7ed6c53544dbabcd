// Varlen causal prefill attention over a paged KV cache of bf16, int8 codes
// or e4m3 (per-tensor scales, or one K scale per token and kv head), split K
// and V caches or the NHD_FUSED K|V slab.
//
// Replaces: hpc_ops_tpu/ops/attention/prefill.py:_prefill_kernel (reached
// through _prefill_pallas, dense path with its pertoken_ks option; launcher
// hpc_paged_prefill) and hpc_ops_tpu/ops/attention/prefill.py:_prefill_nhd_fused_kernel
// (reached through _prefill_nhd_fused_pallas; launcher
// hpc_paged_prefill_nhd_fused).
//
// Bound on the card: operations. A q tile of Q tokens reads each K/V row of
// its causal prefix once for G * Q query rows, so long prompts do
// O(q_len * kv_len * D) FLOPs against O(kv_len * D) bytes per tile.
//
// Design: one block per (request, kv head, q tile). The tile holds
// kRows = 64 query rows: Q = 64 / G tokens times the G query heads of the
// kv head's group (row m is token m / G, head m % G), so every K/V row
// brought into shared memory serves the whole GQA group. q is read from, and
// o written to, the packed [total_q, Hq * D] rows directly through
// cu_seqlens. The block walks KV tiles of kCols = 64 positions up to its
// causal limit through the page table (page ids below 0 read page 0):
//   * K (transposed) and V tiles are staged in shared memory as float32
//     (8 elements per thread and load: 16 bytes of bf16, 8 of int8 or e4m3
//     codes; every e4m3 code, subnormals included, converts exactly through
//     cvt.rn.f16x2.e4m3x2);
//   * each thread computes a 4 x 4 block of scores from float4 reads and
//     keeps it in registers; with per-token K scales (ktok, [num_pages,
//     page_size, hkv, kgroups] float32, read through the page table beside
//     the K tile) and kgroups = 1, column j is multiplied by the scale of
//     its token after the dot, exact because the scale is constant along D;
//     with kgroups > 1 (each scale over D / kgroups consecutive columns)
//     every K element is multiplied by its group's scale as the tile is
//     staged, so the dot is sum_g ktok[g] * dot(q[g], k[g]) in exact
//     arithmetic and rounds as the dequantised K of the plain version does
//     (per-group accumulators in registers and the scales in shared memory
//     cost the dense path its second block per SM: 1.99 ms against 1.52
//     for 2048 tokens, chip_smoke.py check_prefill_fp8 on an H100); the causal mask
//     kpos <= (kv_len - q_len) + qpos is applied before the exponential;
//   * the online softmax reduces each row across the 16 threads that hold
//     it with warp shuffles, rescales the thread's 4 x (D/16) output
//     accumulator in registers, and writes the probabilities back to shared
//     memory for the p @ v product.
// Everything is float32 (no bf16 exponent tricks). The logit scale is
// sm_scale * kscale (folded into q), the output acc / l * vscale (one scale,
// or one per kv head: vscale_per_head). Page,
// slot and head strides are arguments, so HND, NHD and the NHD_FUSED slab
// ([nb, 2*bs, Hkv*D], V rows bs slots after the page's K rows) are read in
// place. Rows of the output past cu_seqlens[B] belong to no request; the
// wrapper zero-fills them.
//
// Block-sparse form (kSparse; replaces
// hpc_ops_tpu/ops/attention/prefill.py:_prefill_sparse_kernel, reached
// through _prefill_sparse_pallas; launcher hpc_paged_prefill_sparse): the
// same kernel with a uint8 mask [B, hq, n_tm, n_tkv]. Row i of a request
// lies in mask row i / mask_tile_q, key position p in mask column
// p / mask_tile_kv; a mask entry past the mask's edge reads as 0. First the
// block's threads, one KV tile of 64 columns each, OR the entries that cover
// the block's rows (every head of the GQA group) and the tile's columns into
// one flag a tile in shared memory (the TPU kernel's active-chunk list);
// the walk over the KV tiles then skips every tile whose flag is 0: no K/V
// load, no scale read, no math, no barrier. That skip is the sparse
// kernel's whole gain: its bound is the kept tiles' bytes and operations.
// In a kept tile each (row, column) logit is masked by its own head's entry
// beside the causal mask, so any mask tile size gives the same function;
// when every entry over the tile is set (the usual case for masks of 64
// columns or more shared by a GQA group) that lookup is skipped: done in
// every kept tile, the lookup (a division and a byte load a logit) made
// the sparse call 1.6x as long on an H100 (chip_smoke.py prefill_sparse).
// A row with no kept key comes back 0, as the TPU kernel writes it.
//
// Known limit: the products run on the CUDA cores in float32, not on the
// tensor cores (wgmma); that is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct e4m3_t {
  uint8_t bits;
};

constexpr int kRows = 64;
constexpr int kCols = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxGroups = 8;  // K scales per (token, kv head); a group spans >= 8 columns

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 cache elements at p (16-byte aligned for bf16, 8-byte for int8) -> floats.
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

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void load8(const e4m3_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint16_t* c = reinterpret_cast<const uint16_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h2;
    asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h2) : "h"(c[i]));
    const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&h2));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The block mask of the sparse form (mask null: the dense form).
struct BlockMask {
  const uint8_t* bits;  // [batch, hq, n_tm, n_tkv]
  int n_tm, n_tkv, tile_q, tile_kv;
};

template <int D, typename T, bool kSparse>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [rows, hq * D]
    const T* __restrict__ kc, const T* __restrict__ vc,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const int32_t* __restrict__ cu, const int32_t* __restrict__ kv_lens,
    const int32_t* __restrict__ block_ids, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const float* __restrict__ ktok,
    __nv_bfloat16* __restrict__ out, int max_blocks, int page_size, int hq, int hkv, int q_tile,
    int vscale_per_head, int kgroups, float scale, BlockMask bm) {
  constexpr int kColGroups = D / 64;  // output columns c = k*64 + tx*4 + e
  extern __shared__ float smem[];
  float* qt_s = smem;              // [D][kRows], pre-scaled
  float* kt_s = qt_s + D * kRows;  // [D][kCols]
  float* v_s = kt_s + D * kCols;   // [kCols][D]
  float* pt_s = v_s + kCols * D;   // [kCols][kRows]
  // sparse: one flag per KV tile of the page table
  uint8_t* tile_flag_s = reinterpret_cast<uint8_t*>(pt_s + kCols * kRows);
  __shared__ float ktok_s[kCols];  // the tile's per-token K scales (kgroups = 1)

  const int b = blockIdx.x, h = blockIdx.y;
  const int g_per = hq / hkv;
  const int q_start = cu[b];
  const int q_len = cu[b + 1] - q_start;
  const int i0 = blockIdx.z * q_tile;
  if (i0 >= q_len) return;
  const int n_tok = min(q_tile, q_len - i0);
  const int rows_used = n_tok * g_per;
  const int kv_len = kv_lens[b];
  const int kv_off = kv_len - q_len;
  const int kv_end = min(min(kv_len, kv_off + i0 + n_tok), max_blocks * page_size);
  const int32_t* tbl = block_ids + static_cast<int64_t>(b) * max_blocks;
  const int64_t row_stride = static_cast<int64_t>(hq) * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float qscale = scale * (kscale ? *kscale : 1.f);

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int m = idx / D, c = idx % D;
    float val = 0.f;
    if (m < rows_used) {
      const int64_t src = (q_start + i0 + m / g_per) * row_stride + (h * g_per + m % g_per) * D + c;
      val = __bfloat162float(q[src]) * qscale;
    }
    qt_s[c * kRows + m] = val;
  }

  float o[4][4 * kColGroups];
  float m_i[4], l_i[4];
  int limit[4];
  const uint8_t* mrow[4];  // sparse: each row's mask row (null: no entry, all masked)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    limit[i] = r < rows_used ? kv_off + i0 + r / g_per : -1;
    mrow[i] = nullptr;
    if constexpr (kSparse) {
      const int tq = (i0 + r / g_per) / bm.tile_q;
      if (r < rows_used && tq < bm.n_tm)
        mrow[i] = bm.bits + ((static_cast<int64_t>(b) * hq + h * g_per + r % g_per) * bm.n_tm + tq) *
                                bm.n_tkv;
    }
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kColGroups; ++c) o[i][c] = 0.f;
  }

  // sparse: one flag per KV tile, from the mask rows the block's rows span
  // and the mask columns the tile spans (entries past the mask's edge are
  // 0): 0 skip, 1 kept, 2 kept with every entry set (no per-logit lookup)
  bool full = true;
  if constexpr (kSparse) {
    const int tm_lo = i0 / bm.tile_q, tm_hi = (i0 + n_tok - 1) / bm.tile_q;
    const int tm_n = min(tm_hi, bm.n_tm - 1) - tm_lo + 1;
    for (int t = tid; t * kCols < kv_end; t += kThreads) {
      const int tk_lo = t * kCols / bm.tile_kv;
      const int tk_hi = (min(t * kCols + kCols, kv_end) - 1) / bm.tile_kv;
      const int tk_n = min(tk_hi, bm.n_tkv - 1) - tk_lo + 1;
      int kept = 0, all = tm_hi < bm.n_tm && tk_hi < bm.n_tkv;
      const int n_entries = tm_n > 0 && tk_n > 0 ? g_per * tm_n * tk_n : 0;
      for (int e = 0; e < n_entries; ++e) {
        const int g = e % g_per, rest = e / g_per;
        const int tq = tm_lo + rest % tm_n, tk = tk_lo + rest / tm_n;
        const int bit =
            bm.bits[((static_cast<int64_t>(b) * hq + h * g_per + g) * bm.n_tm + tq) * bm.n_tkv + tk];
        kept |= bit;
        all &= bit != 0;
      }
      tile_flag_s[t] = kept ? (all ? 2 : 1) : 0;
    }
    __syncthreads();
  }

  for (int t0 = 0; t0 < kv_end; t0 += kCols) {
    if constexpr (kSparse) {
      const uint8_t flag = tile_flag_s[t0 / kCols];  // the block's threads agree
      if (flag == 0) continue;  // no K/V loads, no math for this tile
      full = flag == 2;
    }
    __syncthreads();  // previous tile's readers are done
    // K tile, transposed: two threads per 16 columns of a row
    for (int idx = tid; idx < kCols * D / 8; idx += kThreads) {
      const int pair = idx & 1;
      const int n = (idx >> 1) % kCols;
      const int d0 = ((idx >> 1) / kCols) * 16 + pair * 8;
      const int kpos = t0 + n;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kpos < kv_end) {
        const int page = max(tbl[kpos / page_size], 0);
        load8(kc + h * k_head_stride + page * k_page_stride + (kpos % page_size) * k_slot_stride + d0,
              f);
        if (ktok != nullptr && kgroups > 1) {  // the 8 columns lie in one group
          const float ks =
              ktok[((static_cast<int64_t>(page) * page_size + kpos % page_size) * hkv + h) * kgroups +
                   d0 / (D / kgroups)];
#pragma unroll
          for (int j = 0; j < 8; ++j) f[j] *= ks;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) kt_s[(d0 + j) * kCols + n] = f[j];
    }
    if (ktok != nullptr && kgroups == 1 && tid < kCols) {
      const int kpos = t0 + tid;
      float ks = 0.f;
      if (kpos < kv_end) {
        const int64_t page = max(tbl[kpos / page_size], 0);
        ks = ktok[(page * page_size + kpos % page_size) * hkv + h];
      }
      ktok_s[tid] = ks;
    }
    // V tile, row-major
    for (int idx = tid; idx < kCols * D / 8; idx += kThreads) {
      const int n = idx / (D / 8);
      const int c0 = (idx % (D / 8)) * 8;
      const int kpos = t0 + n;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kpos < kv_end) {
        const int page = max(tbl[kpos / page_size], 0);
        load8(vc + h * v_head_stride + page * v_page_stride + (kpos % page_size) * v_slot_stride + c0,
              f);
      }
      float4* dst = reinterpret_cast<float4*>(v_s + n * D + c0);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt_s + d * kRows + ty * 4);
      const float4 k4 = *reinterpret_cast<const float4*>(kt_s + d * kCols + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * kv[j];
    }

    if (ktok != nullptr && kgroups == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ks = ktok_s[tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] *= ks;
      }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = t0 + tx * 4 + j;
        if (!(kpos <= limit[i] && kpos < kv_end)) {
          s[i][j] = -INFINITY;
        } else if constexpr (kSparse) {
          const int tk = kpos / bm.tile_kv;
          if (!full && (mrow[i] == nullptr || tk >= bm.n_tkv || !mrow[i][tk])) s[i][j] = -INFINITY;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = s[i][j] == -INFINITY ? 0.f : __expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      sum = group16_sum(sum);
      const float alpha = m_i[i] == -INFINITY ? 0.f : __expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kColGroups; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt_s + (tx * 4 + j) * kRows + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

    const int n_here = min(kCols, kv_end - t0);
    for (int n = 0; n < n_here; ++n) {
      const float4 pv = *reinterpret_cast<const float4*>(pt_s + n * kRows + ty * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int k = 0; k < kColGroups; ++k) {
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + n * D + k * 64 + tx * 4);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (pr[i] == 0.f) continue;  // a masked position never touches V
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][k * 4 + e] += pr[i] * vv[e];
        }
      }
    }
  }

  const float oscale = vscale ? vscale[vscale_per_head ? h : 0] : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows_used) continue;
    const float inv = l_i[i] == 0.f ? 0.f : oscale / l_i[i];
    __nv_bfloat16* dst = out + (q_start + i0 + r / g_per) * row_stride + (h * g_per + r % g_per) * D;
#pragma unroll
    for (int k = 0; k < kColGroups; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[k * 64 + tx * 4 + e] = __float2bfloat16(o[i][k * 4 + e] * inv);
  }
}

template <int D, typename T, bool kSparse>
int launch_form(const void* q, const void* kc, const void* vc, const int64_t* st,
                const void* cu, const void* kv_lens, const void* block_ids, const void* kscale,
                const void* vscale, const void* ktok, void* out, int batch, int max_blocks,
                int page_size, int hq, int hkv, int n_q_tiles, int q_tile, int vscale_per_head,
                int kgroups, float scale, BlockMask bm, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(D) * (kRows + kCols) +
                                       static_cast<size_t>(kCols) * (D + kRows)) +
                      (kSparse ? (static_cast<size_t>(max_blocks) * page_size + kCols - 1) / kCols : 0);
  cudaError_t e = cudaFuncSetAttribute(paged_prefill_kernel<D, T, kSparse>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(batch, hkv, n_q_tiles);
  paged_prefill_kernel<D, T, kSparse><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), st[0], st[1], st[2], st[3], st[4], st[5],
      static_cast<const int32_t*>(cu), static_cast<const int32_t*>(kv_lens),
      static_cast<const int32_t*>(block_ids), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const float*>(ktok),
      static_cast<__nv_bfloat16*>(out), max_blocks, page_size, hq, hkv, q_tile, vscale_per_head,
      kgroups, scale, bm);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch(const void* q, const void* kc, const void* vc, const int64_t* st,
           const void* cu, const void* kv_lens, const void* block_ids, const void* kscale,
           const void* vscale, const void* ktok, void* out, int batch, int max_blocks,
           int page_size, int hq, int hkv, int n_q_tiles, int q_tile, int vscale_per_head,
           int kgroups, float scale, BlockMask bm, cudaStream_t stream) {
  if (bm.bits != nullptr)
    return launch_form<D, T, true>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok,
                                   out, batch, max_blocks, page_size, hq, hkv, n_q_tiles, q_tile,
                                   vscale_per_head, kgroups, scale, bm, stream);
  return launch_form<D, T, false>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok,
                                  out, batch, max_blocks, page_size, hq, hkv, n_q_tiles, q_tile,
                                  vscale_per_head, kgroups, scale, bm, stream);
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc, const int64_t* st,
             const void* cu, const void* kv_lens, const void* block_ids, const void* kscale,
             const void* vscale, const void* ktok, void* out, int batch, int max_blocks,
             int page_size, int hq, int hkv, int d, int max_seqlens_q, int vscale_per_head,
             int kgroups, float scale, BlockMask bm, cudaStream_t stream) {
  if (hq % hkv != 0 || hq / hkv > kRows || kgroups < 1 || kgroups > kMaxGroups || d % kgroups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || max_seqlens_q == 0) return 0;
  const int q_tile = kRows / (hq / hkv);
  const int n_q_tiles = (max_seqlens_q + q_tile - 1) / q_tile;
  switch (d) {
    case 64:
      return launch<64, T>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok, out,
                           batch, max_blocks, page_size, hq, hkv, n_q_tiles, q_tile,
                           vscale_per_head, kgroups, scale, bm, stream);
    case 128:
      return launch<128, T>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok, out,
                            batch, max_blocks, page_size, hq, hkv, n_q_tiles, q_tile,
                            vscale_per_head, kgroups, scale, bm, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Cache element types of the launchers' kv_type argument.
enum KvType { kBf16 = 0, kInt8 = 1, kE4m3 = 2 };

int launch_typed(int kv_type, const void* q, const void* kc, const void* vc, int64_t v_off,
                 const int64_t* st, const void* cu, const void* kv_lens, const void* block_ids,
                 const void* kscale, const void* vscale, const void* ktok, void* out, int batch,
                 int max_blocks, int page_size, int hq, int hkv, int d, int max_seqlens_q,
                 int vscale_per_head, int kgroups, float scale, BlockMask bm, cudaStream_t stream) {
  // v_off: elements from vc to the first V row (the slab's K|V offset)
  switch (kv_type) {
    case kBf16:
      return launch_d<__nv_bfloat16>(
          q, kc, static_cast<const __nv_bfloat16*>(vc) + v_off, st, cu, kv_lens, block_ids, kscale,
          vscale, ktok, out, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
          vscale_per_head, kgroups, scale, bm, stream);
    case kInt8:
      return launch_d<int8_t>(
          q, kc, static_cast<const int8_t*>(vc) + v_off, st, cu, kv_lens, block_ids, kscale,
          vscale, ktok, out, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
          vscale_per_head, kgroups, scale, bm, stream);
    case kE4m3:
      return launch_d<e4m3_t>(
          q, kc, static_cast<const e4m3_t*>(vc) + v_off, st, cu, kv_lens, block_ids, kscale,
          vscale, ktok, out, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
          vscale_per_head, kgroups, scale, bm, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr BlockMask kDense = {nullptr, 0, 0, 1, 1};

}  // namespace

// Split K and V caches of kv_type (0 bf16, 1 int8, 2 e4m3); (head, page,
// slot) strides in elements. Launches one block per (request, kv head, q
// tile of 64 / G tokens) and returns a cudaError_t code. d (the head dim of
// q, K and V) is 64 or 128. kscale is a [1] float32 device scalar; vscale is
// [1], or [hkv] with vscale_per_head; ktok is [num_pages, page_size, hkv,
// kgroups] float32, kgroups (1..8, dividing d) K scales per token and kv
// head, each over d / kgroups consecutive columns. Each may be null (a scale
// of 1).
extern "C" int hpc_paged_prefill(
    const void* q, const void* kcache, const void* vcache, int kv_type,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const void* kscale, const void* vscale, const void* ktok,
    const void* cu, const void* kv_lens, const void* block_ids, void* out,
    int batch, int max_blocks, int page_size, int hq, int hkv, int d,
    int max_seqlens_q, int vscale_per_head, int kgroups, float scale, void* stream) {
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  return launch_typed(kv_type, q, kcache, vcache, 0, st, cu, kv_lens, block_ids, kscale, vscale,
                      ktok, out, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
                      vscale_per_head, kgroups, scale, kDense, static_cast<cudaStream_t>(stream));
}

// The NHD_FUSED slab [num_pages, 2*page_size, hkv*d] of kv_type. kscale and
// vscale are [1] float32 device scalars or null (a scale of 1).
extern "C" int hpc_paged_prefill_nhd_fused(
    const void* q, const void* kv_slab, int kv_type, const void* kscale, const void* vscale,
    const void* cu, const void* kv_lens, const void* block_ids, void* out, int batch,
    int max_blocks, int page_size, int hq, int hkv, int d, int max_seqlens_q, float scale,
    void* stream) {
  const int64_t slot = static_cast<int64_t>(hkv) * d;
  const int64_t page = 2 * page_size * slot;
  const int64_t st[6] = {d, page, slot, d, page, slot};
  // a page's V rows follow its page_size K rows
  return launch_typed(kv_type, q, kv_slab, kv_slab, page_size * slot, st, cu, kv_lens, block_ids,
                      kscale, vscale, nullptr, out, batch, max_blocks, page_size, hq, hkv, d,
                      max_seqlens_q, 0, 1, scale, kDense, static_cast<cudaStream_t>(stream));
}

// The block-sparse form over split K and V caches, arguments as
// hpc_paged_prefill's plus the uint8 mask [batch, hq, n_tm, n_tkv] and its
// tile sizes (tokens per mask row and per mask column, each >= 1).
extern "C" int hpc_paged_prefill_sparse(
    const void* q, const void* kcache, const void* vcache, int kv_type,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const void* kscale, const void* vscale, const void* ktok,
    const void* cu, const void* kv_lens, const void* block_ids, const void* mask, void* out,
    int batch, int max_blocks, int page_size, int hq, int hkv, int d,
    int max_seqlens_q, int vscale_per_head, int kgroups, int n_tm, int n_tkv, int mask_tile_q,
    int mask_tile_kv, float scale, void* stream) {
  if (mask == nullptr || n_tm < 1 || n_tkv < 1 || mask_tile_q < 1 || mask_tile_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  const BlockMask bm = {static_cast<const uint8_t*>(mask), n_tm, n_tkv, mask_tile_q, mask_tile_kv};
  return launch_typed(kv_type, q, kcache, vcache, 0, st, cu, kv_lens, block_ids, kscale, vscale,
                      ktok, out, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
                      vscale_per_head, kgroups, scale, bm, static_cast<cudaStream_t>(stream));
}
