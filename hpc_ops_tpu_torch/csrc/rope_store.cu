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
// A decode step moves about 200 KB, a fraction of a microsecond at 3.35 TB/s,
// so there the kernel's time is its chain of dependent memory round trips;
// a prefill of thousands of rows needs enough bytes in flight.
//
// Design: the unit of work is one (row, head) pair. A group of `lanes`
// consecutive threads (a power of two, at most a warp) owns one head, and a
// block owns `heads_per_block` heads of one row, so a decode step of 8 rows
// spreads its 384 pairs (llama3_8b) over about a hundred blocks. A lane holds
// `vec` consecutive elements of each half of its head (NeoX pairs element i
// with i + D/2), 8 where D/2 allows, and loads and stores them as one word:
// 16 bytes of bf16, 32 of float32 cos|sin, 8 of int8 codes; a narrower `vec`
// where D/2 or a pointer's alignment does not allow 8, more than one chunk
// a lane where D/2 exceeds 32 lanes' worth. The host picks the form
// (ops/rope_kernel.py:rope_form). The per-head RMSNorm is a shuffle
// reduction over the lanes of one head, with that group's mask.
//
// Every thread issues its qkv loads first, then maps its row to (position,
// slot) as ops/rope.py's _row_mapping and ops/kv_cache.py's flat_slot_ids
// do: it guesses that row r belongs to request min(r, num_req - 1), which
// holds for a decode step (one row a request) and for a single prefill, and
// reads that request's q_index pair and length in one round trip; only when
// the guess misses does it binary-search q_index. Then the cos|sin row and
// the page-table entry, in one more round trip, then the stores. As in the
// JAX package, a row that maps to no valid slot (past q_index[-1], or on a
// page id below 0) is sent to the cache's last K slot: the contract is that
// every row is a real token. The K and V rows go straight to their (page,
// slot) address: one kernel serves the head-major HND cache ([Hkv, S, D]),
// the NHD cache ([S, Hkv, D]) and the NHD_FUSED slab ([nb, 2*bs, Hkv*D]: a
// page spans 2*bs slots, its K rows first and its V rows bs slots later, so
// V goes to the K slot + bs of the same buffer). Only the addressed rows are
// written; every other cache byte is left as it was.
//
// int8: codes are clip(rint(x * inv), +-127) (rint rounds half to even, as
// jnp.round), with inv = __frcp_rn(scale), the correctly rounded float32
// reciprocal: the same number as the JAX package's and the plain version's
// 1 / scale, read from device memory so the caller launches nothing more.
// The rotation is written with __fmul_rn so that the compiler cannot
// contract it into FMAs: with QK-norm off the codes then equal those of the
// plain float32 version bit for bit. bf16 V rows are copied as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's sizes and form, filled once per shape by the wrapper
// (ops/rope_kernel.py:_RopeShape mirrors this layout field for field).
struct RopeShape {
  int rows, hq, hkv, d, max_pos, num_req, max_blocks, page_size, policy;
  int vec, lanes, heads_per_block;  // the form: ops/rope_kernel.py:rope_form
  int head_major;                   // bf16 caches: HND (1) or NHD (0)
  int64_t num_slots;                // bf16: slots of the flat caches; int8: pages of the slab
};

namespace {

constexpr int kMaxElems = 8;  // elements of each half a lane holds: vec * chunks
constexpr float kNormEps = 1e-6f;

template <int N> struct Word;  // an aligned N-byte word
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// N bytes from src to dst, as one word (two for 32 bytes); both aligned to N.
template <int N>
__device__ __forceinline__ void copy(void* dst, const void* src) {
  if constexpr (N > 16) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
  } else {
    *reinterpret_cast<typename Word<N>::T*>(dst) = *reinterpret_cast<const typename Word<N>::T*>(src);
  }
}

// VEC cache elements from float32 values (inv: the inverse scale, int8 only).
template <int VEC>
__device__ __forceinline__ void put(__nv_bfloat16* p, const float* x, float) {
  __align__(16) __nv_bfloat16 o[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = __float2bfloat16(x[e]);
  copy<2 * VEC>(p, o);
}
template <int VEC>
__device__ __forceinline__ void put(int8_t* p, const float* x, float inv) {
  __align__(8) int8_t o[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    o[e] = static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(x[e], inv)), -127.f), 127.f));
  }
  copy<VEC>(p, o);
}

// A V chunk: bf16 copied as it is, int8 quantised.
template <int VEC>
__device__ __forceinline__ void put_v(__nv_bfloat16* p, const __nv_bfloat16* r, float) {
  copy<2 * VEC>(p, r);
}
template <int VEC>
__device__ __forceinline__ void put_v(int8_t* p, const __nv_bfloat16* r, float inv) {
  float x[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) x[e] = __bfloat162float(r[e]);
  put<VEC>(p, x, inv);
}

// Scales x1/x2 (this lane's chunks) by rsqrt(mean(x^2) + eps) * w; the sum
// of squares is reduced over the head's group of lanes (mask gmask).
template <int VEC>
__device__ __forceinline__ void head_rmsnorm(float* x1, float* x2, int lane, int lanes, int half,
                                             const float* w, int d, unsigned gmask) {
  constexpr int kChunks = kMaxElems / VEC;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if ((lane + j * lanes) * VEC < half) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss += x1[j * VEC + e] * x1[j * VEC + e] + x2[j * VEC + e] * x2[j * VEC + e];
      }
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(gmask, ss, o);
  const float inv = rsqrtf(ss / static_cast<float>(d) + kNormEps);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (lane + j * lanes) * VEC;
    if (c < half) {
      __align__(16) float w1[VEC], w2[VEC];
      copy<4 * VEC>(w1, w + c);
      copy<4 * VEC>(w2, w + half + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        x1[j * VEC + e] = x1[j * VEC + e] * inv * w1[e];
        x2[j * VEC + e] = x2[j * VEC + e] * inv * w2[e];
      }
    }
  }
}

// Where the K/V rows go: pages of page_stride slots, V at v_slot_off slots
// past K, an invalid row or a slot past max_slot clipped to max_slot;
// element strides of (head, slot).
struct CacheGeom {
  int64_t page_stride, v_slot_off, max_slot, head_stride, slot_stride;
};

// Row -> (position, K slot). The request is guessed as min(row, num_req - 1)
// and its q_index pair and length read in one round trip; a miss falls back
// to the binary search (the first request with q_index[req + 1] > row).
__device__ __forceinline__ void row_slot(int row, const int32_t* __restrict__ q_index,
                                         const int32_t* __restrict__ seq_lens,
                                         const int32_t* __restrict__ tbl, const RopeShape& s,
                                         const CacheGeom& g, int64_t* pos_out,
                                         int64_t* slot_out) {
  int req = min(row, s.num_req - 1);
  int q_start = q_index[req], q_end = q_index[req + 1], len = seq_lens[req];
  bool valid = q_start <= row && row < q_end;  // then row < q_index[num_req] too
  if (!valid) {
    int lo = 0, hi = s.num_req;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (q_index[mid + 1] > row) hi = mid; else lo = mid + 1;
    }
    req = min(lo, s.num_req - 1);
    q_start = q_index[req];
    q_end = q_index[req + 1];
    len = seq_lens[req];
    valid = row < q_index[s.num_req] && q_end > q_start;
  }
  const int64_t pos = static_cast<int64_t>(len) - (q_end - q_start) + (row - q_start);
  int64_t slot = g.max_slot;
  if (valid && pos >= 0) {
    const int64_t blk = pos / s.page_size;
    if (blk < s.max_blocks) {
      const int phys = tbl[static_cast<int64_t>(req) * s.max_blocks + blk];
      if (phys >= 0) slot = min(static_cast<int64_t>(phys) * g.page_stride + pos % s.page_size, g.max_slot);
    }
  }
  *pos_out = pos;
  *slot_out = slot;
}

struct RopePtrs {
  const __nv_bfloat16* qkv;  // [rows, (hq + 2*hkv) * d]
  const float* cos_sin;      // [max_pos, d]: cos | sin
  const int32_t* seq_lens;   // [num_req] tokens incl. new
  const int32_t* q_index;    // [num_req + 1] row prefix sums
  const int32_t* tbl;        // [num_req, max_blocks] page table
  const float* qw;           // [d] (policy != 0)
  const float* kw;           // [d]
  const float* k_scale;      // [1] int8 only
  const float* v_scale;      // [1] int8 only
  __nv_bfloat16* q_out;      // [rows, hq * d]
  void* kcache;              // may alias vcache (NHD_FUSED)
  void* vcache;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(256) rope_store_kernel(const RopePtrs a, const RopeShape s,
                                                          const CacheGeom g, int head_groups) {
  constexpr int kChunks = kMaxElems / VEC;
  const int lanes = s.lanes;
  const int row = blockIdx.x / head_groups;
  const int head = (blockIdx.x - row * head_groups) * s.heads_per_block + threadIdx.x / lanes;
  const int heads = s.hq + 2 * s.hkv;
  if (head >= heads) return;  // a whole group of lanes: no shuffle waits on it
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned gmask = lanes == 32 ? 0xffffffffu
                                     : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const int d = s.d, half = d / 2;

  // this lane's chunks of the head, loaded before anything else
  const __nv_bfloat16* xh = a.qkv + (static_cast<int64_t>(row) * heads + head) * d;
  __align__(16) __nv_bfloat16 r1[kMaxElems], r2[kMaxElems];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (lane + j * lanes) * VEC;
    if (c < half) {
      copy<2 * VEC>(r1 + j * VEC, xh + c);
      copy<2 * VEC>(r2 + j * VEC, xh + half + c);
    }
  }
  const bool is_v = head >= s.hq + s.hkv;
  float inv = 1.f;
  if constexpr (sizeof(T) == 1) inv = __frcp_rn(*(is_v ? a.v_scale : a.k_scale));

  int64_t pos, slot;
  row_slot(row, a.q_index, a.seq_lens, a.tbl, s, g, &pos, &slot);

  if (is_v) {  // a copy (or quantisation) into the cache
    T* dst = static_cast<T*>(a.vcache) + (head - s.hq - s.hkv) * g.head_stride +
             (slot + g.v_slot_off) * g.slot_stride;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = (lane + j * lanes) * VEC;
      if (c < half) {
        put_v<VEC>(dst + c, r1 + j * VEC, inv);
        put_v<VEC>(dst + half + c, r2 + j * VEC, inv);
      }
    }
    return;
  }

  const float* cs = a.cos_sin + (pos < 0 ? 0 : (pos >= s.max_pos ? s.max_pos - 1 : pos)) * d;
  float x1[kMaxElems], x2[kMaxElems];
  __align__(16) float cv[kMaxElems], sv[kMaxElems];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (lane + j * lanes) * VEC;
    if (c < half) {
      copy<4 * VEC>(cv + j * VEC, cs + c);
      copy<4 * VEC>(sv + j * VEC, cs + half + c);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {  // a chunk past the half rotates zeros and is not stored
      const int i = j * VEC + e;
      x1[i] = c < half ? __bfloat162float(r1[i]) : 0.f;
      x2[i] = c < half ? __bfloat162float(r2[i]) : 0.f;
      if (c >= half) cv[i] = sv[i] = 0.f;
    }
  }
  const bool is_q = head < s.hq;
  const float* w = is_q ? a.qw : a.kw;
  if (s.policy == 2) head_rmsnorm<VEC>(x1, x2, lane, lanes, half, w, d, gmask);
#pragma unroll
  for (int i = 0; i < kMaxElems; ++i) {
    const float p = x1[i], q = x2[i];
    x1[i] = __fmul_rn(p, cv[i]) - __fmul_rn(q, sv[i]);
    x2[i] = __fmul_rn(q, cv[i]) + __fmul_rn(p, sv[i]);
  }
  if (s.policy == 1) head_rmsnorm<VEC>(x1, x2, lane, lanes, half, w, d, gmask);

#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = (lane + j * lanes) * VEC;
    if (c >= half) continue;
    if (is_q) {
      __nv_bfloat16* dst = a.q_out + (static_cast<int64_t>(row) * s.hq + head) * d;
      put<VEC>(dst + c, x1 + j * VEC, 1.f);
      put<VEC>(dst + half + c, x2 + j * VEC, 1.f);
    } else {
      T* dst = static_cast<T*>(a.kcache) + (head - s.hq) * g.head_stride + slot * g.slot_stride;
      put<VEC>(dst + c, x1 + j * VEC, inv);
      put<VEC>(dst + half + c, x2 + j * VEC, inv);
    }
  }
}

template <typename T>
int launch(const RopePtrs& a, const RopeShape& s, const CacheGeom& g, void* stream) {
  if (s.rows == 0) return 0;
  const int lanes = s.lanes, vec = s.vec;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool vec_ok = (vec == 1 || vec == 2 || vec == 4 || vec == 8) && (s.d / 2) % vec == 0;
  // every element of a half is some lane's: vec * lanes * chunks >= d / 2
  if (s.d % 2 != 0 || s.d > 2 * 32 * kMaxElems || s.num_req < 1 || g.max_slot < 0 || !lanes_ok ||
      !vec_ok || vec * lanes * (kMaxElems / vec) < s.d / 2 || s.heads_per_block < 1 ||
      s.heads_per_block * lanes > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int heads = s.hq + 2 * s.hkv;
  const int head_groups = (heads + s.heads_per_block - 1) / s.heads_per_block;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(s.rows) * head_groups));
  const int threads = s.heads_per_block * lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8: rope_store_kernel<T, 8><<<grid, threads, 0, st>>>(a, s, g, head_groups); break;
    case 4: rope_store_kernel<T, 4><<<grid, threads, 0, st>>>(a, s, g, head_groups); break;
    case 2: rope_store_kernel<T, 2><<<grid, threads, 0, st>>>(a, s, g, head_groups); break;
    default: rope_store_kernel<T, 1><<<grid, threads, 0, st>>>(a, s, g, head_groups); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 K and V caches, contiguous flat views of num_slots slots in pages of
// page_size: [hkv, num_slots, d] (head_major) or [num_slots, hkv, d].
extern "C" int hpc_rope_store_bf16(const void* qkv, const void* cos_sin, const void* seq_lens,
                                   const void* q_index, const void* block_ids, const void* qw,
                                   const void* kw, void* q_out, void* kcache, void* vcache,
                                   const RopeShape* shape, void* stream) {
  const RopeShape& s = *shape;
  const RopePtrs a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(cos_sin),
                   static_cast<const int32_t*>(seq_lens), static_cast<const int32_t*>(q_index),
                   static_cast<const int32_t*>(block_ids), static_cast<const float*>(qw),
                   static_cast<const float*>(kw), nullptr, nullptr,
                   static_cast<__nv_bfloat16*>(q_out), kcache, vcache};
  const int64_t d = s.d;
  const CacheGeom g{s.page_size, 0, s.num_slots - 1, s.head_major ? s.num_slots * d : d,
                    s.head_major ? d : s.hkv * d};
  return launch<__nv_bfloat16>(a, s, g, stream);
}

// The int8 NHD_FUSED slab [num_pages, 2*page_size, hkv*d]: K of (page p,
// offset o) at slot p*2*page_size + o, V at that slot + page_size; invalid
// rows land on K slot num_pages*2*page_size - 1 - page_size, so their V row
// is the slab's last slot. k_scale and v_scale are [1] float32 device scalars.
extern "C" int hpc_rope_store_int8(const void* qkv, const void* cos_sin, const void* seq_lens,
                                   const void* q_index, const void* block_ids, const void* qw,
                                   const void* kw, const void* k_scale, const void* v_scale,
                                   void* q_out, void* kv_slab, const RopeShape* shape,
                                   void* stream) {
  const RopeShape& s = *shape;
  const RopePtrs a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(cos_sin),
                   static_cast<const int32_t*>(seq_lens), static_cast<const int32_t*>(q_index),
                   static_cast<const int32_t*>(block_ids), static_cast<const float*>(qw),
                   static_cast<const float*>(kw), static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(q_out),
                   kv_slab, kv_slab};
  const int64_t page_stride = 2 * static_cast<int64_t>(s.page_size);
  const CacheGeom g{page_stride, s.page_size, s.num_slots * page_stride - 1 - s.page_size, s.d,
                    static_cast<int64_t>(s.hkv) * s.d};
  return launch<int8_t>(a, s, g, stream);
}
