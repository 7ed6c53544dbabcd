// Varlen causal prefill attention over a paged KV cache of bf16, int8 codes
// or e4m3 (per-tensor scales, or K scales per token and kv head in 1..8
// groups along D), split K and V caches or the NHD_FUSED K|V slab, dense or
// block-sparse. Both products run on the tensor cores (wgmma), with 16-bit
// operands and float32 sums.
//
// Replaces: hpc_ops_tpu/ops/attention/prefill.py:_prefill_kernel (reached
// through _prefill_pallas, dense path with its pertoken_ks option; launcher
// hpc_paged_prefill), hpc_ops_tpu/ops/attention/prefill.py:_prefill_nhd_fused_kernel
// (reached through _prefill_nhd_fused_pallas; launcher
// hpc_paged_prefill_nhd_fused) and
// hpc_ops_tpu/ops/attention/prefill.py:_prefill_sparse_kernel (reached
// through _prefill_sparse_pallas; launcher hpc_paged_prefill_sparse).
//
// Bound on the card: operations. A q tile of Q tokens reads each K/V row of
// its causal prefix once for G * Q query rows, so long prompts do
// O(q_len * kv_len * D) FLOPs against O(kv_len * D) bytes per tile; only the
// tensor cores (989 TFLOP/s in bf16 on an H100, against 67 in float32 on
// the CUDA cores) come near that bound.
//
// Design: one block of two warpgroups (256 threads) per (request, kv head,
// q tile), the tiles with the longest causal prefix launched first. The
// block holds kRows = 128 query rows, 64 a warpgroup: Q = 128 / G tokens
// times the G query heads of the kv head's group (row m is token m / G,
// head m % G), so every K/V row brought into shared memory serves the whole
// GQA group. q is read from, and o written to, the packed [total_q, Hq * D]
// rows directly through cu_seqlens; q is staged once, bf16 exactly as
// given. The block walks KV tiles of kCols = 64 positions up to its causal
// limit through the page table (page ids below 0 read page 0):
//   * copies: every thread issues cp.async of 16 bytes, one page lookup per
//     row for its K and V chunks, two tiles ahead of the one computed; rows
//     at or past the causal end are zero-filled by cp.async itself, never
//     read (a page may hold NaN there). bf16 tiles land in a 4-stage ring
//     in the layout wgmma reads (rows of 128 bytes in the 128-byte swizzle);
//     int8 and e4m3 codes land in a raw ring and are converted, exactly,
//     one tile ahead into a 3-stage ring of 16-bit tiles in that layout
//     (int8 codes and e4m3 values, subnormals included, are exact in bf16
//     and fp16; e4m3 through cvt.rn.f16x2.e4m3x2). One __syncthreads a tile
//     publishes the copies and frees the oldest stage;
//   * S = Q K^T by wgmma m64n64k16, bf16, float32 accumulators, A and B from
//     shared memory. The logit scale sm_scale * kscale * log2(e) is applied
//     to the float32 logits (folded into the exponent), never to 16-bit q.
//     Per-token K scales (ktok, [num_pages, page_size, hkv, kgroups]
//     float32, copied with the tile) multiply each logit column after the
//     product (kgroups = 1); with kgroups > 1 (each scale over D / kgroups
//     columns) each group's columns get a product of their own, with q's
//     fragments in registers, and the float32 partials are scaled and
//     summed: sum_g ks[g] * dot(q[g], k[g]), scaled K never rounded to 16
//     bits (where a group is 8 columns, D 64 with 8 groups, the other
//     group's half of the k-step's q operand is zero);
//   * iteration j issues S of tile j and O += P V of tile j - 1 together,
//     then the softmax of tile j runs while P V does (the intra-warpgroup
//     overlap of FlashAttention-3). P V is wgmma with P from registers (the
//     accumulator layout of the first product is the register-A layout of
//     the second) and V MN-major through the transpose bit, m64n128k16 at D
//     128. bf16 caches take bf16 P and V; int8 and e4m3 caches fp16 P and V
//     (four times finer steps for P; their V converts exactly);
//   * the causal mask kpos <= (kv_len - q_len) + qpos is applied only on
//     tiles that cross some row's limit (or the end of the cache); the
//     online softmax in the exp2 domain keeps each row's max in raw logits,
//     reduced across the 4 threads that hold the row with shuffles, and
//     moves the exponents' reference only when the max passes it by more
//     than 2^8 in the exponential (P stays below 256: exact in the float32
//     sums, no coarser in 16 bits), so most tiles skip the rescale of O;
//   * a warpgroup whose rows all end before a tile still issues its
//     products with P = 0: no wgmma sits on a divergent path (ptxas
//     serialises every wgmma of a kernel that has one, advisory C7520), and
//     values that steer the walk are broadcast from lane 0 so the compiler
//     sees them warp-uniform;
//   * epilogue: o / l * vscale (one scale, or one per kv head:
//     vscale_per_head), rounded to bf16; a row with l = 0 writes 0.
// Page, slot and head strides are arguments, so HND, NHD and the NHD_FUSED
// slab ([nb, 2*bs, Hkv*D], V rows bs slots after the page's K rows) are read
// in place. Rows of the output past cu_seqlens[B] belong to no request; a
// last column of blocks zero-fills them (the wrapper leaves out
// uninitialised).
//
// Block-sparse form (launcher hpc_paged_prefill_sparse): the same kernel
// with a uint8 mask [B, hq, n_tm, n_tkv]. Row i of a request lies in mask
// row i / mask_tile_q, key position p in mask column p / mask_tile_kv; a
// mask entry past the mask's edge reads as 0. First the block's threads,
// one KV tile of 64 columns each, OR the entries that cover the block's rows
// (every head of the GQA group) and the tile's columns into one flag a tile
// and write the kept tiles in order into a list in shared memory (the TPU
// kernel's active-chunk list; a ballot places each tile among its warp's,
// the warps' counts place the warps); the ring then walks that list, so a tile
// whose flag is 0 costs no copy, no scale read, no math and no stage of the
// ring. In a kept tile each (row, column) logit is masked by its own head's
// entry beside the causal mask, so any mask tile size gives the same
// function; when every entry over the tile is set (the usual case for masks
// of 64 columns or more shared by a GQA group) that lookup is skipped: done
// in every kept tile, the lookup (a division and a byte load a logit) made
// the sparse call 1.6x as long on an H100 (chip_smoke.py prefill_sparse). A
// row with no kept key comes back 0, as the TPU kernel writes it.
//
// Known limits: no warp specialisation (every thread copies and computes,
// a __syncthreads a tile keeps the two warpgroups in step, so their
// softmaxes coincide instead of alternating with the other's products; a
// producer warpgroup with mbarriers and setmaxnreg, tried, was no faster
// without that alternation), no TMA tensor maps (every thread spends
// instructions on addresses and copies), S at N = 64 (the KV tile, kept at
// 64 columns for the sparse form's skip), and no fp8 products (e4m3 caches
// are multiplied in 16 bits, since q is bf16).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

struct e4m3_t {
  uint8_t bits;
};

constexpr int kRows = 128;     // query rows a block, 64 a warpgroup
constexpr int kCols = 64;      // KV positions a tile
constexpr int kThreads = 256;  // two warpgroups
constexpr int kMaxGroups = 8;  // K scales per (token, kv head)
constexpr int kKsStages = 4;   // ring of per-token K scales, by tile ordinal

// Shared memory of one block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 1024 bytes): q's 128 rows; a ring of
// 16-bit (K, V) tile pairs (bf16 caches: 4 stages filled by cp.async; int8
// and e4m3: 3 stages filled by conversion from a 3-stage ring of raw code
// tiles); the ring of per-token K scales; for the sparse form the list of
// kept tiles.
template <int D, typename T>
struct Smem {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kTile16 = kCols * D * 2;  // one 16-bit K or V tile
  static constexpr int kRawTile = kCols * D;     // one tile of 8-bit codes
  static constexpr int kStages16 = kQuant ? 3 : 4;
  static constexpr int kRawStages = kQuant ? 3 : 0;
  static constexpr int kAhead = kQuant ? 3 : 2;  // tiles copied ahead of the one computed
  static constexpr int kQ = 0;
  static constexpr int kRing16 = kQ + kRows * D * 2;
  static constexpr int kRaw = kRing16 + kStages16 * 2 * kTile16;
  static constexpr int kKs = kRaw + kRawStages * 2 * kRawTile;
  static constexpr int kKsStage = kCols * kMaxGroups * 4;
  static constexpr int kList = kKs + kKsStages * kKsStage;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory (cp.async, st)
// before the async-proxy reads of later wgmmas.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving uses of registers that an in-flight wgmma
// writes or reads across the wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// Descriptor of a 16-bit operand tile in shared memory: rows of 128 bytes in
// the 128-byte swizzle, 8-row groups 1024 bytes apart (the stride byte
// offset). Serves K-major q and K (a k-step is 32 bytes into the row) and
// MN-major V (a k-step is 16 rows further; an N of 128 spans two 64-column
// blocks, whose distance goes into the leading byte offset, bits 16-29). A
// tile's descriptor is built once; the k-steps add their byte offset / 16
// to its low word (the start address field cannot carry: shared addresses
// stay below 256 KB).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t byte_off) {
  return desc + (byte_off >> 4);
}

// Byte offset of the 16-byte chunk c (along D) of row n in an [R][D] 16-bit
// tile: column blocks of 64 elements, each R rows of 128 bytes, chunks
// XOR-swizzled by the row within its 8-row group.
template <int R>
__device__ __forceinline__ uint32_t swz(int n, int c) {
  return static_cast<uint32_t>((c >> 3) * (R * 128) + n * 128 + (((c & 7) ^ (n & 7)) << 4));
}

#define HPC_ACC32(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HPC_D32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HPC_D64                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// The products, float32 accumulators d (64 rows a warpgroup) over a k-step
// of 16: A from registers (RS, bf16 or fp16) or from a K-major descriptor
// (SS, bf16); B from a descriptor (kTransB 0: K-major, 1: MN-major);
// accumulate 0 overwrites d. Each predicate scale-d comes from a register.
template <bool kHalf, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (kHalf) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HPC_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HPC_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HPC_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HPC_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
  }
}
// N = 128: d0 and d1 are the two 64-column halves; b MN-major, its two
// 64-column blocks a leading byte offset apart; always accumulates.
template <bool kHalf>
__device__ __forceinline__ void wgmma_rs_n128(float (&d0)[32], float (&d1)[32],
                                              const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kHalf) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " HPC_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HPC_ACC32(d0), HPC_ACC32(d1)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HPC_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HPC_ACC32(d0), HPC_ACC32(d1)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HPC_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HPC_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to a 16-bit pair (low half first).
template <bool kHalf>
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  if constexpr (kHalf) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Two 8-bit codes (the low byte first) -> a 16-bit pair, exactly.
template <bool kHalf>
__device__ __forceinline__ uint32_t widen2(const int8_t*, uint32_t two) {
  const float a = static_cast<float>(static_cast<int8_t>(two & 0xff));
  const float b = static_cast<float>(static_cast<int8_t>((two >> 8) & 0xff));
  return pack2<kHalf>(a, b);
}
template <bool kHalf>
__device__ __forceinline__ uint32_t widen2(const e4m3_t*, uint32_t two) {
  uint32_t h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(static_cast<uint16_t>(two)));
  if constexpr (kHalf) return h;
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  const __nv_bfloat162 v = __float22bfloat162_rn(f);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The block mask of the sparse form (bits null: the dense form).
struct BlockMask {
  const uint8_t* bits;  // [batch, hq, n_tm, n_tkv]
  int n_tm, n_tkv, tile_q, tile_kv;
};

template <int D, typename T, bool kGrouped>
__global__ void __launch_bounds__(kThreads, 1) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [rows, hq * D]
    const T* __restrict__ kc, const T* __restrict__ vc,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const int32_t* __restrict__ cu, const int32_t* __restrict__ kv_lens,
    const int32_t* __restrict__ block_ids, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const float* __restrict__ ktok,
    __nv_bfloat16* __restrict__ out, int total_q, int max_blocks, int page_size, int hq, int hkv,
    int q_tile, int vscale_per_head, int kgroups, float scale, BlockMask bm) {
  using L = Smem<D, T>;
  constexpr bool kQuant = L::kQuant;
  constexpr bool kHalfPV = kQuant;  // P and V in fp16 for int8 and e4m3 caches
  constexpr int kSteps = D / 16;    // k-steps of Q K^T
  constexpr int kDBlocks = D / 64;  // 64-column blocks of the output
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);

  // values that steer the walk are broadcast from lane 0, so the compiler
  // sees them warp-uniform and keeps the wgmmas unserialized
  const int b = blockIdx.x, h = blockIdx.y;
  const int g_per = hq / hkv;
  const int64_t row_stride = static_cast<int64_t>(hq) * D;
  const int tid = threadIdx.x, lane = tid & 31;
  if (b == gridDim.x - 1) {
    // the last column of blocks: out's rows past cu[batch] (no request's)
    // are zeros, split over the column's blocks
    const int pad0 = cu[b];
    const int parts = gridDim.y * gridDim.z, part = blockIdx.z * gridDim.y + blockIdx.y;
    const int per = (max(total_q - pad0, 0) + parts - 1) / parts;
    const int r0 = pad0 + part * per, r1 = min(r0 + per, total_q);
    uint4* dst = reinterpret_cast<uint4*>(out + r0 * row_stride);
    for (int64_t i = tid; i < max(r1 - r0, 0) * row_stride / 8; i += kThreads)
      dst[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int q_start = __shfl_sync(0xffffffffu, cu[b], 0);
  const int q_len = __shfl_sync(0xffffffffu, cu[b + 1], 0) - q_start;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * q_tile;  // the longest causal prefixes first
  if (i0 >= q_len) return;
  const int n_tok = min(q_tile, q_len - i0);
  const int rows_used = n_tok * g_per;
  const int kv_len = __shfl_sync(0xffffffffu, kv_lens[b], 0);
  const int kv_off = kv_len - q_len;
  const int kv_end = min(min(kv_len, kv_off + i0 + n_tok), max_blocks * page_size);
  const int n_tiles = kv_end > 0 ? (kv_end + kCols - 1) / kCols : 0;
  const int32_t* tbl = block_ids + static_cast<int64_t>(b) * max_blocks;
  const bool sparse = bm.bits != nullptr;
  // page of a position: a shift where page_size is a power of two
  const int page_shift = (page_size & (page_size - 1)) == 0 ? __ffs(page_size) - 1 : -1;

  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), gid = lane >> 2, tq = lane & 3;
  // row m of the block is token m / G, head m % G: shifts where G is a power
  // of two (the per-row divisions otherwise cost the short blocks of the
  // sparse form much of their time)
  const int g_shift = (g_per & (g_per - 1)) == 0 ? __ffs(g_per) - 1 : -1;
  auto tok_of = [&](int m) { return g_shift >= 0 ? m >> g_shift : m / g_per; };
  auto head_of = [&](int m) { return g_shift >= 0 ? m & (g_per - 1) : m % g_per; };
  // this thread's two rows of its warpgroup's 64 (accumulator layout)
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + gid;
  const int wg_last = min(wg * 64 + 63, rows_used - 1);
  const bool wg_live = wg * 64 < rows_used;
  const int wg_lo = kv_off + i0 + tok_of(wg * 64);  // the warpgroup's smallest causal limit
  const int wg_hi = kv_off + i0 + tok_of(wg_last);  // and its largest

  int lim[2];
  const uint8_t* mrow[2];  // sparse: each row's mask row (null: no entry, all masked)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + 8 * hf;
    const bool ok = r < rows_used;
    lim[hf] = ok ? kv_off + i0 + tok_of(r) : -1;
    mrow[hf] = nullptr;
    if (sparse) {
      const int tq_row = (i0 + tok_of(r)) / bm.tile_q;
      if (ok && tq_row < bm.n_tm)
        mrow[hf] = bm.bits +
                   ((static_cast<int64_t>(b) * hq + h * g_per + head_of(r)) * bm.n_tm + tq_row) *
                       bm.n_tkv;
    }
  }

  // q's rows -> shared memory, swizzled like K (kRows rows a column block);
  // issued first, in flight while the sparse form reads its mask (the
  // copies join the first tile's group)
  {
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int m = idx / kChunks, c = idx % kChunks;
      const bool ok = m < rows_used;
      const int64_t at = (q_start + i0 + tok_of(m)) * row_stride + (h * g_per + head_of(m)) * D;
      const __nv_bfloat16* src = q + (ok ? at + c * 8 : 0);
      cp_async16(s_base + L::kQ + swz<kRows>(m, c), src, ok);
    }
  }

  // sparse: the kept KV tiles in order, 2 * tile + (flag == 2), and their
  // count. A tile's flag comes from the mask rows the block's rows span and
  // the mask columns the tile spans, over every head of the GQA group
  // (entries past the mask's edge are 0): 0 skip, 1 kept, 2 kept with every
  // entry set (no per-logit lookup). Thread t of a round flags tile
  // round + t; a ballot gives its place among its warp's kept tiles, the
  // warps' counts its warp's place in the round.
  int32_t* list_s = reinterpret_cast<int32_t*>(smem + L::kList);
  __shared__ int warp_kept_s[kThreads / 32];
  int n_iter = n_tiles;
  if (sparse) {
    const int tm_lo = i0 / bm.tile_q, tm_last = (i0 + n_tok - 1) / bm.tile_q;
    const int tm_hi = min(tm_last, bm.n_tm - 1);
    const int64_t head_stride = static_cast<int64_t>(bm.n_tm) * bm.n_tkv;
    const uint8_t* mask_b = bm.bits + (static_cast<int64_t>(b) * hq + h * g_per) * head_stride;
    const int warp = tid >> 5;
    int kept_before = 0;
    for (int round = 0; round < n_tiles; round += kThreads) {
      const int t = round + tid;
      int flag = 0;
      if (t < n_tiles) {
        const int tk_lo = t * kCols / bm.tile_kv;
        const int tk_last = (min(t * kCols + kCols, kv_end) - 1) / bm.tile_kv;
        const int tk_hi = min(tk_last, bm.n_tkv - 1);
        int kept = 0, all = tm_last < bm.n_tm && tk_last < bm.n_tkv;
        for (int tqm = tm_lo; tqm <= tm_hi; ++tqm)
          for (int tk = tk_lo; tk <= tk_hi; ++tk) {
            const uint8_t* e = mask_b + static_cast<int64_t>(tqm) * bm.n_tkv + tk;
#pragma unroll 4
            for (int g = 0; g < g_per; ++g) {  // the heads' loads in flight together
              const int bit = e[g * head_stride];
              kept |= bit;
              all &= bit != 0;
            }
          }
        flag = kept ? (all ? 2 : 1) : 0;
      }
      const unsigned kept_w = __ballot_sync(0xffffffffu, flag != 0);
      if (lane == 0) warp_kept_s[warp] = __popc(kept_w);
      __syncthreads();
      int at = kept_before, round_kept = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        at += w < warp ? warp_kept_s[w] : 0;
        round_kept += warp_kept_s[w];
      }
      if (flag) list_s[at + __popc(kept_w & ((1u << lane) - 1))] = 2 * t + (flag == 2);
      kept_before += round_kept;
      __syncthreads();  // the list written; warp_kept_s free for the next round
    }
    n_iter = __shfl_sync(0xffffffffu, kept_before, 0);
  }
  auto entry_of = [&](int j) { return sparse ? list_s[j] : 2 * j + 1; };

  // Issues the copies of KV tile t, the j-th of the walk: kChunks threads a
  // row, one page lookup for the row's K and V chunks.
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  constexpr int kRowsPass = kThreads / kChunks;
  const int chunk = tid % kChunks;
  const T* k_base = kc + h * k_head_stride + chunk * (16 / static_cast<int>(sizeof(T)));
  const T* v_base = vc + h * v_head_stride + chunk * (16 / static_cast<int>(sizeof(T)));
  auto load_tile = [&](int t, int j) {
    const int t0 = t * kCols;
#pragma unroll
    for (int p = 0; p < kCols / kRowsPass; ++p) {
      const int n = tid / kChunks + p * kRowsPass;
      const int kpos = t0 + n;
      const bool ok = kpos < kv_end;
      const T* ksrc = kc;
      const T* vsrc = vc;
      if (ok) {
        const int pidx = page_shift >= 0 ? kpos >> page_shift : kpos / page_size;
        const int64_t page = max(tbl[pidx], 0);
        const int64_t in_page = kpos - pidx * page_size;
        ksrc = k_base + page * k_page_stride + in_page * k_slot_stride;
        vsrc = v_base + page * v_page_stride + in_page * v_slot_stride;
      }
      uint32_t kdst, vdst;
      if constexpr (kQuant) {
        kdst = s_base + L::kRaw + (j % L::kRawStages) * 2 * L::kRawTile + n * D + chunk * 16;
        vdst = kdst + L::kRawTile;
      } else {
        kdst = s_base + L::kRing16 + (j % L::kStages16) * 2 * L::kTile16 + swz<kCols>(n, chunk);
        vdst = kdst + L::kTile16;
      }
      cp_async16(kdst, ksrc, ok);
      cp_async16(vdst, vsrc, ok);
    }
    if (ktok != nullptr) {
      for (int e = tid; e < kCols * kgroups; e += kThreads) {
        const int kpos = t0 + e / kgroups;
        const bool ok = kpos < kv_end;
        const float* src = ktok;
        if (ok) {
          const int pidx = page_shift >= 0 ? kpos >> page_shift : kpos / page_size;
          const int64_t page = max(tbl[pidx], 0);
          src += ((page * page_size + kpos - pidx * page_size) * hkv + h) * kgroups + e % kgroups;
        }
        cp_async4(s_base + L::kKs + (j % kKsStages) * L::kKsStage + e * 4, src, ok);
      }
    }
  };

  // int8 / e4m3: the raw codes of the j-th tile -> its 16-bit K (bf16) and
  // V (fp16) tiles, in the swizzled layout.
  auto convert_tile = [&](int j) {
    if constexpr (kQuant) {
      constexpr int kRawChunks = D / 16;  // 16 codes a chunk
      const uint8_t* raw_kv = smem + L::kRaw + (j % L::kRawStages) * 2 * L::kRawTile;
      uint8_t* tile = smem + L::kRing16 + (j % L::kStages16) * 2 * L::kTile16;
#pragma unroll
      for (int i = 0; i < 2 * kCols * kRawChunks / kThreads; ++i) {
        const int idx = tid + i * kThreads;
        const bool is_v = idx >= kCols * kRawChunks;
        const int rem = is_v ? idx - kCols * kRawChunks : idx;
        const int n = rem / kRawChunks, c = rem % kRawChunks;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(raw_kv + (is_v ? L::kRawTile : 0) + n * D + c * 16);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t o16[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t two = w[k / 2] >> (16 * (k % 2));
          o16[k] = is_v ? widen2<true>(static_cast<const T*>(nullptr), two)
                        : widen2<false>(static_cast<const T*>(nullptr), two);
        }
        uint8_t* dst = tile + (is_v ? L::kTile16 : 0);
        *reinterpret_cast<uint4*>(dst + swz<kCols>(n, 2 * c)) =
            make_uint4(o16[0], o16[1], o16[2], o16[3]);
        *reinterpret_cast<uint4*>(dst + swz<kCols>(n, 2 * c + 1)) =
            make_uint4(o16[4], o16[5], o16[6], o16[7]);
      }
    }
  };

  const float sl2 = scale * (kscale ? *kscale : 1.f) * 1.4426950408889634f;  // log2(e)
  float o[kDBlocks][32];
  float s[32], m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  uint32_t pf[4][4];  // P of the previous tile: the A operand of its 4 k-steps over 64 positions
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
    pf[i / 8][(i / 2) % 4] = 0u;
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) o[db][i] = 0.f;
  }
  const uint64_t q_desc = desc_sw128(s_base + L::kQ + wg * 64 * 128);  // this warpgroup's 64 rows
  auto pv = [&](int j) {  // O += P V of the j-th tile (after a wgmma fence)
    const uint64_t vd =
        desc_sw128(s_base + L::kRing16 + (j % L::kStages16) * 2 * L::kTile16 + L::kTile16);
    if constexpr (kDBlocks == 2) {
      // D 128: one m64n128k16 a k-step, V's two 64-column blocks a leading
      // byte offset apart
      const uint64_t vd2 = vd + (static_cast<uint64_t>((kCols * 128) >> 4) << 16) - (1u << 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n128<kHalfPV>(o[0], o[kDBlocks - 1], pf[kk], desc_at(vd2, kk * 16 * 128));
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<kHalfPV, 1>(o[0], pf[kk], desc_at(vd, kk * 16 * 128), 1);
    }
  };

  // The walk: iteration j issues S = Q K^T of tile j and O += P V of tile
  // j - 1 together, then the next copies (and for int8 / e4m3 the next
  // tile's conversion), then the softmax of tile j while P V runs.
  for (int j = 0; j < L::kAhead; ++j) {
    if (j < n_iter) load_tile(entry_of(j) >> 1, j);
    cp_async_commit();
  }
  if constexpr (kQuant) {
    cp_async_wait<L::kAhead - 1>();  // q and the first tile's codes
    __syncthreads();
    if (n_iter > 0) convert_tile(0);
    fence_proxy_async();
  }
#pragma unroll 1
  for (int j = 0; j < n_iter; ++j) {
    cp_async_wait<1>();  // bf16: tile j's copies; int8 / e4m3: tile j + 1's codes (this thread's)
    fence_proxy_async();
    __syncthreads();  // everyone's; every warpgroup is done with tile j - 1's S and j - 2's P V
    const int entry = __shfl_sync(0xffffffffu, entry_of(j), 0);
    const int t0 = (entry >> 1) * kCols;
    const bool full = entry & 1;
    // some row of the warpgroup reaches the tile (else its P is 0: the
    // products run all the same, so no wgmma sits on a divergent path)
    const bool live = wg_live && t0 <= wg_hi;
    const uint64_t k_desc = desc_sw128(s_base + L::kRing16 + (j % L::kStages16) * 2 * L::kTile16);
    wgmma_fence();
    if constexpr (!kGrouped) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        wgmma_ss(s, desc_at(q_desc, (kk / 4) * (kRows * 128) + (kk % 4) * 32),
                 desc_at(k_desc, (kk / 4) * (kCols * 128) + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    if (j > 0) pv(j - 1);
    wgmma_commit();
    if (j + L::kAhead < n_iter) load_tile(entry_of(j + L::kAhead) >> 1, j + L::kAhead);
    cp_async_commit();
    if constexpr (kQuant) {
      if (j + 1 < n_iter) convert_tile(j + 1);
      fence_proxy_async();
    }
    uint32_t pn[4][4];  // P of tile j
    float alpha[2] = {1.f, 1.f};
    const float* ks = reinterpret_cast<const float*>(smem + L::kKs + (j % kKsStages) * L::kKsStage);
    if constexpr (!kGrouped) {
      wgmma_wait<1>();
      fence_acc(s);
      if (ktok != nullptr) {  // one K scale per token: a column scale, exact
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kscol = ks[8 * jn + 2 * tq + e];
            s[4 * jn + e] *= kscol;
            s[4 * jn + 2 + e] *= kscol;
          }
      }
    } else {
      // one product per group of D / kgroups columns, q from shared memory
        // into registers, scaled and summed in float32; spg k-steps a group,
        // 0: a k-step spans two groups of 8 columns
        float sg[32];
        const int spg = kSteps / kgroups;
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t qa[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            qa[r] = *reinterpret_cast<const uint32_t*>(
                smem + L::kQ + swz<kRows>(row0 + 8 * (r & 1), 2 * kk + (r >> 1)) + 4 * tq);
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            if (part == 1 && spg != 0) continue;
            const bool first = spg == 0 || kk % spg == 0;
            const bool last = spg == 0 || kk % spg == spg - 1;
            uint32_t a[4] = {qa[0], qa[1], qa[2], qa[3]};
            if (spg == 0) {  // keep only this part's 8 columns of the k-step
              a[2 - 2 * part] = 0u;
              a[3 - 2 * part] = 0u;
            }
            wgmma_fence();  // a was just written
            wgmma_rs<false, 0>(sg, a, desc_at(k_desc, (kk / 4) * (kCols * 128) + (kk % 4) * 32),
                               first ? 0 : 1);
            if (last) {
              wgmma_commit();
              wgmma_wait<0>();
              fence_acc(sg);
              const int g = spg == 0 ? 2 * kk + part : kk / spg;
#pragma unroll
              for (int jn = 0; jn < 8; ++jn)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float kscol = ks[(8 * jn + 2 * tq + e) * kgroups + g];
                  s[4 * jn + e] += kscol * sg[4 * jn + e];
                  s[4 * jn + 2 + e] += kscol * sg[4 * jn + 2 + e];
                }
            }
          }
        }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) pn[i / 4][i % 4] = 0u;
    if (live) {
      if (t0 + kCols - 1 > wg_lo || t0 + kCols > kv_end || !full) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = t0 + 8 * jn + 2 * tq + e;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              bool keep = kpos <= lim[hf] && kpos < kv_end;
              if (keep && !full) {
                const int tk = kpos / bm.tile_kv;
                keep = mrow[hf] != nullptr && tk < bm.n_tkv && mrow[hf][tk];
              }
              if (!keep) s[4 * jn + 2 * hf + e] = -INFINITY;
            }
          }
      }

      // online softmax: the running max in raw logits, the scale folded
      // into the exponent (exp2 domain)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          mx = fmaxf(mx, fmaxf(s[4 * jn + 2 * hf], s[4 * jn + 2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // the exponents' reference moves only when the row max passes it
        // by more than 2^8 in the exponential: P stays below 256 (exact in
        // the float32 sums, no coarser in bf16 or fp16), and most tiles
        // keep alpha = 1 and skip the rescale of O
        const bool move = (mx - m_r[hf]) * sl2 > 8.f || m_r[hf] == -INFINITY;
        const float m_new = move ? mx : m_r[hf];
        const float neg = m_new == -INFINITY ? 0.f : -m_new * sl2;
        alpha[hf] = move ? ex2(fmaf(m_r[hf], sl2, neg)) : 1.f;
        m_r[hf] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float p0 = ex2(fmaf(s[4 * jn + 2 * hf], sl2, neg));
          const float p1 = ex2(fmaf(s[4 * jn + 2 * hf + 1], sl2, neg));
          sum += p0 + p1;
          pn[jn / 2][hf + 2 * (jn % 2)] = pack2<kHalfPV>(p0, p1);
        }
        l_r[hf] = l_r[hf] * alpha[hf] + sum;
      }
    }
    wgmma_wait<0>();  // P V of tile j - 1
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) fence_acc(o[db]);
    fence_frag(pf);
    // a warp whose rows kept their max skips the rescale
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
          for (int jn = 0; jn < 8; ++jn)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              o[db][4 * jn + 2 * hf] *= alpha[hf];
              o[db][4 * jn + 2 * hf + 1] *= alpha[hf];
            }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) pf[i / 4][i % 4] = pn[i / 4][i % 4];
  }
  if (n_iter > 0) {
    wgmma_fence();
    pv(n_iter - 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) fence_acc(o[db]);
  }
  // every copy landed before the epilogue reuses q's rows: with an empty
  // walk (a sparse block that keeps no tile) no wait above covered q's
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: o / l * vscale in bf16, a row with l = 0 written 0. Each
  // warpgroup stages its 64 rows in its own rows of q's shared memory (no
  // product reads them now), then stores them in 16-byte chunks, the chunks
  // of a row by consecutive threads (a token's G rows are contiguous in out)
  const float oscale = vscale ? vscale[vscale_per_head ? h : 0] : 1.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_r[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.f ? 0.f : oscale / l;
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(smem + L::kQ + swz<kRows>(row0 + 8 * hf, db * 8 + jn) +
                                           4 * tq) =
            __floats2bfloat162_rn(o[db][4 * jn + 2 * hf] * inv, o[db][4 * jn + 2 * hf + 1] * inv);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // the warpgroup's rows staged
  constexpr int kOutChunks = D / 8;
  const int wtid = tid & 127;
#pragma unroll
  for (int i = 0; i < 64 * kOutChunks / 128; ++i) {
    const int idx = wtid + i * 128;
    const int r = wg * 64 + idx / kOutChunks, c = idx % kOutChunks;
    if (r < rows_used)
      *reinterpret_cast<uint4*>(out + (q_start + i0 + tok_of(r)) * row_stride +
                                (h * g_per + head_of(r)) * D + c * 8) =
          *reinterpret_cast<const uint4*>(smem + L::kQ + swz<kRows>(r, c));
  }
}

#undef HPC_ACC32
#undef HPC_D32
#undef HPC_D64

template <int D, typename T, bool kGrouped>
int launch_form(const void* q, const void* kc, const void* vc, const int64_t* st,
                const void* cu, const void* kv_lens, const void* block_ids, const void* kscale,
                const void* vscale, const void* ktok, void* out, int total_q, int batch,
                int max_blocks, int page_size, int hq, int hkv, int n_q_tiles, int q_tile,
                int vscale_per_head, int kgroups, float scale, BlockMask bm, cudaStream_t stream) {
  const size_t cap = (static_cast<size_t>(max_blocks) * page_size + kCols - 1) / kCols;
  const int smem = static_cast<int>(1024 + Smem<D, T>::kList + (bm.bits ? 4 * cap : 0));
  // the largest dynamic shared memory granted so far: cudaFuncSetAttribute
  // only when a launch needs more (and not inside a CUDA graph's capture
  // after the first launch); ranks of a tensor-parallel mesh launch from
  // threads
  static std::atomic<int> granted{0};
  if (smem > granted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(paged_prefill_kernel<D, T, kGrouped>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int seen = granted.load();
    while (smem > seen && !granted.compare_exchange_weak(seen, smem)) {
    }
  }
  dim3 grid(batch + 1, hkv, n_q_tiles);  // the last column zero-fills the rows past cu[batch]
  paged_prefill_kernel<D, T, kGrouped><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), st[0], st[1], st[2], st[3], st[4], st[5],
      static_cast<const int32_t*>(cu), static_cast<const int32_t*>(kv_lens),
      static_cast<const int32_t*>(block_ids), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const float*>(ktok),
      static_cast<__nv_bfloat16*>(out), total_q, max_blocks, page_size, hq, hkv, q_tile,
      vscale_per_head, kgroups, scale, bm);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch(const void* q, const void* kc, const void* vc, const int64_t* st,
           const void* cu, const void* kv_lens, const void* block_ids, const void* kscale,
           const void* vscale, const void* ktok, void* out, int total_q, int batch, int max_blocks,
           int page_size, int hq, int hkv, int n_q_tiles, int q_tile, int vscale_per_head,
           int kgroups, float scale, BlockMask bm, cudaStream_t stream) {
  if (ktok != nullptr && kgroups > 1)
    return launch_form<D, T, true>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok,
                                   out, total_q, batch, max_blocks, page_size, hq, hkv, n_q_tiles,
                                   q_tile, vscale_per_head, kgroups, scale, bm, stream);
  return launch_form<D, T, false>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok,
                                  out, total_q, batch, max_blocks, page_size, hq, hkv, n_q_tiles,
                                  q_tile, vscale_per_head, kgroups, scale, bm, stream);
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc, const int64_t* st,
             const void* cu, const void* kv_lens, const void* block_ids, const void* kscale,
             const void* vscale, const void* ktok, void* out, int total_q, int batch,
             int max_blocks, int page_size, int hq, int hkv, int d, int max_seqlens_q,
             int vscale_per_head, int kgroups, float scale, BlockMask bm, cudaStream_t stream) {
  if (hq % hkv != 0 || hq / hkv > kRows || kgroups < 1 || kgroups > kMaxGroups || d % kgroups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_tile = kRows / (hq / hkv);
  const int n_q_tiles = max((max_seqlens_q + q_tile - 1) / q_tile, 1);
  switch (d) {
    case 64:
      return launch<64, T>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok, out,
                           total_q, batch, max_blocks, page_size, hq, hkv, n_q_tiles, q_tile,
                           vscale_per_head, kgroups, scale, bm, stream);
    case 128:
      return launch<128, T>(q, kc, vc, st, cu, kv_lens, block_ids, kscale, vscale, ktok, out,
                            total_q, batch, max_blocks, page_size, hq, hkv, n_q_tiles, q_tile,
                            vscale_per_head, kgroups, scale, bm, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Cache element types of the launchers' kv_type argument.
enum KvType { kBf16 = 0, kInt8 = 1, kE4m3 = 2 };

int launch_typed(int kv_type, const void* q, const void* kc, const void* vc, int64_t v_off,
                 const int64_t* st, const void* cu, const void* kv_lens, const void* block_ids,
                 const void* kscale, const void* vscale, const void* ktok, void* out, int total_q,
                 int batch, int max_blocks, int page_size, int hq, int hkv, int d,
                 int max_seqlens_q, int vscale_per_head, int kgroups, float scale, BlockMask bm,
                 cudaStream_t stream) {
  // v_off: elements from vc to the first V row (the slab's K|V offset)
  switch (kv_type) {
    case kBf16:
      return launch_d<__nv_bfloat16>(
          q, kc, static_cast<const __nv_bfloat16*>(vc) + v_off, st, cu, kv_lens, block_ids, kscale,
          vscale, ktok, out, total_q, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
          vscale_per_head, kgroups, scale, bm, stream);
    case kInt8:
      return launch_d<int8_t>(
          q, kc, static_cast<const int8_t*>(vc) + v_off, st, cu, kv_lens, block_ids, kscale,
          vscale, ktok, out, total_q, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
          vscale_per_head, kgroups, scale, bm, stream);
    case kE4m3:
      return launch_d<e4m3_t>(
          q, kc, static_cast<const e4m3_t*>(vc) + v_off, st, cu, kv_lens, block_ids, kscale,
          vscale, ktok, out, total_q, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
          vscale_per_head, kgroups, scale, bm, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr BlockMask kDense = {nullptr, 0, 0, 1, 1};

}  // namespace

// Split K and V caches of kv_type (0 bf16, 1 int8, 2 e4m3); (head, page,
// slot) strides in elements. Launches one block per (request, kv head, q
// tile of 128 / G tokens), and a column of blocks that zero-fills out's rows
// from cu[batch] to total_q (out may come uninitialised), and returns a
// cudaError_t code. d (the head dim of
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
    const void* cu, const void* kv_lens, const void* block_ids, void* out, int total_q,
    int batch, int max_blocks, int page_size, int hq, int hkv, int d,
    int max_seqlens_q, int vscale_per_head, int kgroups, float scale, void* stream) {
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  return launch_typed(kv_type, q, kcache, vcache, 0, st, cu, kv_lens, block_ids, kscale, vscale,
                      ktok, out, total_q, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
                      vscale_per_head, kgroups, scale, kDense, static_cast<cudaStream_t>(stream));
}

// The NHD_FUSED slab [num_pages, 2*page_size, hkv*d] of kv_type. kscale and
// vscale are [1] float32 device scalars or null (a scale of 1).
extern "C" int hpc_paged_prefill_nhd_fused(
    const void* q, const void* kv_slab, int kv_type, const void* kscale, const void* vscale,
    const void* cu, const void* kv_lens, const void* block_ids, void* out, int total_q,
    int batch, int max_blocks, int page_size, int hq, int hkv, int d, int max_seqlens_q,
    float scale, void* stream) {
  const int64_t slot = static_cast<int64_t>(hkv) * d;
  const int64_t page = 2 * page_size * slot;
  const int64_t st[6] = {d, page, slot, d, page, slot};
  // a page's V rows follow its page_size K rows
  return launch_typed(kv_type, q, kv_slab, kv_slab, page_size * slot, st, cu, kv_lens, block_ids,
                      kscale, vscale, nullptr, out, total_q, batch, max_blocks, page_size, hq, hkv,
                      d, max_seqlens_q, 0, 1, scale, kDense, static_cast<cudaStream_t>(stream));
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
    int total_q, int batch, int max_blocks, int page_size, int hq, int hkv, int d,
    int max_seqlens_q, int vscale_per_head, int kgroups, int n_tm, int n_tkv, int mask_tile_q,
    int mask_tile_kv, float scale, void* stream) {
  if (mask == nullptr || n_tm < 1 || n_tkv < 1 || mask_tile_q < 1 || mask_tile_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  const BlockMask bm = {static_cast<const uint8_t*>(mask), n_tm, n_tkv, mask_tile_q, mask_tile_kv};
  return launch_typed(kv_type, q, kcache, vcache, 0, st, cu, kv_lens, block_ids, kscale, vscale,
                      ktok, out, total_q, batch, max_blocks, page_size, hq, hkv, d, max_seqlens_q,
                      vscale_per_head, kgroups, scale, bm, static_cast<cudaStream_t>(stream));
}
