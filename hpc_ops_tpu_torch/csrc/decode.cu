// Paged GQA decode attention with MTP draft rows, over a KV cache of bf16,
// int8 codes or e4m3 (per-tensor scales, or K scales per token and kv head
// in 1..8 groups along D), split K and V caches, the head-major FUSED K|V
// slab or the NHD_FUSED K|V slab; and its task-map form with the combine.
// Both products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// float32 sums).
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
// per-token K scales add 4 * kgroups bytes a token. So the design is about
// keeping enough bytes in flight on every SM (about 25 KB at 3.35 TB/s and
// 1 us of latency) and spending few instructions on each byte.
//
// Design: a block of eight warps (256 threads) takes 16 query rows (one m16
// tile: rows r = g * sq + s of the kv head's G * sq, padded with zero rows)
// and a contiguous range of KV positions of one (request, kv head):
//   * split-KV in the grid form: each (request, kv head) is cut into `splits`
//     chunks of whole 64-position tiles, one block each (grid B * Hkv x
//     splits x row blocks). The wrapper takes `splits` from what the host
//     knows (the batch and the table's width x page size: 16 at batch <= 32,
//     else 4, the reference's static rule, never more than the table's
//     tiles), never from kv_lens, and the chunks are `splits` equal runs of
//     the table's tiles. (Runs of each request's own tiles, cut on the
//     device from its kv_len, were slower on an H100: 0.0567 against 0.0524
//     ms at check_decode's shape, 0.035 against 0.029 at a serving one, as
//     every block pays a fixed cost and they make more blocks that stream
//     something; scripts/time_decode.py.) Each block writes float32
//     partials (o, m, l) to a workspace and takes an atomic ticket for its (request, kv head, row
//     block); the last block merges the chunks' partials in chunk order
//     (float4 loads, all issued before their sums), writes bf16 once and
//     resets the ticket to 0 (a zeroed int32 buffer the wrapper keeps per
//     CUDA stream). A chunk past its request's end writes the neutral
//     partial (m = -inf, l = 0; its o is never read), skipping the warps'
//     merge, and takes its ticket. With one split (splitk=False, or a
//     one-tile table) a block writes bf16 directly. The task form (one block
//     per task of a task map, float32 partials out, merged by
//     decode_combine_kernel) runs the same body over the task's range;
//   * copies: every thread issues cp.async of 16 bytes into a 3-stage ring
//     of 64-position K and V tiles, two tiles ahead of the one computed
//     (bf16 at D 128: 32 KB a stage, 64 KB in flight a block, two blocks an
//     SM). A tile's pages are looked up once, one page id a lane, a tile
//     ahead of its copies, and each row takes its page by a shuffle. Rows at
//     or past the block's end are zero-filled by cp.async itself and never
//     read (a page may hold NaN there); page ids below 0 read page 0;
//   * each warp takes 8 positions of a tile (eight warps of 8, against four
//     of 16, took the one-block-an-SM time of a tile from 2.5 to 1.6 us on
//     an H100: a warp's chain of dependent mma, ldmatrix and shuffles bounds
//     a tile, so more, shorter warps). int8 and e4m3 codes convert exactly
//     to bf16 (int8 by float, e4m3 through cvt.rn.f16x2.e4m3x2) into the
//     warp's own 16-bit rows; bf16 tiles are read from the ring in place
//     (16-byte chunks XOR-swizzled by the row, so ldmatrix is conflict-free);
//   * S = q K^T by mma.sync m16n8k16 (q and K fragments by ldmatrix; even
//     and odd k-steps into two accumulators), the logit scale sm_scale *
//     kscale * log2(e) applied to the float32 logits. Per-token K scales
//     (kgroups groups of D / kgroups columns, a multiple of 16) take one
//     product per group and sum the scaled float32 partials;
//   * online softmax per warp over its positions in the exp2 domain, each
//     row's max reduced over the 4 lanes that hold it; masked logits (past
//     the range, past the row's causal limit kv_len - sq + s) are -inf;
//   * O += P V by mma.sync m16n8k8 (the S accumulator is the A fragment of
//     a k8 product) with V fragments by ldmatrix.trans, each tile's product
//     in a fresh accumulator added to O in float32 (the running sum rounds
//     as float32 does, not as the tensor core's accumulation). P is split
//     into three bf16 terms, each the rounded remainder of those before,
//     each multiplied (P to about 2^-24, as float32 keeps it: the task
//     form's float32 partials, held to 1e-3 of the plain version's, need
//     it; one bf16 P is 2^-8, two terms 2^-16, which left decode_sched's
//     e4m3 partials just outside 1e-3 at 2048-position tasks). The sums l
//     stay float32 of the unrounded p;
//   * epilogue: the eight warps' (o, m, l) merge through shared memory (the
//     ring's), then the block writes its output or partial. A row that sees
//     no key writes 0.
// Shapes: head_dim D and Dv are multiples of 16 bytes of the cache element
// (D 72 in bf16 included), padded with zero columns to the instance's DP of
// 64, 128 or 256; a GQA group of any size (G * sq rows become row blocks of
// 16, which read the same KV range: L2 serves the repeats). Page, slot and
// head strides are arguments, so the same kernel reads the head-major HND
// cache, the NHD cache, the FUSED slab ([Hkv, nb, 2*bs, D]: V at K's address
// + bs*D) and the NHD_FUSED slab ([nb, 2*bs, Hkv*D]: K of head h, page p,
// slot s at p*2*bs*Hkv*D + s*Hkv*D + h*D, V at the same address + bs*Hkv*D)
// in place; K/V rows must be 16-byte aligned.
//
// Why the tensor cores: at G * sq = 4 the CUDA cores would keep up with the
// bytes, but at G * sq = 40 (G 8, mtp 4) float32 dots take about 10x the
// bytes time; an m16 tile pads 4 rows to 16 and costs nothing that shows.
// mma.sync, not wgmma: decode has few rows and wgmma's 64 would waste more.
//
// Registers and shared memory a block (nvcc -Xptxas -v, sm_90a, CUDA 12.8):
// DP 128 120-126 registers a thread (bf16 grid 122, tasks 126; int8 126,
// 122; e4m3 120, 122, QuantType 0 124), DP 64 86-107, DP 256 196-210 (one
// block an SM); no spills, no stack frame, in every instance. Dynamic shared memory at DP 128: bf16 100 KiB (q 4 KiB, ring 96
// KiB), codes 84 KiB (ring 48 KiB, the warps' 16-bit rows 32 KiB), plus 6
// KiB of K scales for QuantType 0; static 5.2-5.4 KiB (the chunks' merge
// weights). Two blocks an SM at DP <= 128 (launch bounds cap 128
// registers).
//
// The TPU kernels' grid of one program per request (all kv heads, to save
// DMA descriptors) and the dense, gathered scale rows of _decode_qt0_kernel
// are not copied: a block here reads its own pages and scales.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

struct e4m3_t {
  uint8_t bits;
};

constexpr int kTile = 64;                 // KV positions a tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpPos = kTile / kWarps;  // positions of a tile a warp takes
constexpr int kRowsBlk = 16;              // query rows a block: one m16 tile
constexpr int kStages = 3;                // ring of K/V tile pairs
constexpr int kMaxGroups = 8;             // K scales per (token, kv head)
constexpr int kMaxSplits = 64;            // splits of the grid form
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum Mode { kGrid = 0, kGridTok = 1, kTasks = 2 };

// Shared memory of one block, in bytes: q's 16 rows (bf16, swizzled); the
// ring of (K, V) tiles as stored (bf16 rows swizzled, 8-bit rows plain); for
// 8-bit caches each warp's 8 K and V rows in bf16 (swizzled); for QuantType
// 0 a ring of the tiles' K scales. The epilogue's merge buffer, [kWarps][16]
// [DP] float32, reuses the ring (and for codes the warps' rows after it).
template <int DP, typename T, int kMode>
struct Layout {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kRowBytes = DP * static_cast<int>(sizeof(T));
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kRowsBlk * DP * 2;
  static constexpr int kWarpRows = kQuant ? 2 * kWarpPos * DP * 2 : 0;
  static constexpr int kScratch = kRing + kStages * 2 * kTileBytes;
  static constexpr int kKs = kScratch + kWarps * kWarpRows;
  static constexpr int kKsStage = kTile * kMaxGroups * 4;
  static constexpr int kBytes = kKs + (kMode == kGridTok ? kStages * kKsStage : 0);
  static_assert(kWarps * kRowsBlk * DP * 4 <= kKs - kRing, "merge buffer");
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d += a b: a 16x8 (row), b 8x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
// d += a b: a 16x16 (row), b 16x8 (col), bf16; d 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two 8-bit codes (the low byte first) -> a bf16 pair, exactly.
__device__ __forceinline__ uint32_t widen2(const int8_t*, uint32_t two) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(two & 0xff)),
                   static_cast<float>(static_cast<int8_t>((two >> 8) & 0xff)));
}
__device__ __forceinline__ uint32_t widen2(const e4m3_t*, uint32_t two) {
  uint32_t h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(static_cast<uint16_t>(two)));
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack_bf16(f.x, f.y);
}

// Byte offset of 16-byte chunk c of row r in a [rows][DP] 16-bit tile: the
// chunk XOR-swizzled by the row, so the 8 rows of an ldmatrix hit 8
// distinct bank groups.
template <int DP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (DP * 2) + ((c ^ (r & 7)) << 4));
}

// The task form's map and partial outputs (unused by the grid form).
struct Tasks {
  const int32_t* batch;       // [cap] request, < 0 for a sentinel task
  const int32_t* head;        // [cap] kv head
  const int32_t* tile_start;  // [cap] first work tile
  const int32_t* num_tiles;   // [cap] work tiles
  int tile;                   // tokens per work tile
  float* o;                   // [cap, rows, dv] unnormalised
  float* m;                   // [cap, rows] running max (natural units)
  float* l;                   // [cap, rows] running sum
};

// The grid form's split-KV: workspace and tickets (splits 1: unused).
struct Split {
  float* ws;         // [segs, splits, 16, dv] o, then [segs, splits, 2, 16] (m, l)
  int32_t* tickets;  // [segs], zero between launches
  int splits;        // chunks a (request, kv head), cut from its own length
};

struct Args {
  const __nv_bfloat16* q;  // [B * sq, hq, d]
  const void* kc;
  const void* vc;
  int64_t k_head, k_page, k_slot, v_head, v_page, v_slot;  // strides in elements
  const int32_t* block_ids;  // [B, max_blocks]
  const int32_t* kv_lens;    // [B]
  // kTokenScale: kscale [num_pages, page_size, hkv, kgroups] per token, kv
  // head and group, vscale [hkv]; else [1] each. Null is a scale of 1.
  const float* kscale;
  const float* vscale;
  __nv_bfloat16* out;  // [B * sq, hq, dv] (grid form)
  Tasks tasks;
  Split split;
  int batch, max_blocks, page_size, sq, hq, hkv, d, dv, kgroups;
  float scale;
};

template <int DP, typename T, int kMode>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1) paged_decode_kernel(const Args a) {
  using L = Layout<DP, T, kMode>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kSteps = DP / 16;  // k-steps of S
  constexpr int kNt = DP / 8;      // n-tiles of O
  constexpr int kChunks = L::kRowBytes / 16;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float warp_m[kWarps][kRowsBlk], warp_l[kWarps][kRowsBlk];
  __shared__ float wt_s[kMaxSplits][kRowsBlk];
  __shared__ float row_m[kRowsBlk], row_l[kRowsBlk];
  __shared__ int last_s;
  const uint32_t s_base = smem_u32(smem);
  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int g_per = a.hq / a.hkv;
  const int rows = g_per * a.sq;
  const int rb = kMode == kTasks ? blockIdx.y : blockIdx.z;
  const int r0 = rb * kRowsBlk;
  int b, h, lo, hi;
  if constexpr (kMode == kTasks) {
    const int task = blockIdx.x;
    b = a.tasks.batch[task];
    if (b < 0) {  // sentinel: the neutral partial, which the combine skips
      for (int i = tid; i < kRowsBlk * a.dv; i += kThreads) {
        const int r = r0 + i / a.dv;
        if (r < rows) a.tasks.o[(static_cast<int64_t>(task) * rows + r) * a.dv + i % a.dv] = 0.f;
      }
      if (tid < kRowsBlk && r0 + tid < rows) {
        a.tasks.m[static_cast<int64_t>(task) * rows + r0 + tid] = -INFINITY;
        a.tasks.l[static_cast<int64_t>(task) * rows + r0 + tid] = 0.f;
      }
      return;
    }
    h = a.tasks.head[task];
    lo = a.tasks.tile_start[task] * a.tasks.tile;
    hi = lo + a.tasks.num_tiles[task] * a.tasks.tile;
  } else {
    // chunk blockIdx.y of `splits` runs of whole tiles of the table
    b = blockIdx.x / a.hkv;
    h = blockIdx.x % a.hkv;
    const int tiles = (a.max_blocks * a.page_size + kTile - 1) / kTile;
    const int chunk = (tiles + a.split.splits - 1) / a.split.splits;
    lo = blockIdx.y * chunk * kTile;
    hi = lo + chunk * kTile;
  }
  const int kv_len = a.kv_lens[b];
  const int n_valid = min(hi, min(kv_len, a.max_blocks * a.page_size));
  const int n_tiles = n_valid > lo ? (n_valid - lo + kTile - 1) / kTile : 0;
  const int32_t* tbl = a.block_ids + static_cast<int64_t>(b) * a.max_blocks;
  const int ps = a.page_size;
  const int ps_shift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  auto page_of = [&](int pos) { return ps_shift >= 0 ? pos >> ps_shift : pos / ps; };

  // this thread's two rows (gid, gid + 8) and their causal limits
  int lim[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + gid + 8 * hf;
    lim[hf] = r < rows ? kv_len - a.sq + r % a.sq : -1;
  }

  // q's 16 rows -> shared memory (zeros past the group's rows and past d);
  // they join the first tile's copy group
  if (n_tiles > 0) {
    constexpr int kQChunks = DP / 8;
    for (int i = tid; i < kRowsBlk * kQChunks; i += kThreads) {
      const int rr = i / kQChunks, c = i % kQChunks;
      const int r = r0 + rr;
      const bool ok = r < rows && c * 8 < a.d;
      const __nv_bfloat16* src = a.q;
      if (ok) {
        const int g = r / a.sq, s = r % a.sq;
        src = a.q + (static_cast<int64_t>(b * a.sq + s) * a.hq + h * g_per + g) * a.d + c * 8;
      }
      cp_async16(s_base + L::kQ + swz<DP>(rr, c), src, ok);
    }
  }

  // The page ids of the next tile to issue, fetched a tile ahead so their
  // latency hides behind a tile's work: one id a lane (lanes hold the tile's
  // pages p0 + lane and p0 + 32 + lane); rows take theirs by a shuffle.
  int pg_next[2] = {0, 0};
  auto fetch_pages = [&](int j) {
    const int p0 = page_of(lo + j * kTile);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = p0 + lane + 32 * u;
      pg_next[u] = j < n_tiles && p < a.max_blocks && p * ps < n_valid ? tbl[p] : 0;
    }
  };
  // Issues the copies of the j-th tile of the range (pg_next holds its pages).
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  const int k_real = a.d / kElems, v_real = a.dv / kElems;
  const T* k_head = kc + h * a.k_head;
  const T* v_head = vc + h * a.v_head;
  auto load_tile = [&](int j) {
    const int t0 = lo + j * kTile;
    const int p0 = page_of(t0);
    const int pg[2] = {max(pg_next[0], 0), max(pg_next[1], 0)};
    const uint32_t kdst0 = s_base + L::kRing + (j % kStages) * 2 * L::kTileBytes;
#pragma unroll
    for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int n = idx / kChunks, c = idx % kChunks;
      const int pos = t0 + n;
      const int pidx = page_of(pos);
      const int pi = pidx - p0;
      const int pa = __shfl_sync(0xffffffffu, pg[0], pi & 31);
      const int pb = __shfl_sync(0xffffffffu, pg[1], pi & 31);
      const int64_t page = pi < 32 ? pa : pb;
      const int64_t slot = pos - pidx * ps;
      const bool in = pos < n_valid;
      const bool kin = in && c < k_real, vin = in && c < v_real;
      const T* ksrc = kin ? k_head + page * a.k_page + slot * a.k_slot + c * kElems : kc;
      const T* vsrc = vin ? v_head + page * a.v_page + slot * a.v_slot + c * kElems : vc;
      const uint32_t off = kQuant ? static_cast<uint32_t>(n * L::kRowBytes + c * 16) : swz<DP>(n, c);
      cp_async16(kdst0 + off, ksrc, kin);
      cp_async16(kdst0 + L::kTileBytes + off, vsrc, vin);
    }
    if constexpr (kMode == kGridTok) {
      // the tile's K scales, [kTile][kgroups] (warp-uniform trip counts:
      // kTile * kgroups is a multiple of 64)
      const uint32_t kdst = s_base + L::kKs + (j % kStages) * L::kKsStage;
      for (int e = tid; e < kTile * a.kgroups; e += kThreads) {
        const int pos = t0 + e / a.kgroups;
        const int pidx = page_of(pos);
        const int pi = pidx - p0;
        const int pa = __shfl_sync(0xffffffffu, pg[0], pi & 31);
        const int pb = __shfl_sync(0xffffffffu, pg[1], pi & 31);
        const int64_t page = pi < 32 ? pa : pb;
        const bool in = pos < n_valid;
        const float* src = a.kscale;
        if (in)
          src += ((page * ps + pos - pidx * ps) * a.hkv + h) * a.kgroups + e % a.kgroups;
        cp_async4(kdst + e * 4, src, in);
      }
    }
  };

  const float sl2 =
      a.scale * (kMode != kGridTok && a.kscale != nullptr ? *a.kscale : 1.f) * kLog2e;
  float o[kNt][4];
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  const int w0 = warp * kWarpPos;  // the warp's positions in a tile
  // ldmatrix lane addresses: q (A, x4: rows 0-7 / 8-15, k 0-7 / 8-15); K (B,
  // x4: the warp's 8 positions, k 0-7 / 8-15 of two k-steps); V (B, x4
  // trans: the 8 positions, 32 columns)
  const int qa_row = (lane & 7) + ((lane >> 3) & 1) * 8, qa_c = lane >> 4;
  const int kb_row = lane & 7, kb_c = lane >> 3;

  fetch_pages(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    fetch_pages(s + 1);
    cp_async_commit();
  }
#pragma unroll 1
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j's copies (this thread's)
    __syncthreads();               // everyone's; tile j - 1's stage is free
    if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);
    fetch_pages(j + kStages);
    cp_async_commit();
    const int st = j % kStages;
    const uint8_t* ring = smem + L::kRing + st * 2 * L::kTileBytes;
    // the warp's 8 K and V rows in 16 bits: in the ring (bf16), or
    // converted into the warp's own rows (int8, e4m3)
    uint32_t k_rows, v_rows;
    if constexpr (kQuant) {
      uint8_t* k16 = smem + L::kScratch + warp * L::kWarpRows;
      uint8_t* v16 = k16 + kWarpPos * DP * 2;
      constexpr int kRawChunks = DP / 16;  // 16 codes a chunk
#pragma unroll
      for (int i = 0; i < 2 * kWarpPos * kRawChunks / 32; ++i) {
        const int idx = lane + 32 * i;
        const bool is_v = idx >= kWarpPos * kRawChunks;
        const int rem = is_v ? idx - kWarpPos * kRawChunks : idx;
        const int n = rem / kRawChunks, c = rem % kRawChunks;
        const uint4 raw = *reinterpret_cast<const uint4*>(ring + (is_v ? L::kTileBytes : 0) +
                                                          (w0 + n) * L::kRowBytes + c * 16);
        const uint32_t wv[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t o16[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o16[k] = widen2(static_cast<const T*>(nullptr), wv[k / 2] >> (16 * (k % 2)));
        uint8_t* dst = is_v ? v16 : k16;
        *reinterpret_cast<uint4*>(dst + swz<DP>(n, 2 * c)) = make_uint4(o16[0], o16[1], o16[2], o16[3]);
        *reinterpret_cast<uint4*>(dst + swz<DP>(n, 2 * c + 1)) =
            make_uint4(o16[4], o16[5], o16[6], o16[7]);
      }
      __syncwarp();
      k_rows = smem_u32(k16);
      v_rows = smem_u32(v16);
    } else {
      k_rows = smem_u32(ring) + w0 * DP * 2;  // w0 is a multiple of 8: the swizzle holds
      v_rows = k_rows + L::kTileBytes;
    }

    // S = q K^T over the warp's 8 positions (one n-tile), even and odd
    // k-steps into two accumulators (shorter dependence chains)
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kMode == kGridTok) {
      // one product per group of D / kgroups columns, each scaled by its
      // token's K scale and summed in float32
      const float* ks = reinterpret_cast<const float*>(smem + L::kKs + st * L::kKsStage);
      const int spg = a.d / a.kgroups / 16;  // k-steps a group
      float sg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k2 = 0; k2 < kSteps / 2; ++k2) {
        if (k2 * 32 < a.d) {
          uint32_t kb[4];
          ldsm_x4(kb, k_rows + swz<DP>(kb_row, 4 * k2 + kb_c));
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int kk = 2 * k2 + hf;
            if (kk * 16 < a.d) {
              uint32_t qa[4];
              ldsm_x4(qa, s_base + L::kQ + swz<DP>(qa_row, 2 * kk + qa_c));
              mma_bf16(sg, qa, kb[2 * hf], kb[2 * hf + 1]);
              if ((kk + 1) % spg == 0) {
                const int g = kk / spg;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float kv = ks[(w0 + 2 * tq + e) * a.kgroups + g];
                  s[e] += kv * sg[e];
                  s[2 + e] += kv * sg[2 + e];
                  sg[e] = 0.f;
                  sg[2 + e] = 0.f;
                }
              }
            }
          }
        }
      }
    } else {
      float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k2 = 0; k2 < kSteps / 2; ++k2) {
        if (k2 * 32 < a.d) {
          uint32_t kb[4], qa[4], qb[4];
          ldsm_x4(kb, k_rows + swz<DP>(kb_row, 4 * k2 + kb_c));
          ldsm_x4(qa, s_base + L::kQ + swz<DP>(qa_row, 4 * k2 + qa_c));
          mma_bf16(s, qa, kb[0], kb[1]);
          if (k2 * 32 + 16 < a.d) {
            ldsm_x4(qb, s_base + L::kQ + swz<DP>(qa_row, 4 * k2 + 2 + qa_c));
            mma_bf16(s2, qb, kb[2], kb[3]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += s2[e];
    }

    // mask, then the online softmax in the exp2 domain (scaled logits)
    const int pbase = lo + j * kTile + w0 + 2 * tq;
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = pbase + e;
        float& x = s[2 * hf + e];
        x = pos < n_valid && pos <= lim[hf] ? x * sl2 : -INFINITY;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hf], mx);
      alpha[hf] = m_r[hf] == m_new ? 1.f : ex2(m_r[hf] - m_new);
      const float neg = m_new == -INFINITY ? 0.f : -m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[2 * hf + e];
        x = ex2(x + neg);
        sum += x;
      }
      l_r[hf] = l_r[hf] * alpha[hf] + sum;
      m_r[hf] = m_new;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }
    }
    // P as the A operand of a k8 product (the S accumulator layout is A's),
    // in three bf16 terms: each the remainder of the ones before, rounded
    uint32_t p3[3][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x0 = s[2 * i], x1 = s[2 * i + 1];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
        p3[t][i] = *reinterpret_cast<const uint32_t*>(&hb);
        const float2 hf = __bfloat1622float2(hb);
        x0 -= hf.x;
        x1 -= hf.y;
      }
    }
    // O += P V, four n-tiles (32 columns) an ldmatrix; each tile's product
    // in a fresh accumulator, added to O in float32
#pragma unroll
    for (int n4 = 0; n4 < kNt / 4; ++n4) {
      if (n4 * 32 < a.dv) {
        uint32_t vb[4];
        ldsm_x4_t(vb, v_rows + swz<DP>(kb_row, 4 * n4 + kb_c));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int t = 0; t < 3; ++t) mma_bf16_k8(pv, p3[t][0], p3[t][1], vb[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * n4 + i][e] += pv[e];
        }
      }
    }
  }

  // epilogue: the warps' (o, m, l) -> one per row through shared memory (a
  // block with no tile, most chunks of a short request, skips the merge)
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* mbuf = reinterpret_cast<float*>(smem + L::kRing);  // [kWarps][16][DP]
  if (n_tiles == 0) {
    if (tid < kRowsBlk) {
      row_m[tid] = -INFINITY;
      row_l[tid] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) wt_s[w][tid] = 0.f;
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2 && n_tiles > 0; ++hf) {
    float l = l_r[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (tq == 0) {
      warp_m[warp][gid + 8 * hf] = m_r[hf];
      warp_l[warp][gid + 8 * hf] = l;
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
      *reinterpret_cast<float2*>(mbuf + (warp * kRowsBlk + gid + 8 * hf) * DP + 8 * nt + 2 * tq) =
          make_float2(o[nt][2 * hf], o[nt][2 * hf + 1]);
  }
  __syncthreads();
  if (tid < kRowsBlk && n_tiles > 0) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_m[w][tid]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = warp_m[w][tid] == -INFINITY ? 0.f : ex2(warp_m[w][tid] - mx);
      wt_s[w][tid] = wt;
      lsum += wt * warp_l[w][tid];
    }
    row_m[tid] = mx;
    row_l[tid] = lsum;
  }
  __syncthreads();
  auto block_o = [&](int r, int c) {  // the block's unnormalised o of row r, column c
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {  // (an empty block's mbuf is never written)
      const float wt = wt_s[w][r];
      if (wt != 0.f) v += wt * mbuf[(w * kRowsBlk + r) * DP + c];
    }
    return v;
  };
  auto out_at = [&](int r) {  // out's row of the block's row r (r0 + r < rows)
    const int g = (r0 + r) / a.sq, s = (r0 + r) % a.sq;
    return a.out + (static_cast<int64_t>(b * a.sq + s) * a.hq + h * g_per + g) * a.dv;
  };
  const float oscale = a.vscale ? a.vscale[kMode == kGridTok ? h : 0] : 1.f;

  if constexpr (kMode == kTasks) {
    const int64_t t_row = static_cast<int64_t>(blockIdx.x) * rows + r0;
    for (int i = tid; i < kRowsBlk * a.dv; i += kThreads) {
      const int r = i / a.dv, c = i % a.dv;
      if (r0 + r < rows) a.tasks.o[(t_row + r) * a.dv + c] = block_o(r, c);
    }
    if (tid < kRowsBlk && r0 + tid < rows) {
      a.tasks.m[t_row + tid] = row_m[tid] == -INFINITY ? -INFINITY : row_m[tid] * kLn2;
      a.tasks.l[t_row + tid] = row_l[tid];
    }
    return;
  } else {
    const int splits = a.split.splits;
    if (splits == 1) {
      for (int i = tid; i < kRowsBlk * a.dv; i += kThreads) {
        const int r = i / a.dv, c = i % a.dv;
        if (r0 + r < rows) {
          const float l = row_l[r];
          out_at(r)[c] = __float2bfloat16(l == 0.f ? 0.f : block_o(r, c) / l * oscale);
        }
      }
      return;
    }
    // split-KV: this chunk's partial -> workspace, then a ticket; the last
    // block of the (request, kv head, row block) merges every chunk's
    const int64_t seg = static_cast<int64_t>(blockIdx.x) * gridDim.z + rb;
    const int64_t n_part = static_cast<int64_t>(gridDim.x) * gridDim.z * splits;
    float* ws_o = a.split.ws;
    float* ws_ml = a.split.ws + n_part * kRowsBlk * a.dv;
    const int64_t part = seg * splits + blockIdx.y;
    for (int i = tid; i < kRowsBlk * a.dv; i += kThreads) {
      const int r = i / a.dv, c = i % a.dv;
      if (row_m[r] != -INFINITY) ws_o[(part * kRowsBlk + r) * a.dv + c] = block_o(r, c);
    }
    if (tid < kRowsBlk) {
      ws_ml[part * 2 * kRowsBlk + tid] = row_m[tid];
      ws_ml[part * 2 * kRowsBlk + kRowsBlk + tid] = row_l[tid];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(a.split.tickets + seg, 1) == splits - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    if (tid < kRowsBlk) {
      const float* ml = ws_ml + seg * splits * 2 * kRowsBlk;
      float mx = -INFINITY;
      for (int p = 0; p < splits; ++p) mx = fmaxf(mx, __ldcg(ml + p * 2 * kRowsBlk + tid));
      float lsum = 0.f;
      for (int p = 0; p < splits; ++p) {
        const float mp = __ldcg(ml + p * 2 * kRowsBlk + tid);
        const float wt = mp == -INFINITY ? 0.f : ex2(mp - mx);
        wt_s[p][tid] = wt;
        lsum += wt * __ldcg(ml + p * 2 * kRowsBlk + kRowsBlk + tid);
      }
      row_l[tid] = lsum;
    }
    __syncthreads();
    // 4 columns a thread, every chunk's load issued before its sum (a
    // neutral chunk's o, never written, is loaded but never added)
    const int dv4 = a.dv / 4;
    const int64_t p_stride = static_cast<int64_t>(kRowsBlk) * dv4;  // float4s between chunks
    for (int i = tid; i < kRowsBlk * dv4; i += kThreads) {
      const int r = i / dv4, c4 = i % dv4;
      if (r0 + r >= rows) continue;
      const float4* src =
          reinterpret_cast<const float4*>(ws_o + (seg * splits * kRowsBlk + r) * a.dv) + c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int p = 0; p < splits; ++p) {  // chunk order
        const float4 x = __ldcg(src + p * p_stride);
        const float wt = wt_s[p][r];
        if (wt != 0.f) {
          v.x += wt * x.x;
          v.y += wt * x.y;
          v.z += wt * x.z;
          v.w += wt * x.w;
        }
      }
      const float l = row_l[r];
      const float f = l == 0.f ? 0.f : oscale / l;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_at(r) + 4 * c4);
      dst[0] = __floats2bfloat162_rn(v.x * f, v.y * f);
      dst[1] = __floats2bfloat162_rn(v.z * f, v.w * f);
    }
    if (tid == 0) a.split.tickets[seg] = 0;  // every chunk has taken its ticket
  }
}

template <int DP, typename T, int kMode>
int launch_dp(const Args& a, int grid_x, cudaStream_t stream) {
  using L = Layout<DP, T, kMode>;
  auto kernel = paged_decode_kernel<DP, T, kMode>;
  // the attribute once an instance and device (an attribute of each device;
  // not inside a CUDA graph's capture after the device's first launch);
  // tensor-parallel ranks launch from threads
  static std::atomic<unsigned long long> granted{0};  // a bit a device
  if (L::kBytes > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if ((granted.load() & bit) == 0 || bit == 0) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      granted.fetch_or(bit);
    }
  }
  const int row_blocks = ((a.hq / a.hkv) * a.sq + kRowsBlk - 1) / kRowsBlk;
  const dim3 grid = kMode == kTasks ? dim3(grid_x, row_blocks)
                                    : dim3(grid_x, a.split.splits, row_blocks);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode>
int launch_mode(const Args& a, int grid_x, cudaStream_t stream) {
  const int dmax = a.d > a.dv ? a.d : a.dv;
  if (dmax <= 64) return launch_dp<64, T, kMode>(a, grid_x, stream);
  if (dmax <= 128) return launch_dp<128, T, kMode>(a, grid_x, stream);
  if (dmax <= 256) return launch_dp<256, T, kMode>(a, grid_x, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Cache element types of the launchers' kv_type argument.
enum KvType { kBf16 = 0, kInt8 = 1, kE4m3 = 2 };

// Checks shared by every form; grid_x is B * Hkv (grid) or the task count.
int launch(int kv_type, int mode, Args a, int grid_x, cudaStream_t stream) {
  if (grid_x == 0) return 0;
  const int elems = kv_type == kBf16 ? 8 : 16;  // elements of 16 bytes
  if (a.hkv < 1 || a.hq % a.hkv != 0 || a.sq < 1 || a.d % elems != 0 || a.dv % elems != 0 ||
      a.page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kGridTok && (a.kgroups < 1 || a.kgroups > kMaxGroups || a.d % a.kgroups != 0 ||
                           (a.d / a.kgroups) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kTasks && (a.split.splits < 1 || a.split.splits > kMaxSplits ||
                         (a.split.splits > 1 && (a.split.ws == nullptr || a.split.tickets == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kv_type) {
    case kBf16:
      if (mode == kTasks) return launch_mode<__nv_bfloat16, kTasks>(a, grid_x, stream);
      return launch_mode<__nv_bfloat16, kGrid>(a, grid_x, stream);
    case kInt8:
      if (mode == kTasks) return launch_mode<int8_t, kTasks>(a, grid_x, stream);
      return launch_mode<int8_t, kGrid>(a, grid_x, stream);
    case kE4m3:
      if (mode == kTasks) return launch_mode<e4m3_t, kTasks>(a, grid_x, stream);
      if (mode == kGridTok) return launch_mode<e4m3_t, kGridTok>(a, grid_x, stream);
      return launch_mode<e4m3_t, kGrid>(a, grid_x, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* kc, const void* vc, const int64_t* st,
               const void* block_ids, const void* kv_lens, const void* kscale, const void* vscale,
               void* out, int batch, int max_blocks, int page_size, int sq, int hq, int hkv, int d,
               int dv, int kgroups, float scale) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kc = kc;
  a.vc = vc;
  a.k_head = st[0];
  a.k_page = st[1];
  a.k_slot = st[2];
  a.v_head = st[3];
  a.v_page = st[4];
  a.v_slot = st[5];
  a.block_ids = static_cast<const int32_t*>(block_ids);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.kscale = static_cast<const float*>(kscale);
  a.vscale = static_cast<const float*>(vscale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.batch = batch;
  a.max_blocks = max_blocks;
  a.page_size = page_size;
  a.sq = sq;
  a.hq = hq;
  a.hkv = hkv;
  a.d = d;
  a.dv = dv;
  a.kgroups = kgroups;
  a.scale = scale;
  return a;
}

Split make_split(void* ws, void* tickets, int splits) {
  return Split{static_cast<float*>(ws), static_cast<int32_t*>(tickets), splits};
}

// The task form's combine: each segment (request b, kv head h) merges its
// tasks' partials into out[b * sq + s, h * g_per + g, :] for rows r =
// g * sq + s: max m over the tasks, weights w = exp(m - max) (0 at m =
// -inf), o = sum(w * o_t) / sum(w * l_t) * vscale (0 where the sum of w * l
// is 0), rounded once to bf16.
//
// Bound on the card: bytes (each partial read once, each output written
// once), but at serving's sizes a few dependent round trips to memory set
// its time, so the design cuts the chain and spreads the work:
//   * a block takes rows_per_block (<= 8) rows of one segment and a chunk of
//     its columns (col_splits chunks of VEC-float groups; the form from
//     ops/attention/decode.py:combine_form, from the segment count and the
//     head geometry only), so a map of few segments (one long request) is
//     spread over more blocks. A block's time is a fixed chain of about
//     3 us on an H100 at these sizes, so the grid is kept to one wave
//     (registers for four blocks an SM) and split no further than half
//     the SMs need;
//   * finding the segment's tasks: the block reads kCombineScan map entries
//     at once (two a thread, coalesced) and compacts its own in task order
//     with one ballot a warp and entry, a count per warp in shared memory
//     and two barriers; a map longer than kCombineScan is taken in chunks,
//     merged online (the running max, sum and output rescaled). No other
//     pass over the map, and no second launch: a block's critical path
//     holds one round trip for each 512 entries, whatever the segment
//     count (the grid reads the map once a block, from L2);
//   * the threads of a block are items (row, column group of VEC floats)
//     times task slices; each thread issues its first kCombineHeld float4
//     loads of o right after the compaction, before the weights are known;
//   * meanwhile one warp a row reads the row's (m, l) of every task, a task
//     a lane, reduces the max and sum(w * l) by shuffles and keeps the
//     weights in shared memory: computed once per (segment, row), not per
//     column. Then each thread's FMAs, one exchange between the slices
//     through shared memory, and the output.
// 64 registers a thread, no spills (ptxas, sm_90a, CUDA 12.8); shared
// memory 4.3 KB static and at most 34 KB dynamic (the chunk's task ids and
// each row's (m | w, l)).
constexpr int kCombineScan = 2 * kThreads;  // map entries compacted at once
constexpr int kCombineRows = kWarps;        // rows a block: a warp each for the weights
constexpr int kCombineHeld = 4;             // o loads a thread issues before the weights
constexpr int kCombineBlocksPerSm = 4;      // registers for four blocks an SM: 528 in one wave

struct CombineArgs {
  const float* o;  // [cap, rows, dv]
  const float* m;  // [cap, rows]
  const float* l;  // [cap, rows]
  const int32_t* t_batch;
  const int32_t* t_seg;
  const float* vscale;  // [1] or null (a scale of 1)
  __nv_bfloat16* out;
  int cap, chunk, sq, hq, hkv, dv, rows;
  int rows_per_block, col_splits, groups_per_block;
};

template <int VEC>
struct CVec {
  float v[VEC];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (VEC == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
      v[0] = __ldg(p);
    }
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads, kCombineBlocksPerSm) decode_combine_kernel(const CombineArgs p) {
  extern __shared__ float4 combine_smem[];  // [chunk] task ids, then [rows_per_block][chunk] (m | w, l)
  __shared__ float red[kThreads * VEC];     // the task slices' sums
  __shared__ float mx_s[kCombineRows], lsum_s[kCombineRows], rescale_s[kCombineRows];
  __shared__ int cnt_s[2][kWarps];
  int* tk = reinterpret_cast<int*>(combine_smem);
  float2* mw = reinterpret_cast<float2*>(tk + p.chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_blocks = (p.rows + p.rows_per_block - 1) / p.rows_per_block;
  const int cs = blockIdx.x % p.col_splits;
  const int rbk = (blockIdx.x / p.col_splits) % row_blocks;
  const int seg = blockIdx.x / (p.col_splits * row_blocks);
  const int r0 = rbk * p.rows_per_block;
  const int nr = min(p.rows_per_block, p.rows - r0);
  const int g0 = cs * p.groups_per_block;
  const int ng = min(p.groups_per_block, p.dv / VEC - g0);
  const int items = p.rows_per_block * p.groups_per_block;
  const int slices = kThreads / items;
  const int item = tid % items, slice = tid / items;
  const int ri = item / p.groups_per_block, gi = item % p.groups_per_block;
  const bool valid = slice < slices && ri < nr && gi < ng;
  const int r = r0 + ri, c = (g0 + gi) * VEC;
  const float* o_col = p.o + static_cast<int64_t>(r) * p.dv + c;
  const int64_t o_task = static_cast<int64_t>(p.rows) * p.dv;
  const float vs = p.vscale ? __ldg(p.vscale) : 1.f;
  if (tid < kCombineRows) {
    mx_s[tid] = -INFINITY;
    lsum_s[tid] = 0.f;
  }
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int base = 0; base < p.cap; base += p.chunk) {
    // the chunk's tasks of this segment, in task order
    bool mine[2];
    unsigned bal[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = base + j * kThreads + tid;
      const bool in = j * kThreads + tid < p.chunk && e < p.cap;
      const int tb = in ? __ldg(p.t_batch + e) : -1;  // both loads issued together
      const int ts = in ? __ldg(p.t_seg + e) : -1;
      mine[j] = tb >= 0 && ts == seg;
      bal[j] = __ballot_sync(0xffffffffu, mine[j]);
    }
    if (lane == 0) {
      cnt_s[0][warp] = __popc(bal[0]);
      cnt_s[1][warp] = __popc(bal[1]);
    }
    __syncthreads();  // also: every thread is done with the last chunk's tasks
    int n = 0, off[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      off[j] = n;
      for (int w = 0; w < kWarps; ++w) {
        off[j] += w < warp ? cnt_s[j][w] : 0;
        n += cnt_s[j][w];
      }
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (mine[j]) tk[off[j] + __popc(bal[j] & below)] = base + j * kThreads + tid;
    __syncthreads();

    // the first o loads, before the weights are known
    CVec<VEC> held[kCombineHeld];
#pragma unroll
    for (int i = 0; i < kCombineHeld; ++i) {
      const int k = slice + i * slices;
      if (valid && k < n) held[i].load(o_col + tk[k] * o_task);
    }
    // a warp a row: max, weights and sum(w * l), a task a lane
    if (warp < nr) {
      const int rr = r0 + warp;
      float2* row_mw = mw + warp * p.chunk;
      float cmx = -INFINITY;
#pragma unroll 2
      for (int k = lane; k < n; k += 32) {
        const int64_t tr = static_cast<int64_t>(tk[k]) * p.rows + rr;
        const float2 v = make_float2(__ldg(p.m + tr), __ldg(p.l + tr));
        row_mw[k] = v;
        cmx = fmaxf(cmx, v.x);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cmx = fmaxf(cmx, __shfl_xor_sync(0xffffffffu, cmx, o));
      const float old = mx_s[warp];
      const float mx = fmaxf(old, cmx);
      float ls = 0.f;
      for (int k = lane; k < n; k += 32) {
        const float2 v = row_mw[k];
        const float w = v.x == -INFINITY ? 0.f : expf(v.x - mx);
        row_mw[k].x = w;
        ls += w * v.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
      if (lane == 0) {
        const float rescale = old == -INFINITY ? 0.f : expf(old - mx);
        mx_s[warp] = mx;
        lsum_s[warp] = lsum_s[warp] * rescale + ls;
        rescale_s[warp] = rescale;
      }
    }
    __syncthreads();
    if (valid) {
      const float2* row_w = mw + ri * p.chunk;
      const float rs = rescale_s[ri];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= rs;
#pragma unroll
      for (int i = 0; i < kCombineHeld; ++i) {
        const int k = slice + i * slices;
        if (k < n) {
          const float w = row_w[k].x;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, held[i].v[e], acc[e]);
        }
      }
      for (int k0 = slice + kCombineHeld * slices; k0 < n; k0 += kCombineHeld * slices) {
        CVec<VEC> more[kCombineHeld];
#pragma unroll
        for (int i = 0; i < kCombineHeld; ++i) {
          const int k = k0 + i * slices;
          if (k < n) more[i].load(o_col + tk[k] * o_task);
        }
#pragma unroll
        for (int i = 0; i < kCombineHeld; ++i) {
          const int k = k0 + i * slices;
          if (k < n) {
            const float w = row_w[k].x;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, more[i].v[e], acc[e]);
          }
        }
      }
    }
  }
  if (slices > 1) {  // uniform over the block
    if (valid && slice > 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[tid * VEC + e] = acc[e];
    }
    __syncthreads();
    if (valid && slice == 0) {
      for (int s = 1; s < slices; ++s) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += red[(s * items + item) * VEC + e];
      }
    }
  }
  if (!valid || slice != 0) return;
  const float ls = lsum_s[ri];
  const int g_per = p.hq / p.hkv;
  const int b = seg / p.hkv, h = seg % p.hkv, g = r / p.sq, s = r % p.sq;
  __nv_bfloat16* dst =
      p.out + (static_cast<int64_t>(b * p.sq + s) * p.hq + h * g_per + g) * p.dv + c;
  float val[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) val[e] = ls == 0.f ? 0.f : acc[e] / ls * vs;
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(val[0], val[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(val[2], val[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  } else {
    *dst = __float2bfloat16(val[0]);
  }
}

}  // namespace

// Split K and V caches of kv_type (0 bf16, 1 int8, 2 e4m3); (head, page,
// slot) strides in elements. kscale and vscale are [1] float32 device
// scalars or null (a scale of 1). The last three arguments are the split-KV
// grid: `splits` chunks a (request, kv head); with splits > 1, ws is a
// float32 workspace of B * Hkv * ceil(G * sq / 16) * splits * 16 * (dv + 2)
// elements and tickets an int32 buffer of B * Hkv * ceil(G * sq / 16)
// zeros (left zero); with splits 1 both may be null.
extern "C" int hpc_paged_decode(
    const void* q, const void* kcache, const void* vcache, int kv_type,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const void* kscale, const void* vscale, const void* block_ids, const void* kv_lens,
    void* out, int batch, int max_blocks, int page_size, int sq, int hq, int hkv, int d, int dv,
    float scale, void* stream, void* ws, void* tickets, int splits) {
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  Args a = make_args(q, kcache, vcache, st, block_ids, kv_lens, kscale, vscale, out, batch,
                     max_blocks, page_size, sq, hq, hkv, d, dv, 1, scale);
  a.split = make_split(ws, tickets, splits);
  return launch(kv_type, kGrid, a, batch * hkv, static_cast<cudaStream_t>(stream));
}

// QuantType 0: e4m3 K and V caches, kscale [num_pages, page_size, hkv,
// kgroups] float32 (per token and kv head, kgroups scales each over d /
// kgroups consecutive columns, a multiple of 16; paged like the cache),
// vscale [hkv] float32 or null. The split-KV arguments as hpc_paged_decode's.
extern "C" int hpc_paged_decode_qt0(
    const void* q, const void* kcache, const void* vcache,
    int64_t k_head_stride, int64_t k_page_stride, int64_t k_slot_stride,
    int64_t v_head_stride, int64_t v_page_stride, int64_t v_slot_stride,
    const void* kscale, const void* vscale, const void* block_ids, const void* kv_lens,
    void* out, int batch, int max_blocks, int page_size, int sq, int hq, int hkv, int d, int dv,
    int kgroups, float scale, void* stream, void* ws, void* tickets, int splits) {
  if (kscale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t st[6] = {k_head_stride, k_page_stride, k_slot_stride,
                         v_head_stride, v_page_stride, v_slot_stride};
  Args a = make_args(q, kcache, vcache, st, block_ids, kv_lens, kscale, vscale, out, batch,
                     max_blocks, page_size, sq, hq, hkv, d, dv, kgroups, scale);
  a.split = make_split(ws, tickets, splits);
  return launch(kE4m3, kGridTok, a, batch * hkv, static_cast<cudaStream_t>(stream));
}

// The NHD_FUSED slab [num_pages, 2*page_size, hkv*d] of kv_type. kscale and
// vscale are [1] float32 device scalars or null (a scale of 1). The split-KV
// arguments as hpc_paged_decode's.
extern "C" int hpc_paged_decode_nhd_fused(
    const void* q, const void* kv_slab, int kv_type, const void* kscale, const void* vscale,
    const void* block_ids, const void* kv_lens, void* out, int batch, int max_blocks,
    int page_size, int sq, int hq, int hkv, int d, float scale, void* stream, void* ws,
    void* tickets, int splits) {
  const int64_t slot = static_cast<int64_t>(hkv) * d;
  const int64_t page = 2 * page_size * slot;
  const int64_t st[6] = {d, page, slot, d, page, slot};
  // a page's V rows follow its page_size K rows
  const int64_t v_off = page_size * slot * (kv_type == kBf16 ? 2 : 1);  // bytes
  Args a = make_args(q, kv_slab, static_cast<const uint8_t*>(kv_slab) + v_off, st, block_ids,
                     kv_lens, kscale, vscale, out, batch, max_blocks, page_size, sq, hq, hkv, d, d,
                     1, scale);
  a.split = make_split(ws, tickets, splits);
  return launch(kv_type, kGrid, a, batch * hkv, static_cast<cudaStream_t>(stream));
}

// Task form: K and V of kv_type read as [hkv, num_pages, page_size, d] with
// the given (head, page, slot) strides in elements (HND, NHD and both fused
// slabs in place), a block per task of the map's `cap` entries and 16 query
// rows; writes the float32 partials o [cap, G*sq, dv] (unnormalised), m and
// l [cap, G*sq]. kscale is a [1] float32 device scalar or null; the V scale
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
  Args a = make_args(q, kcache, vcache, st, block_ids, kv_lens, kscale, nullptr, nullptr, 0,
                     max_blocks, page_size, sq, hq, hkv, d, dv, 1, scale);
  a.tasks = Tasks{static_cast<const int32_t*>(t_batch), static_cast<const int32_t*>(t_head),
                  static_cast<const int32_t*>(t_tile_start),
                  static_cast<const int32_t*>(t_num_tiles), tile, static_cast<float*>(o),
                  static_cast<float*>(m), static_cast<float*>(l)};
  return launch(kv_type, kTasks, a, cap, static_cast<cudaStream_t>(stream));
}

// Merges the task partials of hpc_paged_decode_tasks by segment (request *
// hkv + kv head; tasks with t_batch < 0 skipped) into out [B*sq, hq, dv]
// bf16, times vscale ([1] float32 or null). The form (ops/attention/decode.py:
// combine_form): rows_per_block (1..8) rows and one of col_splits chunks of
// the dv / vec column groups a block, vec 4 (o 16-byte aligned, dv a
// multiple of 4) or 1, at most 256 (row, group) items a block.
extern "C" int hpc_decode_combine(
    const void* o, const void* m, const void* l, const void* t_batch, const void* t_seg, int cap,
    const void* vscale, void* out, int batch, int sq, int hq, int hkv, int dv, int rows_per_block,
    int col_splits, int vec, void* stream) {
  if (batch == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || dv <= 0 || (vec != 1 && vec != 4) || dv % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int rows = hq / hkv * sq;
  const int groups = dv / vec;
  if (rows_per_block < 1 || rows_per_block > kCombineRows || col_splits < 1 || col_splits > groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gpb = (groups + col_splits - 1) / col_splits;
  if (rows_per_block * gpb > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = cap < kCombineScan ? (cap + 1) / 2 * 2 : kCombineScan;  // even: float2 after
  CombineArgs a{static_cast<const float*>(o), static_cast<const float*>(m),
                static_cast<const float*>(l), static_cast<const int32_t*>(t_batch),
                static_cast<const int32_t*>(t_seg), static_cast<const float*>(vscale),
                static_cast<__nv_bfloat16*>(out), cap, chunk, sq, hq, hkv, dv, rows,
                rows_per_block, col_splits, gpb};
  const int blocks = batch * hkv * ((rows + rows_per_block - 1) / rows_per_block) * col_splits;
  const size_t smem = sizeof(int) * chunk + sizeof(float2) * rows_per_block * chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    decode_combine_kernel<4><<<blocks, kThreads, smem, s>>>(a);
  else
    decode_combine_kernel<1><<<blocks, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
