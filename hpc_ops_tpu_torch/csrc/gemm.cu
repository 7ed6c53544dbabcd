// Route GEMM, float32-accurate through split bf16 weights:
//   out[m, n] = sum_k x[m, k] * w_high[n, k] + scale * sum_k x[m, k] * w_low[n, k]
// with x [M, K], w_high and w_low [N, K] bf16 (K contiguous), two float32
// accumulators, and out [M, N] bf16 or float32.
//
// Replaces: hpc_ops_tpu/ops/gemm.py:_route_gemm_kernel (reached through
// _route_gemm_pallas from gemm_bf16xfp32; launcher hpc_route_gemm). As there,
// one load of each x tile feeds both products and the output is written once.
//
// Bound on the card: operations at prefill and square shapes (2 * 2 * M * N * K
// bf16 operations); bytes at router decode shapes (N = 256 experts: the
// weights, 2 * 2 * N * K bytes, dominate).
//
// Design. Both products run on Hopper's tensor cores: wgmma.mma_async
// m64nNk16, bf16 operands K-major in shared memory in the 128-byte swizzle,
// float32 sums. Per k16 step two wgmmas share one operand's descriptor and
// write two accumulator sets (hi against w_high, lo against w_low). K walks
// 64-element stages (one 128-byte swizzle row) through a 4-stage ring;
// thread 0 fills a slot with three TMA boxes (x, w_high, w_low; tensor maps
// encoded on the host and kept by what they encode, so a call on operands
// seen before encodes none) that complete on the slot's mbarrier, and
// K past k and rows past m or n arrive as zeros. Each stage's products are
// issued, then the previous stage's are waited for (wgmma.wait_group 1) and
// one __syncthreads frees its slot for the next box, so the tensor cores
// work through the barrier. The host picks the body, the tile and the
// split of K (ops/gemm.py:route_form):
//  - large M: a block of two consumer warpgroups computes 128 rows of x by
//    128 weight rows; A is the warpgroup's 64 rows of x, B the w_high and
//    the w_low tile (m64n128k16: 2 x 64 sums a thread). Tiles are walked in
//    bands of 16 row panels so that the blocks in flight share x and weight
//    panels in L2. 48 KiB a stage, one block an SM.
//  - small M (the router's M <= 256): the weights take wgmma's 64-row side,
//    out^T = W x^T: A is 64 rows of w_high and of w_low, B is TN = 16, 32 or
//    64 tokens of x. One warpgroup a block, 72-96 KiB of ring. (An 8-stage
//    ring ran within 5% of it on an H100: scripts/time_route_allreduce.py.)
//  - Split K: where the output tiles alone would leave SMs idle, K is cut
//    into `splits` runs of whole stages (the first stages % splits runs one
//    stage longer). Each split writes its float32 hi and lo sums to a
//    workspace in the accumulators' own layout (coalesced float4s); the last
//    block of a tile, found by an atomic ticket, adds the splits' sums in
//    split order, forms the output and resets the ticket for the next call.
//    The result is the same in every call and in any order of the blocks.
// The epilogue forms hi + scale * lo with one rounding each (no FMA), as
// the plain version does.
//
// What bounds it (H100 80GB HBM3 at 700 W, scripts/time_route_allreduce.py):
//  - large M: L2 and shared memory traffic into the tensor cores (a 128 x 128
//    tile brings 48 KiB a stage for 4.2 M operations: 87 operations a byte,
//    about 11 TB/s of L2 traffic at the bf16 rate); 0.70-0.73 of its
//    operations bound at 16384 x 256 x 7168, 4096^3 and 8192^3, 0.53 at
//    4096 x 256 x 7168 (64 tiles, two splits).
//  - small M: the bytes the slowest block moves, about 90 GB/s a block: its
//    stages (the weights are read once per token tile, x once per weight
//    tile, mostly from L2) and, for the tile's last block, the merge (splits
//    x tile x 8 bytes), plus a fixed 5-6 us (the launch, the first boxes,
//    the ticket); 0.29 of the bytes bound at the router's 256 x 256 x 7168.
//    A grid past 132 blocks ran slower (two blocks sharing an SM), so no
//    split goes past it.
//  - the host, at the router's shapes: a call costs it about 18 us (the
//    wrapper's checks, the output's allocation, the launch), more than the
//    kernel's 12 us of device time. Keeping the tensor maps, a raw stream
//    handle and cheaper checks took it down from about 32 us.
// Not done: a producer warp, TMA multicast across a cluster (the blocks of
// one weight panel), a persistent grid, a merge spread over a tile's blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <cstring>

#include "tma.cuh"    // mbarriers, TMA box loads, the tensor-map encoder
#include "wgmma.cuh"  // the wgmma fence, commit and wait, descriptors

namespace {

constexpr int BK = 64;     // K elements of a stage: one 128-byte swizzle row
constexpr int kBand = 16;  // row panels of a band (large body)

template <bool SMALL, int TN>
struct Layout {
  static constexpr int WG = SMALL ? 1 : 2;  // consumer warpgroups
  static constexpr int THREADS = 128 * WG;
  static constexpr int A_ROWS = 64 * WG;    // A side: rows of x (large) or of each weight (small)
  static constexpr int NA = SMALL ? 2 : 1;  // A tiles a stage
  static constexpr int NB = SMALL ? 1 : 2;  // B tiles a stage (TN rows each)
  static constexpr int A_BYTES = A_ROWS * 128;
  static constexpr int B_BYTES = TN * 128;  // a multiple of 1024: the swizzle's period
  static constexpr int STAGE = NA * A_BYTES + NB * B_BYTES;
  static constexpr int STAGES = 4;  // the ring's slots
  static constexpr int SMEM = 1024 + STAGES * STAGE;  // 1024: alignment
  static constexpr int R = TN / 2;                      // float32 sums a thread, each accumulator
  static constexpr int TILE_M = SMALL ? TN : A_ROWS;    // rows of x (tokens) an output tile
  static constexpr int TILE_N = SMALL ? A_ROWS : TN;    // weight rows (output columns)
};

struct Params {
  const float* scale;
  void* out;
  float* ws;     // splits > 1: [tiles * splits][2][R / 4][THREADS][4] float32 sums
  int* tickets;  // splits > 1: [tiles], zero between calls
  int m, n, tiles_m, tiles_n, splits, stages;
};

// Keeps the compiler from moving uses of the registers an in-flight wgmma
// writes across the fence, commit and wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RG_OP8(d, i)                                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define RG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define RG_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define RG_D32                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define RG_D64                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
// scale-d is a predicate operand: set from a register holding 1 (add to d)
#define RG_WGMMA(N, D, A, B, P)                                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                                              \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " D ", %" #A ", %" #B                \
  ", p, 1, 1, 0, 0;\n}\n"

// One k16 product of a warpgroup, 64 rows by N columns, A and B K-major
// bf16 from shared memory, added to d.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 16) {
    asm volatile(RG_WGMMA(16, RG_D8, 8, 9, 10) : RG_OP8(d, 0) : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(RG_WGMMA(32, RG_D16, 16, 17, 18) : RG_OP8(d, 0), RG_OP8(d, 8) : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(RG_WGMMA(64, RG_D32, 32, 33, 34)
                 : RG_OP8(d, 0), RG_OP8(d, 8), RG_OP8(d, 16), RG_OP8(d, 24)
                 : "l"(a), "l"(b), "r"(1));
  } else {
    static_assert(N == 128, "the route GEMM's wgmma widths are 16, 32, 64 and 128");
    asm volatile(RG_WGMMA(128, RG_D64, 64, 65, 66)
                 : RG_OP8(d, 0), RG_OP8(d, 8), RG_OP8(d, 16), RG_OP8(d, 24), RG_OP8(d, 32),
                   RG_OP8(d, 40), RG_OP8(d, 48), RG_OP8(d, 56)
                 : "l"(a), "l"(b), "r"(1));
  }
}

template <bool FP32_OUT>
__device__ __forceinline__ void store_out(void* out, int64_t at, float v) {
  if constexpr (FP32_OUT) {
    static_cast<float*>(out)[at] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(v);
  }
}

template <bool SMALL, int TN, bool FP32_OUT>
__global__ void __launch_bounds__(SMALL ? 128 : 256, 1) route_gemm_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap hmap,
    const __grid_constant__ CUtensorMap lmap, const Params p) {
  using L = Layout<SMALL, TN>;
  constexpr int R = L::R, THREADS = L::THREADS, kStages = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  __shared__ __align__(8) uint64_t s_full[kStages];  // a slot's boxes have landed
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, warp = (tid >> 5) & 3;

  // The block's output tile and its run of K stages.
  const int tiles = p.tiles_m * p.tiles_n;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  int tm, tn;
  if constexpr (SMALL) {
    tm = tile / p.tiles_n;
    tn = tile % p.tiles_n;
  } else {  // bands of kBand row panels, column by column within a band
    const int band = tile / (kBand * p.tiles_n);
    const int first = band * kBand;
    const int rows = min(kBand, p.tiles_m - first);
    const int in = tile - first * p.tiles_n;
    tm = first + in % rows;
    tn = in / rows;
  }
  const int x_row0 = tm * L::TILE_M, w_row0 = tn * L::TILE_N;
  const int q = p.stages / p.splits, rem = p.stages % p.splits;
  const int kt0 = split * q + min(split, rem);
  const int nst = q + (split < rem ? 1 : 0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&s_full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto fill = [&](int slot, int kt) {  // thread 0: stage kt's three boxes into a slot
    const uint32_t bar = smem_u32(&s_full[slot]);
    const uint32_t base = s_base + slot * L::STAGE;
    mbar_expect_tx(bar, L::STAGE);
    if constexpr (SMALL) {
      tma_load_2d(base, &hmap, kt * BK, w_row0, bar);
      tma_load_2d(base + L::A_BYTES, &lmap, kt * BK, w_row0, bar);
      tma_load_2d(base + 2 * L::A_BYTES, &xmap, kt * BK, x_row0, bar);
    } else {
      tma_load_2d(base, &xmap, kt * BK, x_row0, bar);
      tma_load_2d(base + L::A_BYTES, &hmap, kt * BK, w_row0, bar);
      tma_load_2d(base + L::A_BYTES + L::B_BYTES, &lmap, kt * BK, w_row0, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages && s < nst; ++s) fill(s, kt0 + s);
  }

  float hi[R], lo[R];
#pragma unroll
  for (int i = 0; i < R; ++i) hi[i] = lo[i] = 0.f;

  for (int i = 0; i < nst; ++i) {
    const int slot = i % kStages;
    mbar_wait(smem_u32(&s_full[slot]), (i / kStages) & 1);
    const uint32_t base = s_base + slot * L::STAGE;
    fence_acc(hi);
    fence_acc(lo);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // k16 steps: 32 bytes into each 128-byte row
      if constexpr (SMALL) {
        const uint64_t b = desc_sw128(base + 2 * L::A_BYTES + ks * 32);
        wgmma_bf16<TN>(hi, desc_sw128(base + ks * 32), b);
        wgmma_bf16<TN>(lo, desc_sw128(base + L::A_BYTES + ks * 32), b);
      } else {
        const uint64_t a = desc_sw128(base + wg * 64 * 128 + ks * 32);
        wgmma_bf16<TN>(hi, a, desc_sw128(base + L::A_BYTES + ks * 32));
        wgmma_bf16<TN>(lo, a, desc_sw128(base + L::A_BYTES + L::B_BYTES + ks * 32));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage i - 1's products are done in this warpgroup ...
    __syncthreads();  // ... and in every one: its slot is free
    if (tid == 0 && i >= 1 && i - 1 + kStages < nst) fill((i - 1) % kStages, kt0 + i - 1 + kStages);
  }
  wgmma_wait<0>();
  fence_acc(hi);
  fence_acc(lo);

  if (p.splits > 1) {
    // this split's sums -> the workspace; the tile's last block merges
    const int64_t part = static_cast<int64_t>(tile) * p.splits + split;
    float4* w4 = reinterpret_cast<float4*>(p.ws) + part * 2 * (R / 4) * THREADS + tid;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      __stcg(w4 + j * THREADS, make_float4(hi[4 * j], hi[4 * j + 1], hi[4 * j + 2], hi[4 * j + 3]));
      __stcg(w4 + (R / 4 + j) * THREADS,
             make_float4(lo[4 * j], lo[4 * j + 1], lo[4 * j + 2], lo[4 * j + 3]));
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(p.tickets + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const float4* r4 = reinterpret_cast<const float4*>(p.ws) +
                       static_cast<int64_t>(tile) * p.splits * 2 * (R / 4) * THREADS + tid;
    // batches of loads before their adds: G float4s of each sum from U
    // splits, 16 float4s a thread in flight
    constexpr int G = R / 4 < 8 ? R / 4 : 8;
    constexpr int U = 8 / G;
#pragma unroll
    for (int j0 = 0; j0 < R / 4; j0 += G) {
      for (int s0 = 0; s0 < p.splits; s0 += U) {
        float4 vh[U][G], vl[U][G];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (s0 + u < p.splits) {
            const float4* src = r4 + static_cast<int64_t>(s0 + u) * 2 * (R / 4) * THREADS;
#pragma unroll
            for (int j = 0; j < G; ++j) {
              vh[u][j] = __ldcg(src + (j0 + j) * THREADS);
              vl[u][j] = __ldcg(src + (R / 4 + j0 + j) * THREADS);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {  // split order
          if (s0 + u < p.splits) {
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const float h4[4] = {vh[u][j].x, vh[u][j].y, vh[u][j].z, vh[u][j].w};
              const float l4[4] = {vl[u][j].x, vl[u][j].y, vl[u][j].z, vl[u][j].w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * (j0 + j) + e;
                hi[i] = s0 + u == 0 ? h4[e] : __fadd_rn(hi[i], h4[e]);
                lo[i] = s0 + u == 0 ? l4[e] : __fadd_rn(lo[i], l4[e]);
              }
            }
          }
        }
      }
    }
    if (tid == 0) p.tickets[tile] = 0;  // every split has taken its ticket
  }

  // Register 4c + 2h + e of a thread: accumulator row 16 warp + lane / 4 +
  // 8 h of its warpgroup, column 8 c + 2 (lane % 4) + e. Large body: rows
  // are rows of x, columns weight rows; small body the other way round.
  const float s = p.scale[0];
#pragma unroll
  for (int c = 0; c < TN / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ar = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
        const int ac = 8 * c + 2 * (lane & 3) + e;
        const int row = x_row0 + (SMALL ? ac : ar), col = w_row0 + (SMALL ? ar : ac);
        if (row < p.m && col < p.n) {
          const int i = 4 * c + 2 * h + e;
          store_out<FP32_OUT>(p.out, static_cast<int64_t>(row) * p.n + col,
                              __fadd_rn(hi[i], __fmul_rn(s, lo[i])));
        }
      }
}

// A [rows, k] bf16 matrix as a 2D tensor map, boxes of `box_rows` rows x 64
// elements (128 bytes) in the 128-byte swizzle; out-of-bounds elements
// arrive as zeros.
int bf16_map(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  std::memset(map, 0, sizeof(*map));
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor maps of a host thread's recent operands, by what a map encodes
// (base, rows, k, box rows), so that a call does not encode three maps on
// the host: a router's weights, and through the caching allocator its
// activations, come back at the same addresses.
struct MapEntry {
  CUtensorMap map;
  const void* base;
  int rows, k, box_rows;
};
constexpr int kMapCache = 16;

int cached_map(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  thread_local MapEntry cache[kMapCache] = {};
  thread_local int next = 0;
  for (const MapEntry& e : cache) {
    if (e.base == base && e.rows == rows && e.k == k && e.box_rows == box_rows) {
      *map = e.map;
      return 0;
    }
  }
  MapEntry& e = cache[next];
  next = (next + 1) % kMapCache;
  e.base = nullptr;
  const int rc = bf16_map(&e.map, base, rows, k, box_rows);
  if (rc != 0) return rc;
  e.base = base;
  e.rows = rows;
  e.k = k;
  e.box_rows = box_rows;
  *map = e.map;
  return 0;
}

template <bool SMALL, int TN, bool FP32_OUT>
int launch(const void* x, const void* wh, const void* wl, Params p, int k, cudaStream_t stream) {
  using L = Layout<SMALL, TN>;
  auto kernel = route_gemm_kernel<SMALL, TN, FP32_OUT>;
  CUtensorMap xmap, hmap, lmap;
  int e = cached_map(&xmap, x, p.m, k, L::TILE_M);
  if (e == 0) e = cached_map(&hmap, wh, p.n, k, L::TILE_N);
  if (e == 0) e = cached_map(&lmap, wl, p.n, k, L::TILE_N);
  if (e != 0) return e;
  // more than 48 KB of dynamic shared memory: an attribute of each device
  static std::atomic<unsigned long long> configured{0};  // a bit a device
  int dev = 0;
  cudaError_t c = cudaGetDevice(&dev);
  if (c != cudaSuccess) return static_cast<int>(c);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if ((configured.load(std::memory_order_relaxed) & bit) == 0 || bit == 0) {
    c = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (c != cudaSuccess) return static_cast<int>(c);
    configured.fetch_or(bit, std::memory_order_relaxed);
  }
  p.tiles_m = (p.m + L::TILE_M - 1) / L::TILE_M;
  p.tiles_n = (p.n + L::TILE_N - 1) / L::TILE_N;
  const int64_t blocks = static_cast<int64_t>(p.tiles_m) * p.tiles_n * p.splits;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), L::THREADS, L::SMEM, stream>>>(xmap, hmap, lmap, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool FP32_OUT>
int dispatch(const void* x, const void* wh, const void* wl, const Params& p, int k, int small,
             int tn, cudaStream_t stream) {
  if (!small && tn == 128) return launch<false, 128, FP32_OUT>(x, wh, wl, p, k, stream);
  if (small && tn == 16) return launch<true, 16, FP32_OUT>(x, wh, wl, p, k, stream);
  if (small && tn == 32) return launch<true, 32, FP32_OUT>(x, wh, wl, p, k, stream);
  if (small && tn == 64) return launch<true, 64, FP32_OUT>(x, wh, wl, p, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [m, k], w_high and w_low: [n, k] bf16, each row-contiguous and 16-byte
// aligned with k a multiple of 8 (16-byte rows); scale: [1] float32 on the
// device; out: [m, n] float32 (fp32_out) or bf16. The form, from
// ops/gemm.py:route_form: small (1: weights on wgmma's 64-row side, tn
// tokens a tile, tn 16, 32 or 64; 0: 128 x 128 tiles, tn 128) and splits
// (1 to ceil(k / 64)); with splits > 1, ws holds tiles * splits * 2 *
// tile_m * tile_n float32 and tickets tiles int32 zeros, which the kernel
// leaves zero. Returns a cudaError_t code.
extern "C" int hpc_route_gemm(const void* x, const void* w_high, const void* w_low,
                              const void* scale, void* out, int m, int n, int k, int fp32_out,
                              void* ws, void* tickets, int small, int tn, int splits,
                              void* stream) {
  if (k % 8 != 0 || m < 0 || n < 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  const int stages = (k + BK - 1) / BK;
  if (splits < 1 || splits > stages || (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(scale), out, static_cast<float*>(ws),
           static_cast<int*>(tickets), m, n, 0, 0, splits, stages};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp32_out ? dispatch<true>(x, w_high, w_low, p, k, small, tn, s)
                  : dispatch<false>(x, w_high, w_low, p, k, small, tn, s);
}
