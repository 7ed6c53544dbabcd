// Fused all-reduce + residual add + RMSNorm over the ranks of a
// tensor-parallel group: each rank r holds a partial x_r [n, h] bf16, its copy
// of the residual [n, h] bf16 and of the norm weight [h] float32, and gets
//   out_res = sum_s float32(x_s) + float32(residual)
//   out     = norm(out_res) * weight          (both [n, h] bf16)
// with every rank's outputs bitwise equal.
//
// Replaces: hpc_ops_tpu/parallel/collective_kernels.py:_one_shot_kernel
// (reached through fuse_allreduce_rmsnorm_pallas(mode="one_shot")) and
// _two_shot_kernel (mode="two_shot"); launchers hpc_allreduce_rmsnorm (one
// launch for a group whose ranks share a device) and
// hpc_allreduce_rmsnorm_rank (the per-device form: a launch a rank).
//
// Bound on the card: bytes (a few operations per element). Each partial is
// read once, the residual and weight once, and each rank's two outputs are
// written once.
//
// Design. The ranks of a group are virtual ranks on one device (one host
// thread each), and one cooperative launch serves all of them: blockIdx.y is
// a rank, and a rank table holds every rank's partial, residual, weight and
// outputs. A signal pad in device memory plays the TPU kernel's per-slot
// semaphores: block 0 of rank r raises ready[r] (after r * skew spins of
// about 100 ns: the TPU kernel's staggered-arrival test hook). Before its
// first row a block polls the ready flags of all ws slabs at once (lane s of
// warp 0 waits on ready[s], ld.acquire.gpu, bounded by about 1 s of
// %globaltimer, then __trap); the counters only grow: a call waits for each
// flag to reach its epoch, so nothing is reset between calls. The epoch (the
// calls completed on the pad) lives in the pad, not on the host: every
// launch reads it there (with the flags' first load) and advances it by one
// quantum (2^20) shared out among its blocks, each adding its share once it
// has read the epoch (block (0, 0) the quantum less one for every other
// block, the others one), so a value read while the launch runs rounds down
// to the launch's own epoch and the last share completes it; two_shot's
// done counts grow a quantum a call the same way. So a launch replayed from
// a captured CUDA graph, whose arguments were frozen at capture, waits for
// the right counts, eager calls and replays share one count, and no block
// waits on a ticket (a last-block ticket cost 0.5-0.9 us a launch at the
// decode shape). The slabs are
// the callers' partials, which the next call cannot overwrite while this one
// runs (the launch is stream-ordered after every rank's work, and every
// rank's stream waits on it). The grid is sized from the occupancy query so
// that all ranks' blocks are resident at once (an over-large cooperative
// grid is a launch error, not a deadlock). A block stages its rank's norm
// weight in shared memory while it polls. One row a block of 128 threads,
// each thread holding up to 8 chunks of 8 columns in registers (h <= 8192);
// for each chunk a thread issues the loads of every slab and of the residual
// before its first add, so a row costs one round trip to memory, not one a
// slab. The block that reduces a row writes both outputs of the row into
// every rank's outputs, with streaming stores (st.global.cs) so that the
// copies, two thirds of the bound's bytes, do not evict partials still to
// be read. The residual and the weight are replicated by contract; the
// block reads its own rank's copy.
//   * one_shot: the group's blocks share the rows (block b of B = ws x
//     gridDim.x takes rows b, b + B, ...), so each partial is read once:
//     acc = 0 + x_0 + x_1 + ... + x_{ws-1}, in absolute rank order.
//   * two_shot: rank r's blocks own rows [r*C, (r+1)*C), C = n / ws: acc =
//     x_r, then + x_s for s != r in absolute order; after its rows a block
//     adds its share of the call's quantum to done[r], and block 0 of each
//     rank waits until every owner's count reaches the next quantum, the
//     all-gather's completion.
// The row's sum of squares is taken in a fixed order that the plain version
// (parallel/collective_kernels.py) repeats with tensor operations: thread t
// adds, in float32 with no fused multiply-add, the squares of its chunks
// t, t + 128, ... (8 columns each, in column order); the 32 lanes of each
// warp are added by halving (lane i + lane i + 16, then + 8, ...); the 4
// warp sums as (w0 + w2) + (w1 + w3). Then mean = sum / h and rms = 1 /
// sqrt(mean + eps), each correctly rounded. Epilogues: the TPU kernel's
// bf16((out_res * rms) * w), or (kBf16Norm) the one of
// parallel/collectives.py:_norm, bf16(bf16(out_res * rms) * bf16(w)).
// Partials are read with ld.global.cg (L2, not the SM's L1), so a partial
// written by a peer during the launch would be seen.
//
// The per-device form (allreduce_rmsnorm_rank_kernel) serves a group whose
// ranks lie on more than one device, where one cooperative launch cannot
// reach every rank: each rank launches its own blocks on its own stream and
// reduces its share of the rows (one_shot rows r, r + ws, ...; two_shot its
// chunk) with the same row body, reading the peers' partials through the
// rank table's pointers (peer memory across devices) and writing both
// outputs of each row into every rank's outputs. The host orders it with
// events, not flags: the last rank to arrive makes each rank's stream wait
// on every rank's arrival event before its launch, and each rank's stream
// then waits on every launch's done event. No block spins on another
// launch, so launches of virtual ranks on one card cannot deadlock for want
// of co-resident blocks, and the cross-stream waits are graph edges under a
// capture.
//
// What bounds it (H100 80GB HBM3 at 700 W, scripts/time_route_allreduce.py):
// bytes at prefill sizes (world 8 x 32768 x 7168: 0.82 of the bound, both
// schedules); at slice_full_tp's decode collective (4 ranks x 8 rows x 4096)
// a few blocks pay a launch and three dependent round trips to memory (the
// flags, the row, the stores' drain): about 5.6 us of device time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;  // 8-column chunks a thread holds
constexpr unsigned long long kWaitNs = 1000000000ull;

struct RankTable {
  const __nv_bfloat16* x[kMaxRanks];    // partials [n, h]
  const __nv_bfloat16* res[kMaxRanks];  // residuals [n, h]
  const float* w[kMaxRanks];            // norm weights [h]
  __nv_bfloat16* out[kMaxRanks];        // [n, h]
  __nv_bfloat16* out_res[kMaxRanks];    // [n, h]
};

// The signal pad: kPadWords uint64 on the device, zero when first used and
// kept for the group.
constexpr int kPadWords = 2 * kMaxRanks + 1;
// A launch adds one quantum to the epoch and (two_shot) to each rank's done
// count, shared out among its blocks, so a value read while the launch runs
// rounds down to the launch's own epoch.
constexpr unsigned long long kQuantum = 1ull << 20;
struct Signals {
  unsigned long long* ready;  // [kMaxRanks] slabs ready, one count per call
  unsigned long long* done;   // [kMaxRanks] two_shot chunks written, a quantum per call
  unsigned long long* epoch;  // calls completed on the pad, in quanta
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Waits, bounded, until *flag >= target (one thread). A flag that never
// comes traps after about 1 s: a CUDA error at the next sync, not a hang.
__device__ __forceinline__ void spin_until(const unsigned long long* flag, unsigned long long target) {
  const unsigned long long t0 = global_ns();
  while (load_acquire(flag) < target) {
    if (global_ns() - t0 > kWaitNs) __trap();
    __nanosleep(32);
  }
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Lanes 0 .. count - 1 of warp 0 wait until flags[lane] reaches the epoch
// after the one in *epoch; then the block goes on. The epoch's load goes
// out with the flag's first, so a flag already up costs one round trip.
__device__ void wait_flags(const unsigned long long* flags, int count, const unsigned long long* epoch) {
  if (threadIdx.x < count) {
    const unsigned long long target = load_relaxed(epoch) / kQuantum + 1;
    if (load_acquire(flags + threadIdx.x) < target) spin_until(flags + threadIdx.x, target);
  }
  __syncthreads();
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(b[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);  // streaming: evict first, keep the partials in L2
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Reduces row ``row`` of the group (every slab's chunk, the residual, the
// norm) and writes both outputs of the row into every rank's outputs. rank:
// the rank whose copies of the residual and weight (staged in w_s) are read,
// and under two_shot the row's owner, whose slab is added first. Every
// thread of the block calls it (it holds two barriers).
template <bool kTwoShot, bool kBf16Norm>
__device__ __forceinline__ void reduce_row(const RankTable& t, int rank, int ws, int row, int h,
                                           float eps, const float4* w_s, float* warp_s) {
  const int64_t off = static_cast<int64_t>(row) * h;
  const int nchunks = h / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* res = t.res[rank] + off;
  float acc[kMaxChunks][8];
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int c = tid + k * kThreads;
    if (c < nchunks) {
      uint4 raw[kMaxRanks];  // every slab's chunk, in summation order
#pragma unroll
      for (int i = 0; i < kMaxRanks; ++i) {
        // two_shot: the owner's own slab first, then the others in order
        const int s = kTwoShot ? (i == 0 ? rank : (i <= rank ? i - 1 : i)) : i;
        if (i < ws) raw[i] = load16(t.x[s] + off + c * 8);
      }
      const uint4 rraw = load16(res + c * 8);
#pragma unroll
      for (int i = 0; i < kMaxRanks; ++i) {
        if (i < ws) {
          float f[8];
          unpack8(raw[i], f);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[k][j] = (kTwoShot && i == 0) ? f[j] : __fadd_rn(i == 0 ? 0.f : acc[k][j], f[j]);
        }
      }
      float f[8];
      unpack8(rraw, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = __fadd_rn(acc[k][j], f[j]);
    }
  }
  // this thread's sum of squares, chunk by chunk in column order
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    if (tid + k * kThreads < nchunks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(acc[k][j], acc[k][j]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (lane == 0) warp_s[warp] = ss;
  __syncthreads();
  const float total = __fadd_rn(__fadd_rn(warp_s[0], warp_s[2]), __fadd_rn(warp_s[1], warp_s[3]));
  __syncthreads();  // warp_s is reused by the next row
  const float mean = __fdiv_rn(total, static_cast<float>(h));
  const float rms = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(mean, eps)));
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int c = tid + k * kThreads;
    if (c < nchunks) {
      const float4 w0 = w_s[2 * c], w1 = w_s[2 * c + 1];
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = kBf16Norm ? __fmul_rn(bf16_round(__fmul_rn(acc[k][j], rms)), bf16_round(wv[j]))
                         : __fmul_rn(__fmul_rn(acc[k][j], rms), wv[j]);
      }
      for (int d = 0; d < ws; ++d) {
        store8(t.out[d] + off + c * 8, o);
        store8(t.out_res[d] + off + c * 8, acc[k]);
      }
    }
  }
}

template <bool kTwoShot, bool kBf16Norm>
__global__ void __launch_bounds__(kThreads) allreduce_rmsnorm_kernel(RankTable t, Signals sig,
                                                                     int ws, int n, int h,
                                                                     float eps, int skew) {
  const int rank = blockIdx.y;
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid == 0) {
    for (long long i = 0; i < static_cast<long long>(rank) * skew; ++i) __nanosleep(100);
    add_release(sig.ready + rank, 1);
  }
  // one_shot: the group's blocks share all rows; two_shot: rank r's blocks
  // share its chunk
  const int first = kTwoShot ? blockIdx.x : rank * gridDim.x + blockIdx.x;
  const int stride = kTwoShot ? gridDim.x : gridDim.x * gridDim.y;
  const int rows = kTwoShot ? n / ws : n;
  const int row0 = kTwoShot ? rank * rows : 0;
  extern __shared__ float4 w_s[];  // the norm weight [h / 4], staged while the flags are polled
  __shared__ float warp_s[kWarps];
  __shared__ unsigned long long done_target_s;  // two_shot, block 0: every rank's done count to wait for
  unsigned long long done_now = 0;  // two_shot, thread 0 of block 0: in flight with the flags' loads
  if (first < rows) {
    const float4* w = reinterpret_cast<const float4*>(t.w[rank]);
    for (int i = tid; i < h / 4; i += kThreads) w_s[i] = w[i];
    if (kTwoShot && blockIdx.x == 0 && tid == 0) done_now = load_relaxed(sig.done + rank);
    wait_flags(sig.ready, ws, sig.epoch);  // its __syncthreads publishes w_s
  }
  // The block has read the epoch (every lane used its value before the
  // barrier above): it adds its share of the launch's quantum, block (0, 0)
  // the quantum less one for every other block. done[rank] cannot reach
  // the next quantum before block 0's own count at its end.
  if (tid == 0) {
    const unsigned long long blocks = static_cast<unsigned long long>(gridDim.x) * gridDim.y;
    if (kTwoShot && blockIdx.x == 0) done_target_s = (done_now / kQuantum + 1) * kQuantum;
    atomicAdd(sig.epoch, blockIdx.x == 0 && blockIdx.y == 0 ? kQuantum - (blocks - 1) : 1ull);
  }

  for (int rr = first; rr < rows; rr += stride)
    reduce_row<kTwoShot, kBf16Norm>(t, rank, ws, row0 + rr, h, eps, w_s, warp_s);
  if (kTwoShot) {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      add_release(sig.done + rank, blockIdx.x == 0 ? kQuantum - (gridDim.x - 1) : 1ull);
    }
    if (blockIdx.x == 0 && tid < ws) spin_until(sig.done + tid, done_target_s);
  }
}

// The per-device form: one launch a rank, on the rank's own stream, after
// the rank's stream waited on every rank's arrival event (the host orders
// the launches; no block waits on another launch). Rank r reduces one_shot
// rows r, r + ws, r + 2 ws, ... (the rows of its blocks out of all ranks'
// blocks), two_shot its own chunk [r*C, (r+1)*C); each row as reduce_row
// does it, so the outputs are bitwise those of the one-launch form.
template <bool kTwoShot, bool kBf16Norm>
__global__ void __launch_bounds__(kThreads) allreduce_rmsnorm_rank_kernel(RankTable t, int ws,
                                                                          int rank, int n, int h,
                                                                          float eps, int skew) {
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid == 0)
    for (long long i = 0; i < static_cast<long long>(rank) * skew; ++i) __nanosleep(100);
  extern __shared__ float4 w_s[];  // the norm weight [h / 4]
  __shared__ float warp_s[kWarps];
  const float4* w = reinterpret_cast<const float4*>(t.w[rank]);
  for (int i = tid; i < h / 4; i += kThreads) w_s[i] = w[i];
  __syncthreads();
  const int rows = kTwoShot ? n / ws : (n - rank + ws - 1) / ws;
  for (int j = blockIdx.x; j < rows; j += gridDim.x)
    reduce_row<kTwoShot, kBf16Norm>(t, rank, ws, kTwoShot ? rank * rows + j : rank + j * ws, h, eps,
                                    w_s, warp_s);
}

template <bool kTwoShot, bool kBf16Norm>
int launch_rank(const RankTable& t, int ws, int rank, int n, int h, float eps, int skew,
                cudaStream_t stream) {
  auto kernel = allreduce_rmsnorm_rank_kernel<kTwoShot, kBf16Norm>;
  const int rows = kTwoShot ? n / ws : (n - rank + ws - 1) / ws;
  if (rows <= 0) return 0;
  int per_sm = 0, dev = 0, sms = 0;
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wave = per_sm * sms > 0 ? per_sm * sms : 1;  // one row a block, at most one wave
  allreduce_rmsnorm_rank_kernel<kTwoShot, kBf16Norm>
      <<<rows < wave ? rows : wave, kThreads, smem, stream>>>(t, ws, rank, n, h, eps, skew);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTwoShot, bool kBf16Norm>
int launch(const RankTable& t, Signals sig, int ws, int n, int h, float eps, int skew,
           cudaStream_t stream) {
  auto kernel = allreduce_rmsnorm_kernel<kTwoShot, kBf16Norm>;
  int per_sm = 0, dev = 0, sms = 0;
  const size_t smem = static_cast<size_t>(h) * sizeof(float);  // the staged weight
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_rank = per_sm * sms / ws;  // blocks a rank may have with every rank resident
  if (per_rank < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // blocks a rank: two_shot one a row of its chunk, one_shot one a row of its share
  const int rows = kTwoShot ? n / ws : (n + ws - 1) / ws;
  const int nbx = rows < per_rank ? rows : per_rank;
  void* args[] = {const_cast<RankTable*>(&t), &sig, &ws, &n, &h, &eps, &skew};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(nbx, ws), dim3(kThreads), args, smem,
                                                      stream));
}

}  // namespace

static RankTable rank_table(const void* const* x, const void* const* res, const void* const* w,
                            void* const* out, void* const* out_res, int ws) {
  RankTable t{};
  for (int r = 0; r < ws; ++r) {
    t.x[r] = static_cast<const __nv_bfloat16*>(x[r]);
    t.res[r] = static_cast<const __nv_bfloat16*>(res[r]);
    t.w[r] = static_cast<const float*>(w[r]);
    t.out[r] = static_cast<__nv_bfloat16*>(out[r]);
    t.out_res[r] = static_cast<__nv_bfloat16*>(out_res[r]);
  }
  return t;
}

// x, res, out, out_res: host arrays of ws device pointers (each rank's [n, h]
// bf16 partial, residual and outputs); w: ws device pointers to [h] float32.
// signals: the group's pad, kPadWords uint64 on the device (ready counts,
// done counts, epoch), zero when first used and kept for the group: every
// launch reads its targets there and advances them, so the host keeps no
// count. n % ws == 0 for two_shot; h % 8 == 0, h <= 8192;
// 1 <= ws <= 8. Returns a cudaError_t code.
extern "C" int hpc_allreduce_rmsnorm(const void* const* x, const void* const* res,
                                     const void* const* w, void* const* out, void* const* out_res,
                                     void* signals, int ws, int n, int h, float eps, int two_shot,
                                     int bf16_norm, int skew, void* stream) {
  if (ws < 1 || ws > kMaxRanks || h % 8 != 0 || h <= 0 || h > kMaxChunks * 8 * kThreads ||
      (two_shot && n % ws != 0) || skew < 0 || signals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const RankTable t = rank_table(x, res, w, out, out_res, ws);
  unsigned long long* pad = static_cast<unsigned long long*>(signals);
  const Signals sig{pad, pad + kMaxRanks, pad + 2 * kMaxRanks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_shot)
    return bf16_norm ? launch<true, true>(t, sig, ws, n, h, eps, skew, s)
                     : launch<true, false>(t, sig, ws, n, h, eps, skew, s);
  return bf16_norm ? launch<false, true>(t, sig, ws, n, h, eps, skew, s)
                   : launch<false, false>(t, sig, ws, n, h, eps, skew, s);
}

// The per-device form: launches rank ``rank``'s blocks on ``stream`` (a
// stream of the current device, the rank's). The rank table as for
// hpc_allreduce_rmsnorm; a peer's pointers may lie on another device whose
// memory this device maps (hpc_enable_peer_access). The caller orders the
// launches: each rank's stream waits on every rank's arrival before its
// launch, and on every launch before it reuses a partial or reads its
// outputs. A rank with no rows (one_shot, n < ws) launches nothing. Returns
// a cudaError_t code.
extern "C" int hpc_allreduce_rmsnorm_rank(const void* const* x, const void* const* res,
                                          const void* const* w, void* const* out,
                                          void* const* out_res, int ws, int rank, int n, int h,
                                          float eps, int two_shot, int bf16_norm, int skew,
                                          void* stream) {
  if (ws < 1 || ws > kMaxRanks || rank < 0 || rank >= ws || h % 8 != 0 || h <= 0 ||
      h > kMaxChunks * 8 * kThreads || (two_shot && n % ws != 0) || skew < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const RankTable t = rank_table(x, res, w, out, out_res, ws);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_shot)
    return bf16_norm ? launch_rank<true, true>(t, ws, rank, n, h, eps, skew, s)
                     : launch_rank<true, false>(t, ws, rank, n, h, eps, skew, s);
  return bf16_norm ? launch_rank<false, true>(t, ws, rank, n, h, eps, skew, s)
                   : launch_rank<false, false>(t, ws, rank, n, h, eps, skew, s);
}

// Lets ``device`` read and write ``peer``'s memory (a mesh over distinct
// cards maps every pair once, when it is built). Access already enabled
// counts as success. Returns a cudaError_t code.
extern "C" int hpc_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not an error here: take it off the last-error slot
    e = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : back);
}

// Whether a memcpy node's pointer is host memory.
static bool on_host(const void* p) {
  if (p == nullptr) return false;
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();
    return true;  // not known to the runtime: pageable host memory
  }
  return a.type == cudaMemoryTypeHost || a.type == cudaMemoryTypeUnregistered;
}

// The nodes of a captured CUDA graph (a cudaGraph_t, before it is
// instantiated): counts[0] kernel nodes, counts[1] those of this file's
// kernel, counts[2] those of them that the capture marked cooperative,
// counts[3] memcpy nodes, counts[4] every node, counts[5] the memcpy nodes
// that read or write host memory, counts[6] the per-device form's kernel
// nodes (not cooperative: no block waits on another launch). Reads the
// graph only. Returns a
// cudaError_t code.
extern "C" int hpc_graph_node_counts(void* graph, int* counts) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t num = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &num);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNode_t* nodes = new cudaGraphNode_t[num > 0 ? num : 1];
  e = cudaGraphGetNodes(g, nodes, &num);
  const void* ours[] = {reinterpret_cast<const void*>(allreduce_rmsnorm_kernel<false, false>),
                        reinterpret_cast<const void*>(allreduce_rmsnorm_kernel<false, true>),
                        reinterpret_cast<const void*>(allreduce_rmsnorm_kernel<true, false>),
                        reinterpret_cast<const void*>(allreduce_rmsnorm_kernel<true, true>)};
  const void* per_rank[] = {
      reinterpret_cast<const void*>(allreduce_rmsnorm_rank_kernel<false, false>),
      reinterpret_cast<const void*>(allreduce_rmsnorm_rank_kernel<false, true>),
      reinterpret_cast<const void*>(allreduce_rmsnorm_rank_kernel<true, false>),
      reinterpret_cast<const void*>(allreduce_rmsnorm_rank_kernel<true, true>)};
  for (int i = 0; i < 7; ++i) counts[i] = 0;
  for (size_t i = 0; e == cudaSuccess && i < num; ++i) {
    ++counts[4];
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) break;
    if (type == cudaGraphNodeTypeMemcpy) {
      ++counts[3];
      cudaMemcpy3DParms m;
      e = cudaGraphMemcpyNodeGetParams(nodes[i], &m);
      if (e != cudaSuccess) break;
      if (m.kind == cudaMemcpyHostToDevice || m.kind == cudaMemcpyDeviceToHost ||
          m.kind == cudaMemcpyHostToHost || on_host(m.srcPtr.ptr) || on_host(m.dstPtr.ptr))
        ++counts[5];
    }
    if (type != cudaGraphNodeTypeKernel) continue;
    ++counts[0];
    cudaKernelNodeParams p;
    if (cudaGraphKernelNodeGetParams(nodes[i], &p) != cudaSuccess) {
      cudaGetLastError();  // a node launched through cuLaunchKernel (a library's kernel): not ours
      continue;
    }
    bool mine = false, rank_form = false;
    for (const void* f : ours) mine = mine || p.func == f;
    for (const void* f : per_rank) rank_form = rank_form || p.func == f;
    if (rank_form) ++counts[6];
    if (!mine) continue;
    ++counts[1];
    cudaLaunchAttributeValue v;
    e = cudaGraphKernelNodeGetAttribute(nodes[i], cudaLaunchAttributeCooperative, &v);
    if (e != cudaSuccess) break;
    if (v.cooperative) ++counts[2];
  }
  delete[] nodes;
  return static_cast<int>(e);
}
