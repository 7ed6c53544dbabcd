// Fused all-reduce + residual add + RMSNorm over the ranks of a
// tensor-parallel group: each rank r holds a partial x_r [n, h] bf16, its copy
// of the residual [n, h] bf16 and of the norm weight [h] float32, and gets
//   out_res = sum_s float32(x_s) + float32(residual)
//   out     = norm(out_res) * weight          (both [n, h] bf16)
// with every rank's outputs bitwise equal.
//
// Replaces: hpc_ops_tpu/parallel/collective_kernels.py:_one_shot_kernel
// (reached through fuse_allreduce_rmsnorm_pallas(mode="one_shot")) and
// _two_shot_kernel (mode="two_shot"); launcher hpc_allreduce_rmsnorm.
//
// Bound on the card: bytes (a few operations per element). Each partial is
// read once, the residual and weight once, and each rank's two outputs are
// written once; one_shot reads every partial once per rank (ws times in
// all), two_shot once.
//
// Design. The ranks of a group are virtual ranks on one device (one host
// thread each), and one cooperative launch serves all of them: blockIdx.y is
// the rank, and a rank table holds every rank's partial, residual, weight
// and outputs. A signal pad in device memory plays the TPU kernel's per-slot
// semaphores: block 0 of rank r raises ready[r] (after r * skew spins of
// about 100 ns: the TPU kernel's staggered-arrival test hook), and every
// block waits on ready[s] (ld.acquire.gpu, bounded by about 1 s of
// %globaltimer, then __trap) before it reads slab s, consuming the slabs in
// absolute rank order as their flags arrive. The counters only grow: a call
// waits for ready[s] to reach its epoch, so nothing is reset between calls.
// The slabs are the callers' partials, which the next call cannot overwrite
// while this one runs (the launch is stream-ordered after every rank's
// work, and every rank's stream waits on it). The grid is sized from the
// occupancy query so that all ranks' blocks are resident at once (an
// over-large cooperative grid is a launch error, not a deadlock); blocks
// loop over rows, one row per block of 128 threads, each thread holding up
// to 8 chunks of 8 columns in registers (h <= 8192).
//   * one_shot: every rank's blocks reduce every row, acc = 0 + x_0 + x_1 +
//     ... + x_{ws-1}, and write that rank's outputs.
//   * two_shot: rank r owns rows [r*C, (r+1)*C), C = n / ws: acc = x_r, then
//     + x_s for s != r in absolute order; it normalises its chunk and writes
//     both outputs of the chunk into every rank's outputs, then raises
//     done[r] (one count per block); block 0 of each rank waits until every
//     owner's count reaches this call's total, the all-gather's completion.
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

struct Signals {
  unsigned long long* ready;  // [kMaxRanks] slabs ready, one count per call
  unsigned long long* done;   // [kMaxRanks] two_shot chunks written, one count per block
  unsigned long long ready_target, done_target;
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

// Thread 0 waits until *flag >= target, then the block goes on. A flag that
// never comes traps after about 1 s: a CUDA error at the next sync, not a hang.
__device__ void wait_flag(const unsigned long long* flag, unsigned long long target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    while (load_acquire(flag) < target) {
      if (global_ns() - t0 > kWaitNs) __trap();
      __nanosleep(32);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
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
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kTwoShot, bool kBf16Norm>
__global__ void __launch_bounds__(kThreads) allreduce_rmsnorm_kernel(RankTable t, Signals sig,
                                                                     int ws, int n, int h,
                                                                     float eps, int skew) {
  const int rank = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) {
    for (long long i = 0; i < static_cast<long long>(rank) * skew; ++i) __nanosleep(100);
    add_release(sig.ready + rank, 1);
  }
  const int rows = kTwoShot ? n / ws : n;
  const int row0 = kTwoShot ? rank * rows : 0;
  const int nchunks = h / 8;
  const float* w = t.w[rank];
  __shared__ float warp_s[kWarps];
  unsigned seen = 0;  // slabs whose ready flag this block has seen

  for (int rr = blockIdx.x; rr < rows; rr += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row0 + rr) * h;
    float acc[kMaxChunks][8];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
    for (int i = 0; i < ws; ++i) {
      // two_shot: the owner's own slab first, then the others in order
      const int s = kTwoShot ? (i == 0 ? rank : (i <= rank ? i - 1 : i)) : i;
      if (!(seen & (1u << s))) {
        wait_flag(sig.ready + s, sig.ready_target);
        seen |= 1u << s;
      }
      const __nv_bfloat16* xs = t.x[s] + off;
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        const int c = tid + k * kThreads;
        if (c < nchunks) {
          float f[8];
          load8(xs + c * 8, f);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[k][j] = (kTwoShot && i == 0) ? f[j] : __fadd_rn(acc[k][j], f[j]);
        }
      }
    }
    // residual, then this thread's sum of squares
    float ss = 0.f;
    const __nv_bfloat16* res = t.res[rank] + off;
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int c = tid + k * kThreads;
      if (c < nchunks) {
        float f[8];
        load8(res + c * 8, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[k][j] = __fadd_rn(acc[k][j], f[j]);
          ss = __fadd_rn(ss, __fmul_rn(acc[k][j], acc[k][j]));
        }
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
        const float4 w0 = *reinterpret_cast<const float4*>(w + c * 8);
        const float4 w1 = *reinterpret_cast<const float4*>(w + c * 8 + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[j] = kBf16Norm ? __fmul_rn(bf16_round(__fmul_rn(acc[k][j], rms)), bf16_round(wv[j]))
                           : __fmul_rn(__fmul_rn(acc[k][j], rms), wv[j]);
        }
        if (kTwoShot) {
          for (int d = 0; d < ws; ++d) {
            store8(t.out[d] + off + c * 8, o);
            store8(t.out_res[d] + off + c * 8, acc[k]);
          }
        } else {
          store8(t.out[rank] + off + c * 8, o);
          store8(t.out_res[rank] + off + c * 8, acc[k]);
        }
      }
    }
  }
  if (kTwoShot) {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      add_release(sig.done + rank, 1);
    }
    if (blockIdx.x == 0)
      for (int s = 0; s < ws; ++s) wait_flag(sig.done + s, sig.done_target);
  }
}

template <bool kTwoShot, bool kBf16Norm>
int launch(const RankTable& t, Signals sig, unsigned long long* done_total, int ws, int n, int h,
           float eps, int skew, cudaStream_t stream) {
  auto kernel = allreduce_rmsnorm_kernel<kTwoShot, kBf16Norm>;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_rank = per_sm * sms / ws;  // blocks a rank may have with every rank resident
  if (per_rank < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int rows = kTwoShot ? n / ws : n;
  const int nbx = rows < per_rank ? rows : per_rank;
  sig.done_target = *done_total + static_cast<unsigned long long>(nbx);
  void* args[] = {const_cast<RankTable*>(&t), &sig, &ws, &n, &h, &eps, &skew};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(nbx, ws),
                                  dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (kTwoShot) *done_total = sig.done_target;
  return 0;
}

}  // namespace

// x, res, out, out_res: host arrays of ws device pointers (each rank's [n, h]
// bf16 partial, residual and outputs); w: ws device pointers to [h] float32.
// signals: [2 * 8] uint64 on the device, zero when first used and kept for
// the group (ready counts, then done counts). ready_target is this call's
// epoch (the number of calls made on the pad, this one included); done_total
// (host, in/out) is the running total of two_shot blocks per rank, advanced
// when the launch succeeds. n % ws == 0 for two_shot; h % 8 == 0, h <= 8192;
// 1 <= ws <= 8. Returns a cudaError_t code.
extern "C" int hpc_allreduce_rmsnorm(const void* const* x, const void* const* res,
                                     const void* const* w, void* const* out, void* const* out_res,
                                     void* signals, unsigned long long ready_target,
                                     unsigned long long* done_total, int ws, int n, int h,
                                     float eps, int two_shot, int bf16_norm, int skew,
                                     void* stream) {
  if (ws < 1 || ws > kMaxRanks || h % 8 != 0 || h <= 0 || h > kMaxChunks * 8 * kThreads ||
      (two_shot && n % ws != 0) || skew < 0 || signals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  RankTable t{};
  for (int r = 0; r < ws; ++r) {
    t.x[r] = static_cast<const __nv_bfloat16*>(x[r]);
    t.res[r] = static_cast<const __nv_bfloat16*>(res[r]);
    t.w[r] = static_cast<const float*>(w[r]);
    t.out[r] = static_cast<__nv_bfloat16*>(out[r]);
    t.out_res[r] = static_cast<__nv_bfloat16*>(out_res[r]);
  }
  unsigned long long* pad = static_cast<unsigned long long*>(signals);
  const Signals sig{pad, pad + kMaxRanks, ready_target, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_shot)
    return bf16_norm ? launch<true, true>(t, sig, done_total, ws, n, h, eps, skew, s)
                     : launch<true, false>(t, sig, done_total, ws, n, h, eps, skew, s);
  return bf16_norm ? launch<false, true>(t, sig, done_total, ws, n, h, eps, skew, s)
                   : launch<false, false>(t, sig, done_total, ws, n, h, eps, skew, s);
}
