// Native decode-task scheduler: flat-bin packing of (batch x kv_head) KV
// ranges into uniform work tiles, for the task-map decode
// (hpc_ops_tpu_torch/ops/attention/decode.py, task_map=...).
//
// The port's own copy of the JAX package's host scheduler. Its output is
// the contract of hpc_ops_tpu_torch/ops/attention/scheduler.py:
// assign_decode_tasks_np, element for element, and of the vectorised torch
// scheduler there; the tests assert that the three agree.
//
// C ABI, loaded with ctypes: hpc_ops_tpu_torch/runtime/__init__.py compiles
// this file with block_allocator.cc into one g++ library under
// build/runtime/ at first use.

#include <algorithm>
#include <cstdint>

namespace {

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Fills the flat task arrays; returns the task count (or -1 on capacity
// overflow). Entries past the count are left as provided (callers pre-fill
// batch with -1 sentinels).
int hpc_assign_decode_tasks(
    const int32_t* kv_lens, int batch, int num_head_kv, int capacity,
    int tile, int num_tasks_target, int min_process_len,
    int32_t* out_batch, int32_t* out_head, int32_t* out_tile_start,
    int32_t* out_num_tiles, int32_t* out_seg) {
  int64_t total = 0;
  for (int b = 0; b < batch; ++b) {
    total += std::max<int64_t>(cdiv(kv_lens[b], tile), 1);
  }
  total *= num_head_kv;

  const int64_t tpt = std::max<int64_t>(
      std::max<int64_t>(cdiv(total, std::max(num_tasks_target, 1)),
                        min_process_len / tile),
      1);

  int t = 0;
  for (int b = 0; b < batch; ++b) {
    const int64_t tiles = std::max<int64_t>(cdiv(kv_lens[b], tile), 1);
    for (int h = 0; h < num_head_kv; ++h) {
      for (int64_t start = 0; start < tiles; start += tpt) {
        if (t >= capacity) return -1;
        out_batch[t] = b;
        out_head[t] = h;
        out_tile_start[t] = static_cast<int32_t>(start);
        out_num_tiles[t] = static_cast<int32_t>(std::min(tpt, tiles - start));
        out_seg[t] = b * num_head_kv + h;
        ++t;
      }
    }
  }
  return t;
}

}  // extern "C"
