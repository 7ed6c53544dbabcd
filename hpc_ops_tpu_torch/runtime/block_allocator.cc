// Native paged-KV block allocator: the host-side memory manager of the
// serving runtime (the piece vLLM/SGLang supply around the reference's
// operator library — a complete framework carries its own).
//
// Manages the physical pages of a paged KV cache:
//   * per-sequence page tables grown one block at a time,
//   * reference-counted blocks so forked sequences (beam search, n-best
//     sampling, shared prefixes) share physical pages copy-on-write,
//   * O(1) alloc/free via a free-list stack.
//
// C ABI over an opaque handle; loaded via ctypes (no pybind dependency —
// see hpc_ops_tpu_torch/runtime/__init__.py, which compiles this file with
// g++ into build/runtime/ at first use).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Allocator {
  int32_t num_blocks = 0;
  int32_t block_size = 0;
  std::vector<int32_t> free_list;            // stack of free physical blocks
  std::vector<int32_t> refcount;             // per physical block
  std::unordered_map<int64_t, std::vector<int32_t>> tables;  // seq -> blocks
  std::unordered_map<int64_t, int64_t> lengths;              // seq -> tokens
};

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

void* hpc_kv_allocator_create(int32_t num_blocks, int32_t block_size) {
  auto* a = new Allocator();
  a->num_blocks = num_blocks;
  a->block_size = block_size;
  a->refcount.assign(num_blocks, 0);
  a->free_list.reserve(num_blocks);
  // pop order: ascending physical ids
  for (int32_t i = num_blocks - 1; i >= 0; --i) a->free_list.push_back(i);
  return a;
}

void hpc_kv_allocator_destroy(void* h) { delete static_cast<Allocator*>(h); }

int32_t hpc_kv_num_free(void* h) {
  return static_cast<int32_t>(static_cast<Allocator*>(h)->free_list.size());
}

// Grows (or creates) sequence `seq` to `num_tokens`. Returns the new block
// count, or -1 if out of blocks (the sequence is left unchanged on failure).
int32_t hpc_kv_extend(void* h, int64_t seq, int64_t num_tokens) {
  auto* a = static_cast<Allocator*>(h);
  auto& tbl = a->tables[seq];
  const int64_t need = cdiv(num_tokens, a->block_size);
  const int64_t have = static_cast<int64_t>(tbl.size());
  if (need > have) {
    if (static_cast<int64_t>(a->free_list.size()) < need - have) {
      if (tbl.empty()) {
        a->tables.erase(seq);  // don't leave an empty table behind
      }
      return -1;
    }
    for (int64_t i = have; i < need; ++i) {
      int32_t blk = a->free_list.back();
      a->free_list.pop_back();
      a->refcount[blk] = 1;
      tbl.push_back(blk);
    }
  }
  a->lengths[seq] = num_tokens;
  return static_cast<int32_t>(tbl.size());
}

// Copies the sequence's page table into out (capacity `cap` entries).
// Returns the block count (may exceed cap — caller re-queries), -1 if the
// sequence is unknown.
int32_t hpc_kv_table(void* h, int64_t seq, int32_t* out, int32_t cap) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->tables.find(seq);
  if (it == a->tables.end()) return -1;
  const auto& tbl = it->second;
  const int32_t n = static_cast<int32_t>(tbl.size());
  if (out != nullptr && cap > 0) {
    std::memcpy(out, tbl.data(),
                sizeof(int32_t) * static_cast<size_t>(std::min(n, cap)));
  }
  return n;
}

int64_t hpc_kv_length(void* h, int64_t seq) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->lengths.find(seq);
  return it == a->lengths.end() ? -1 : it->second;
}

// Forks `child` from `parent`: the child shares every parent block
// (refcounted). Returns the shared block count, -1 on unknown parent or
// existing child.
int32_t hpc_kv_fork(void* h, int64_t parent, int64_t child) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->tables.find(parent);
  if (it == a->tables.end() || a->tables.count(child)) return -1;
  for (int32_t blk : it->second) a->refcount[blk]++;
  a->tables[child] = it->second;
  a->lengths[child] = a->lengths[parent];
  return static_cast<int32_t>(it->second.size());
}

// Shares the first `num_blocks` blocks of `parent` with a NEW sequence
// `child` (refcounted). Callers must only share FULLY-WRITTEN blocks: the
// child starts at num_blocks*block_size tokens and its own writes begin at
// the next (freshly allocated) block, so shared pages stay read-only and
// no copy-on-write is ever needed on this path (prefix caching). Returns
// the shared block count, -1 on unknown parent / existing child / range.
int32_t hpc_kv_share_prefix(void* h, int64_t parent, int64_t child,
                            int32_t num_blocks) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->tables.find(parent);
  if (it == a->tables.end() || a->tables.count(child)) return -1;
  if (num_blocks < 0 ||
      num_blocks > static_cast<int32_t>(it->second.size())) {
    return -1;
  }
  std::vector<int32_t> tbl(it->second.begin(),
                           it->second.begin() + num_blocks);
  for (int32_t blk : tbl) a->refcount[blk]++;
  a->tables[child] = std::move(tbl);
  a->lengths[child] = static_cast<int64_t>(num_blocks) * a->block_size;
  return num_blocks;
}

// Copy-on-write: ensure the LAST block of `seq` is exclusively owned
// (decode appends tokens in place there). Returns the physical id of the
// (possibly new) last block, -2 if a copy is needed but no block is free,
// -1 on unknown/empty sequence. When a copy happens, *copied_from is set to
// the old physical id so the caller can issue the device-side page copy;
// otherwise it is set to -1.
int32_t hpc_kv_cow_last(void* h, int64_t seq, int32_t* copied_from) {
  auto* a = static_cast<Allocator*>(h);
  *copied_from = -1;
  auto it = a->tables.find(seq);
  if (it == a->tables.end() || it->second.empty()) return -1;
  int32_t blk = it->second.back();
  if (a->refcount[blk] == 1) return blk;
  if (a->free_list.empty()) return -2;
  int32_t fresh = a->free_list.back();
  a->free_list.pop_back();
  a->refcount[fresh] = 1;
  a->refcount[blk]--;
  it->second.back() = fresh;
  *copied_from = blk;
  return fresh;
}

// Releases the sequence; refcounted blocks return to the free list when
// their last owner frees them. Returns freed block count, -1 if unknown.
int32_t hpc_kv_free(void* h, int64_t seq) {
  auto* a = static_cast<Allocator*>(h);
  auto it = a->tables.find(seq);
  if (it == a->tables.end()) return -1;
  int32_t freed = 0;
  for (int32_t blk : it->second) {
    if (--a->refcount[blk] == 0) {
      a->free_list.push_back(blk);
      ++freed;
    }
  }
  a->tables.erase(it);
  a->lengths.erase(seq);
  return freed;
}

}  // extern "C"
