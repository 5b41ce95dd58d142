// Shared by K8 (groupn_tree.cu) and K8P (groupn_tree_pool.cu): the
// launch constants, the group fields' table and its checks, the
// asynchronous 16-byte copy, the two walks of the combinations (the
// register form's and the staged walk's) and the filter at U positions.
// groupn_tree.cu's module comment describes them.  The kernels that call
// them are each source's own (groupn_tree_pool.cu says why).
#pragma once

#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFields = 8;
constexpr int kMaxCombos = 1024;
// The register form's capacities (module comment): kRegK0 rows on the
// first level, kRegK on each later one, up to kRegFields fields.
constexpr int kRegK0 = 4;
constexpr int kRegK = 2;
constexpr int kRegFields = 4;
// Positions per thread and pass.  The register form: 2 up to two fields,
// else 1.  The walk: 4 for one field (nothing is staged), else 1 (the
// stage holds 4 KiB of each deeper row).
__host__ __device__ constexpr int reg_u(int n) { return n <= 2 ? 2 : 1; }
__host__ __device__ constexpr int walk_u(int n) { return n == 1 ? 4 : 1; }
// The most dynamic shared memory a CTA may take (sm_90).
constexpr size_t kMaxSmem = 227 * 1024;

// The group fields, in level order: each stack's row 0, its listed-row
// count, where its list starts in the row table, and its stride in the
// row-major output.
struct Fields {
  const uint4* base[kMaxFields];
  int k[kMaxFields];
  int start[kMaxFields];
  int stride[kMaxFields];
};

// A 16-byte asynchronous copy from device memory into shared memory, and
// the wait for every copy this thread has issued (its writes are then
// visible to this thread).
__device__ __forceinline__ void copy16_async(uint4* dst, const uint4* src) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Level L of the walk: AND each listed row of field L into `prev` and
// recurse, or at the last level count.  Level 0's rows come from device
// memory at `off` (the next one loaded before the current one's subtree),
// a deeper level's from the stage, slot (its place in the row table less
// level 0's rows) * kPass + this thread's position.  `c` is the
// combination's place in the row-major output, the same in every thread
// of the CTA.
template <int L, int N, int U>
__device__ __forceinline__ void walk(const uint4 (&prev)[U], const Fields& f,
                                     const int* table, size_t row_stride,
                                     const size_t (&off)[U], const uint4* stage, int c,
                                     unsigned int* counts, int lane) {
  constexpr int kPass = kThreads * U;
  uint4 nxt[U];
  auto load0 = [&](int k) {
    const int r = table[k];
#pragma unroll
    for (int u = 0; u < U; ++u)
      nxt[u] = r < 0 ? make_uint4(0u, 0u, 0u, 0u)
                     : __ldg(f.base[0] + (size_t)r * row_stride + off[u]);
  };
  if constexpr (L == 0) load0(0);
  for (int k = 0; k < f.k[L]; ++k) {
    uint4 cur[U];
    if constexpr (L == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = and4(prev[u], nxt[u]);
      if (k + 1 < f.k[0]) load0(k + 1);
    } else {
      const uint4* row = stage + (size_t)(f.start[L] - f.k[0] + k) * kPass + threadIdx.x;
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = and4(prev[u], row[u * kThreads]);
    }
    const int ck = c + k * f.stride[L];
    if constexpr (L == N - 1) {
      unsigned int v = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) v += popc4(cur[u]);
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0) counts[ck] += v;
    } else {
      walk<L + 1, N, U>(cur, f, table, row_stride, off, stage, ck, counts, lane);
    }
  }
}

// The register form's walk: level L's listed rows are registers
// row[first(L) + k]; `v` is the combination's index in the capacity shape
// (kRegK0 x kRegK x ...), a constant once the walk is unrolled.
template <int L, int N, int U, int kRows, int kCombos>
__device__ __forceinline__ void reg_walk(const uint4 (&prev)[U],
                                         const uint4 (&row)[kRows][U], const Fields& f,
                                         int v, unsigned int (&cnt)[kCombos]) {
  constexpr int cap = L == 0 ? kRegK0 : kRegK;
  constexpr int first = L == 0 ? 0 : kRegK0 + (L - 1) * kRegK;
#pragma unroll
  for (int k = 0; k < cap; ++k) {
    if (k < f.k[L]) {
      uint4 cur[U];
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = and4(prev[u], row[first + k][u]);
      if constexpr (L == N - 1) {
        unsigned int x = 0u;
#pragma unroll
        for (int u = 0; u < U; ++u) x += popc4(cur[u]);
        cnt[v * cap + k] += x;
      } else {
        reg_walk<L + 1, N, U, kRows, kCombos>(cur, row, f, v * cap + k, cnt);
      }
    }
  }
}

// The filter at U positions of a pass (positions past the row count
// nothing).
template <int U, int kFilter, bool kRanges>
__device__ __forceinline__ void filter_words(const TreeProg& prog, const Leaves& leaves,
                                             const size_t (&off)[U], const bool (&ok)[U],
                                             uint4 (&acc)[U]) {
  if constexpr (kFilter == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = make_uint4(~0u, ~0u, ~0u, ~0u);
  } else if constexpr (kFilter == 1) {
    eval_chain<U, kRanges>(prog, leaves, off, acc);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = eval_tree<kRanges>(prog, leaves, off[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (!ok[u]) acc[u] = make_uint4(0u, 0u, 0u, 0u);
}

// The C entries' checks of the group fields (groupn_tree and
// groupn_tree_pool): each field's stack, listed-row count and output
// stride into f, the listed rows' total n_idx and the combinations
// n_combos, and the walk's shared memory at u positions a thread (0 for
// the register form).  False on a bad argument.
static inline bool pack_fields(const void* const* field_ptrs, const int* field_k,
                               const int* field_stride, int regs, int n_fields, int u,
                               Fields* f, int* n_idx, int* n_combos, size_t* smem) {
  if (n_fields < 1 || n_fields > kMaxFields || field_ptrs == nullptr || field_k == nullptr ||
      field_stride == nullptr || (regs && n_fields > kRegFields))
    return false;
  int last = 0;
  *n_idx = 0;
  *n_combos = 1;
  for (int i = 0; i < n_fields; ++i) {
    if (field_k[i] < 1 || field_ptrs[i] == nullptr || field_stride[i] < 1) return false;
    if (regs && field_k[i] > (i == 0 ? kRegK0 : kRegK)) return false;
    f->base[i] = (const uint4*)field_ptrs[i];
    f->k[i] = field_k[i];
    f->start[i] = *n_idx;
    f->stride[i] = field_stride[i];
    *n_idx += field_k[i];
    *n_combos *= field_k[i];
    if (*n_combos > kMaxCombos) return false;
    last += (field_k[i] - 1) * field_stride[i];
  }
  if (last != *n_combos - 1) return false;
  *smem = regs ? 0
               : (size_t)(*n_idx - f->k[0]) * kThreads * u * sizeof(uint4) +
                     (size_t)(*n_idx + kWarps * *n_combos) * sizeof(unsigned int);
  return *smem <= kMaxSmem;
}

}  // namespace
