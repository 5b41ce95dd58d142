// K8 groupn_tree: GroupBy's combination counts, every combination in one
// launch.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:707 groupn_tree:
// for n group fields (1 <= n <= kMaxFields), each a field stack
// int32[R_i, S, W] with K_i listed rows, and an optional filter tree,
//   out[k_1, ..., k_n] = sum over requested shards of
//       popcount(filter & row_1[k_1] & ... & row_n[k_n])
// as uint64[K_1 * ... * K_n], row-major, at most kMaxCombos combinations.
// A listed row of -1 (a row the stack lacks) reads as zeros.
//
// Bound: device-memory bytes.  Each listed row of each requested shard is
// read from device memory once, plus the filter's leaf rows (config 5's
// 8-way GroupBy, 4 x 2 rows over 960 shards: 6 x 960 x 128 KiB = 0.755 GB,
// about 0.225 ms at 3.35 TB/s).  The work per word is an AND and a
// popcount per combination, below the card's integer rate up to a few
// hundred combinations.
//
// Design.  The XLA version learned that each field row must stream from
// device memory once, not once per combination (kernels.py:718-723).  Here
// a CTA takes a tile of one shard's words (grid: tiles, shards; a CTA of an
// unrequested shard returns before it reads anything), and each thread
// holds U positions (16-byte vectors, neighbouring threads on neighbouring
// addresses).  It evaluates the filter once per position (tree_eval.cuh:
// the chain form in registers, else the interpreter; range leaves only in
// the kRanges build), then walks the combinations depth first with one
// running AND per level held in registers (the levels are a template
// recursion, so a prefix is shared by every combination under it).  A
// row of a deeper level is read again for each prefix above it, from L1
// or L2, never again from device memory in the same pass.  At the last
// level each combination's popcount is summed over the warp (redux.sync)
// and lane 0 adds it to the warp's counter row in shared memory,
// uint32[warps][C].  At the end the CTA sums its warps' rows and adds each
// nonzero combination to the output with one 64-bit atomic.  The listed
// row indices come from a device table the CTA copies into shared memory.
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFields = 8;
constexpr int kMaxCombos = 1024;

// The group fields: each stack's row 0, its listed-row count, and where its
// list starts in the row table.
struct Fields {
  const uint4* base[kMaxFields];
  int k[kMaxFields];
  int start[kMaxFields];
};

// Level L of the walk: AND each listed row of field L into `prev` and
// recurse, or at the last level count.  `c` is the row-major combination
// index, the same in every thread of the CTA.
template <int L, int N, int U>
__device__ __forceinline__ void walk(const uint4 (&prev)[U], const Fields& f,
                                     const int* table, size_t row_stride,
                                     const size_t (&off)[U], int& c,
                                     unsigned int* counts, int lane) {
  const int* rows = table + f.start[L];
  for (int k = 0; k < f.k[L]; ++k) {
    const int r = rows[k];
    uint4 cur[U];
    if (r < 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      const uint4* row = f.base[L] + (size_t)r * row_stride;
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = and4(prev[u], __ldg(row + off[u]));
    }
    if constexpr (L == N - 1) {
      unsigned int v = 0u;
#pragma unroll
      for (int u = 0; u < U; ++u) v += popc4(cur[u]);
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0) counts[c] += v;
      ++c;
    } else {
      walk<L + 1, N, U>(cur, f, table, row_stride, off, c, counts, lane);
    }
  }
}

// kFilter: 0 none (every column), 1 a chain program, 2 any other tree.
template <int N, int kFilter, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    groupn_tree_kernel(TreeProg prog, Leaves leaves, Fields f,
                       const int* __restrict__ idx, int n_idx, int n_combos,
                       const int* __restrict__ mask, int w4,
                       unsigned long long* __restrict__ out) {
  // Positions per thread and pass: fewer at depth, where every level
  // holds U vectors in registers.
  constexpr int U = N <= 4 ? 4 : 2;
  const int s = blockIdx.y;
  if (mask[s] == 0) return;  // unrequested shard: no reads at all
  extern __shared__ unsigned int smem[];
  int* table = (int*)smem;
  unsigned int* warp_counts = smem + n_idx;  // [kWarps][n_combos]
  for (int i = threadIdx.x; i < n_idx; i += kThreads) table[i] = idx[i];
  for (int i = threadIdx.x; i < kWarps * n_combos; i += kThreads) warp_counts[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned int* counts = warp_counts + (threadIdx.x >> 5) * n_combos;
  const size_t row_stride = (size_t)gridDim.y * (size_t)w4;
  const size_t shard_off = (size_t)s * (size_t)w4;
  constexpr int kPass = kThreads * U;
  // Every thread of the CTA runs the same passes (positions past the row
  // read a valid word and count nothing), so each warp reduces with all
  // of its lanes.
  for (int base = blockIdx.x * kPass; base < w4; base += gridDim.x * kPass) {
    size_t off[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * kThreads + threadIdx.x;
      ok[u] = j < w4;
      off[u] = shard_off + (ok[u] ? j : base);
    }
    uint4 acc[U];
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
    int c = 0;
    walk<0, N, U>(acc, f, table, row_stride, off, c, counts, lane);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_combos; c += kThreads) {
    unsigned long long sum = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_counts[w * n_combos + c];
    if (sum) atomicAdd(out + c, sum);
  }
}

template <int N>
void launch(int filter, bool ranges, dim3 grid, size_t smem, const TreeProg& prog,
            const Leaves& leaves, const Fields& f, const int* idx, int n_idx,
            int n_combos, const int* mask, int w4, unsigned long long* out,
            cudaStream_t st) {
  auto kernel = filter == 0   ? groupn_tree_kernel<N, 0, false>
                : filter == 1 ? (ranges ? groupn_tree_kernel<N, 1, true>
                                        : groupn_tree_kernel<N, 1, false>)
                              : (ranges ? groupn_tree_kernel<N, 2, true>
                                        : groupn_tree_kernel<N, 2, false>);
  kernel<<<grid, kThreads, smem, st>>>(prog, leaves, f, idx, n_idx, n_combos, mask,
                                       w4, out);
}

}  // namespace

// leaf_ptrs, ranges, range_rows, ops: the filter tree as in
// count_tree_dense, or n_ops = 0 for no filter (every column).
// field_ptrs: host array of n_fields device pointers, each a group field's
// stack int32[R_i, S, W] (contiguous, the same S and W).  field_k: host
// array of the K_i.  idx: device int32[sum K_i], the listed stack rows of
// every field in field order, each in [-1, R_i) (the caller checks the
// bounds).  mask: device int32[S].  out: device uint64[prod K_i], zeroed by
// the caller.  Returns the cudaError_t of the launch.
extern "C" int groupn_tree(const void* const* leaf_ptrs, int n_leaves,
                           const void* ranges, const int* range_rows, int n_ranges,
                           const int* ops, int n_ops, const void* const* field_ptrs,
                           const int* field_k, int n_fields, const void* idx,
                           const void* mask, int n_shards, int words, void* out,
                           void* stream) {
  TreeProg prog = {};
  Leaves leaves = {};
  const bool filter = n_ops > 0;
  if (filter && !pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops,
                           n_ops, &prog, &leaves))
    return (int)cudaErrorInvalidValue;
  if (n_fields < 1 || n_fields > kMaxFields || field_ptrs == nullptr ||
      field_k == nullptr || idx == nullptr || out == nullptr || words <= 0 ||
      words % 4 != 0 || n_shards < 0 || n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  Fields f = {};
  int n_idx = 0, n_combos = 1;
  for (int i = 0; i < n_fields; ++i) {
    if (field_k[i] < 1 || field_ptrs[i] == nullptr) return (int)cudaErrorInvalidValue;
    f.base[i] = (const uint4*)field_ptrs[i];
    f.k[i] = field_k[i];
    f.start[i] = n_idx;
    n_idx += field_k[i];
    n_combos *= field_k[i];
    if (n_combos > kMaxCombos) return (int)cudaErrorInvalidValue;
  }
  if (n_shards == 0) return (int)cudaSuccess;
  const int w4 = words / 4;
  const int u = n_fields <= 4 ? 4 : 2;
  const int tiles = (w4 + kThreads * u - 1) / (kThreads * u);
  // About eight CTAs per SM, or one per tile where a shard has fewer.
  int per_shard = (n_sms() * 8 + n_shards - 1) / n_shards;
  if (per_shard > tiles) per_shard = tiles;
  if (per_shard < 1) per_shard = 1;
  const dim3 grid(per_shard, n_shards);
  const size_t smem = (size_t)(n_idx + kWarps * n_combos) * sizeof(unsigned int);
  const int kind = !filter ? 0 : is_chain(ops, n_ops) ? 1 : 2;
  const bool rg = n_ranges > 0;
  const int* ix = (const int*)idx;
  const int* m = (const int*)mask;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_fields) {
    case 1: launch<1>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
    case 2: launch<2>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
    case 3: launch<3>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
    case 4: launch<4>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
    case 5: launch<5>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
    case 6: launch<6>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
    case 7: launch<7>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
    default: launch<8>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st); break;
  }
  return (int)cudaGetLastError();
}
