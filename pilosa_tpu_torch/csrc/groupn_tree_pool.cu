// K8P groupn_tree_pool: K8's GroupBy counts (groupn_tree.cu) for a filter
// tree with pool leaves, a GroupBy over a segment whose rows are only
// partly resident (a block pool, tree_eval.cuh load_pool).  The filter can
// be non-zero only in the blocks of its live word, the same for every
// shard (tree_eval.cuh block_live), so no combination counts a column
// outside it.
//
// Bound: device-memory bytes, the filter's leaves and every listed row
// read at the live blocks only: (2 + 4) rows x 8 live blocks x 960 shards
// x 2 KiB = 94 MB, 0.028 ms at 3.35 TB/s, for GroupBy(Rows(rt),
// filter=Intersect(Row(wf0=0), Row(wf0=1))) over the residency sweep,
// where K8 reads rt's 4 rows whole.
//
// Design.  The output is global with one atomic per combination already,
// so the grid flattens as K6P's does: one list of (shard, live position)
// items, shard-major, and as many CTAs as the card holds at once striding
// over it, each listing the live blocks in shared memory once
// (tree_eval.cuh live_block_list).  Both of K8's forms stay, over those
// items (groupn_tree.cuh): the register form (U items a thread, every
// listed row's words loaded together) and the walk (one item a thread a
// pass, the deeper levels' rows staged with cp.async, each thread reading
// only what it copied).  An item of an unrequested shard reads nothing: a
// thread (the register form) or a warp (the walk, whose 32 items share a
// shard) skips it, and a lane left over reads its neighbour's words again.
// A live word of 0 reads nothing and adds nothing.  Kernels of its own,
// in a source of its own: beside K8 in one file, K8P moved the SASS of
// K8's walk at four fields and more, though no line of K8 changed; and K8
// instantiated from bodies shared with K8P (chosen by `if constexpr`)
// compiled every walk function and two register-form ones differently,
// with the dense text unchanged (PERF.md).
#include "groupn_tree.cuh"

namespace {

// The filter at U positions (groupn_tree.cuh filter_words) with the pool
// leaf compiled in: K8P's filters always hold one.  kFilter: 1 a chain
// program, 2 any other tree.
template <int U, int kFilter, bool kRanges>
__device__ __forceinline__ void pool_filter_words(const TreeProg& prog, const Leaves& leaves,
                                                  const size_t (&off)[U], const bool (&ok)[U],
                                                  uint4 (&acc)[U]) {
  if constexpr (kFilter == 1) {
    eval_chain<U, kRanges, true>(prog, leaves, off, acc);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = eval_tree<kRanges, true>(prog, leaves, off[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (!ok[u]) acc[u] = make_uint4(0u, 0u, 0u, 0u);
}

// K8P's register form (module comment): items (shard, live position),
// U a thread a pass, every listed row's words at them loaded together.
template <int N, int kFilter, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    groupn_tree_pool_kernel_regs(TreeProg prog, Leaves leaves, Fields f,
                                 const int* __restrict__ idx, const int* __restrict__ mask,
                                 int n_shards, unsigned long long* __restrict__ out) {
  constexpr int U = reg_u(N);
  constexpr int kRows = kRegK0 + (N - 1) * kRegK;
  constexpr int kCombos = kRegK0 << (N - 1);  // kRegK = 2
  __shared__ LiveBlocks live;
  __shared__ unsigned int part[kWarps][kCombos];
  const int n_pos = live_block_list(prog, leaves, live) * kPoolBlockVec;
  if (n_pos == 0) return;  // uniform over the block: nothing live
  const size_t row_stride = (size_t)n_shards * kPoolRowVec;
  // Each slot's row (every shard), or null (a row of -1, an unused slot).
  const uint4* rp[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int L = q < kRegK0 ? 0 : 1 + (q - kRegK0) / kRegK;
    const int k = q < kRegK0 ? q : (q - kRegK0) % kRegK;
    const int r = k < f.k[L] ? __ldg(idx + f.start[L] + k) : -1;
    rp[q] = r < 0 ? nullptr : f.base[L] + (size_t)r * row_stride;
  }
  unsigned int cnt[kCombos];
#pragma unroll
  for (int v = 0; v < kCombos; ++v) cnt[v] = 0u;
  constexpr int kPass = kThreads * U;
  const int n_items = n_pos * n_shards;
  // Each pass's items are requested or not by the mask, read a pass ahead
  // so that its latency never sits before the rows' loads.
  bool ok_next[U];
  auto requested = [&](int base, bool (&ok)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      ok[u] = i < n_items && __ldg(mask + i / n_pos) != 0;
    }
  };
  requested(blockIdx.x * kPass, ok_next);
  for (int base = blockIdx.x * kPass; base < n_items; base += gridDim.x * kPass) {
    size_t off[U];
    bool ok[U];
    int first = -1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      const int s = i / n_pos, j = i - s * n_pos;
      ok[u] = ok_next[u];
      off[u] = (size_t)s * kPoolRowVec + live.block[j / kPoolBlockVec] * kPoolBlockVec +
               j % kPoolBlockVec;
      if (ok[u] && first < 0) first = u;
    }
    requested(base + gridDim.x * kPass, ok_next);
    if (first < 0) continue;  // nothing requested: no reads
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (!ok[u]) off[u] = off[first];  // read again, counted nowhere
    uint4 row[kRows][U];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int u = 0; u < U; ++u)
        row[q][u] = rp[q] != nullptr ? __ldg(rp[q] + off[u]) : make_uint4(0u, 0u, 0u, 0u);
    uint4 acc[U];
    pool_filter_words<U, kFilter, kRanges>(prog, leaves, off, ok, acc);
    reg_walk<0, N, U, kRows, kCombos>(acc, row, f, 0, cnt);
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < kCombos; ++v) {
    const unsigned int x = __reduce_add_sync(0xffffffffu, cnt[v]);
    if (lane == 0) part[threadIdx.x >> 5][v] = x;
  }
  __syncthreads();
  const int v = threadIdx.x;
  if (v < kCombos) {
    // v's digits, last level lowest: its place in the row-major output.
    int c = 0, rest = v;
    bool listed = true;
#pragma unroll
    for (int L = N - 1; L >= 0; --L) {
      const int cap = L == 0 ? kRegK0 : kRegK;
      const int k = rest % cap;
      rest /= cap;
      listed = listed && k < f.k[L];
      c += k * f.stride[L];
    }
    unsigned long long sum = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][v];
    if (listed && sum) atomicAdd(out + c, sum);
  }
}

// K8P's walk (module comment): items (shard, live position), one a thread
// a pass; a warp's 32 items lie in one shard (n_pos is a multiple of 128),
// so a warp skips an unrequested shard's items together and its
// reductions keep every lane.
template <int N, int kFilter, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    groupn_tree_pool_kernel(TreeProg prog, Leaves leaves, Fields f,
                            const int* __restrict__ idx, int n_idx, int n_combos,
                            const int* __restrict__ mask, int n_shards,
                            unsigned long long* __restrict__ out) {
  constexpr int kPass = kThreads;
  __shared__ LiveBlocks live;
  const int n_pos = live_block_list(prog, leaves, live) * kPoolBlockVec;
  if (n_pos == 0) return;  // uniform over the block: nothing live
  extern __shared__ uint4 smem[];
  const int n_stage = n_idx - f.k[0];
  uint4* stage = smem;
  int* table = (int*)(stage + (size_t)n_stage * kPass);
  unsigned int* warp_counts = (unsigned int*)(table + n_idx);
  for (int i = threadIdx.x; i < n_idx; i += kThreads) table[i] = idx[i];
  for (int i = threadIdx.x; i < kWarps * n_combos; i += kThreads) warp_counts[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned int* counts = warp_counts + (threadIdx.x >> 5) * n_combos;
  const size_t row_stride = (size_t)n_shards * kPoolRowVec;
  for (int q = 0; q < n_stage; ++q)
    if (table[f.k[0] + q] < 0) stage[(size_t)q * kPass + threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  const int n_items = n_pos * n_shards;
  for (int base = blockIdx.x * kPass; base < n_items; base += gridDim.x * kPass) {
    const int i = base + threadIdx.x;
    const int s = i / n_pos, j = i - s * n_pos;
    const bool ok[1] = {i < n_items && mask[s] != 0};
    if (!__any_sync(0xffffffffu, ok[0])) continue;  // nothing requested: no reads
    size_t off[1] = {(size_t)s * kPoolRowVec + live.block[j / kPoolBlockVec] * kPoolBlockVec +
                     j % kPoolBlockVec};
    // Lane 0 holds the warp's first item, requested when any is.
    const unsigned long long off0 = __shfl_sync(0xffffffffu, (unsigned long long)off[0], 0);
    if (!ok[0]) off[0] = off0;  // read again, counted nowhere
#pragma unroll
    for (int L = 1; L < N; ++L)
      for (int k = 0; k < f.k[L]; ++k) {
        const int r = table[f.start[L] + k];
        if (r < 0) continue;
        copy16_async(stage + (size_t)(f.start[L] - f.k[0] + k) * kPass + threadIdx.x,
                     f.base[L] + (size_t)r * row_stride + off[0]);
      }
    uint4 acc[1];
    pool_filter_words<1, kFilter, kRanges>(prog, leaves, off, ok, acc);
    if constexpr (N > 1) copies_wait();
    walk<0, N, 1>(acc, f, table, row_stride, off, stage, 0, counts, lane);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_combos; c += kThreads) {
    unsigned long long sum = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_counts[w * n_combos + c];
    if (sum) atomicAdd(out + c, sum);
  }
}

// K8P's grid: as many CTAs as the card holds at once (the variant's
// registers and shared memory decide how many an SM takes; the query is
// cached per variant at its last shared-memory size in fit and fit_smem),
// at most enough for every block live, a pass of kThreads * u items each.
template <class Kernel>
int pool_ctas(Kernel kernel, size_t smem, int u, int n_shards, int& fit, size_t& fit_smem) {
  if (smem != fit_smem) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) !=
            cudaSuccess ||
        n <= 0)
      n = 1;
    fit = n;
    fit_smem = smem;
  }
  const long long most = ((long long)kPoolRowVec * n_shards + kThreads * u - 1) / (kThreads * u);
  return (int)(most < (long long)fit * n_sms() ? most : (long long)fit * n_sms());
}

template <int N>
void launch_pool_reg(int filter, bool ranges, const TreeProg& prog, const Leaves& leaves,
                     const Fields& f, const int* idx, const int* mask, int n_shards,
                     unsigned long long* out, cudaStream_t st) {
  auto kernel = filter == 1 ? (ranges ? groupn_tree_pool_kernel_regs<N, 1, true>
                                      : groupn_tree_pool_kernel_regs<N, 1, false>)
                            : (ranges ? groupn_tree_pool_kernel_regs<N, 2, true>
                                      : groupn_tree_pool_kernel_regs<N, 2, false>);
  static int fit[4];
  static size_t fit_smem[4] = {~(size_t)0, ~(size_t)0, ~(size_t)0, ~(size_t)0};
  const int variant = 2 * (filter - 1) + (ranges ? 1 : 0);
  const int ctas = pool_ctas(kernel, 0, reg_u(N), n_shards, fit[variant], fit_smem[variant]);
  kernel<<<ctas, kThreads, 0, st>>>(prog, leaves, f, idx, mask, n_shards, out);
}

template <int N>
int launch_pool(int filter, bool ranges, size_t smem, const TreeProg& prog,
                const Leaves& leaves, const Fields& f, const int* idx, int n_idx,
                int n_combos, const int* mask, int n_shards, unsigned long long* out,
                cudaStream_t st) {
  auto kernel = filter == 1 ? (ranges ? groupn_tree_pool_kernel<N, 1, true>
                                      : groupn_tree_pool_kernel<N, 1, false>)
                            : (ranges ? groupn_tree_pool_kernel<N, 2, true>
                                      : groupn_tree_pool_kernel<N, 2, false>);
  // Past the default 48 KiB each variant is allowed more once, as needed.
  static size_t allowed[4] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  const int variant = 2 * (filter - 1) + (ranges ? 1 : 0);
  if (smem > allowed[variant]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[variant] = smem;
  }
  static int fit[4];
  static size_t fit_smem[4] = {~(size_t)0, ~(size_t)0, ~(size_t)0, ~(size_t)0};
  const int ctas = pool_ctas(kernel, smem, 1, n_shards, fit[variant], fit_smem[variant]);
  kernel<<<ctas, kThreads, smem, st>>>(prog, leaves, f, idx, n_idx, n_combos, mask, n_shards,
                                       out);
  return (int)cudaGetLastError();
}

}  // namespace

// K8P: groupn_tree's arguments and output, for a filter tree (n_ops >= 1)
// with pool leaves; words must be a pool row's full 32768.  Only the
// filter's live blocks are read, of its leaves and of every listed row;
// any filter over full-width rows gives groupn_tree's answer.
extern "C" int groupn_tree_pool(const void* const* leaf_ptrs, int n_leaves,
                                const void* ranges, const int* range_rows, int n_ranges,
                                const int* ops, int n_ops, const void* const* field_ptrs,
                                const int* field_k, const int* field_stride, int regs,
                                int n_fields, const void* idx, const void* mask, int n_shards,
                                int words, void* out, void* stream) {
  TreeProg prog = {};
  Leaves leaves = {};
  if (n_ops < 1 || !pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops,
                              &prog, &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (idx == nullptr || out == nullptr || mask == nullptr || words != kPoolRowVec * 4 ||
      n_shards < 0 || n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  Fields f = {};
  int n_idx = 0, n_combos = 1;
  size_t smem = 0;
  // The walk takes one item a thread a pass whatever the fields.
  if (!pack_fields(field_ptrs, field_k, field_stride, regs, n_fields, 1, &f, &n_idx, &n_combos,
                   &smem))
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const int kind = is_chain(ops, n_ops) ? 1 : 2;
  // A pool leaf is always compiled in; kRanges adds the range leaves.
  const bool rl = n_ranges > 0;
  const int* ix = (const int*)idx;
  const int* m = (const int*)mask;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (regs) {
    switch (n_fields) {
      case 1: launch_pool_reg<1>(kind, rl, prog, leaves, f, ix, m, n_shards, o, st); break;
      case 2: launch_pool_reg<2>(kind, rl, prog, leaves, f, ix, m, n_shards, o, st); break;
      case 3: launch_pool_reg<3>(kind, rl, prog, leaves, f, ix, m, n_shards, o, st); break;
      default: launch_pool_reg<4>(kind, rl, prog, leaves, f, ix, m, n_shards, o, st); break;
    }
    return (int)cudaGetLastError();
  }
  switch (n_fields) {
    case 1: return launch_pool<1>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
    case 2: return launch_pool<2>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
    case 3: return launch_pool<3>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
    case 4: return launch_pool<4>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
    case 5: return launch_pool<5>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
    case 6: return launch_pool<6>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
    case 7: return launch_pool<7>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
    default: return launch_pool<8>(kind, rl, smem, prog, leaves, f, ix, n_idx, n_combos, m, n_shards, o, st);
  }
}
