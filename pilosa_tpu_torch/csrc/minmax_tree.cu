// K7 minmax_tree: BSI Min or Max per shard, in one pass over the planes.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:511 minmax_tree
// (with pilosa_tpu/ops/bsi.py:185 minmax_valcount_nd): for each requested
// shard, the least (Min) or greatest (Max) value among the columns of
// notnull & filter(tree), and how many of them hold it, as uint64[S]
// values and int64[S] counts (count 0: no column considered, value 0).
// The reference splits the value into hi and lo halves because x64 is off
// on its device; here it is one uint64 (depth reaches 63, so bits 0..62).
// The host reduce over shards (decode_min_max) keeps the first shard in
// canonical order on ties, as the reference's ValCount reduce does.
//
// Bound: device-memory bytes.  Each requested shard's D + 1 planes are
// read once (9 x 960 x 128 KiB = 1.132 GB at depth 8, about 0.338 ms at
// 3.35 TB/s), plus the filter tree's leaves; a few integer instructions per
// plane word.
//
// Design.  One block per shard (960 blocks of 256 threads is one wave on
// 132 SMs).  Each thread walks its 16-byte positions and runs, inside each
// 32-bit word, the word-local walk of minmax_valcount_nd: keep the
// candidates where sel = keep & ~plane (Min) or keep & plane (Max) is not
// zero, and set the result bit where it is not (Min) or is (Max).  That
// gives each word's extreme value and the count of its columns holding it;
// the thread folds its words into one (value, count) pair, lexicographic
// with the counts of equal values merged.  The block then folds the pairs
// with warp shuffles and shared memory and stores the shard's pair, so the
// outputs need no fill and no atomics.  The plane loop is unrolled up to
// the launch's depth tier (8, 16, 32 or 63) with a guard, so a position's
// plane loads are all in flight together.  A missing plane reads as zeros.
//
// K7P (minmax_tree_pool): K7 for a filter tree with pool leaves, a Min or
// Max over a segment whose rows are only partly resident (a block pool,
// tree_eval.cuh load_pool).  The filter can be non-zero only in the blocks
// of its live word, the same for every shard (tree_eval.cuh block_live),
// and no column outside it is considered.  Bound: device-memory bytes, the
// filter's leaves and the not-null plane at the live blocks, and the value
// planes only where a column is considered: for the residency sweep's
// Min(Intersect(Row(wf0=0), Row(wf0=1)), field=rv), 8 live blocks over 960
// shards, rv holding 64 columns a shard, about 48 MB.  So K7P is bound by
// latency, not bandwidth: a position's loads form a chain (the slot
// vector, the pool word beside the not-null plane, then the value planes),
// and the design keeps as many of them in flight at once as it can, every
// shard at once.  Design: one CTA of 128 threads a shard,
// all 960 resident at once at the depth-8 tier (__launch_bounds__ caps the
// registers for 8 CTAs an SM).  The CTA lists its live blocks
// (live_block_list) and resolves each pool leaf's slot at each live block
// once, into shared memory; a block of a pool row is then one load.  A
// thread takes position t of each live block (128 uint4 a block), U blocks
// at a time (2 up to depth 16, 1 deeper): the not-null plane and
// every filter leaf of the U positions go out together, then each
// position that holds a considered column loads its value planes together
// and walks them as K7 does.  The CTA folds its pairs as K7 does and
// writes the shard's pair once; an unrequested shard, or a live word of 0,
// writes (0, 0) and reads nothing.  K7P has its own body, so K7's code is
// left as it was.
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Fold (v, c) into (best, n): the smaller (Min) or larger (Max) value
// wins, equal values add their counts, n == 0 is empty.
template <bool kMin>
__device__ __forceinline__ void fold(unsigned long long& best, unsigned long long& n,
                                     unsigned long long v, unsigned long long c) {
  if (c == 0) return;
  if (n == 0 || (kMin ? v < best : v > best)) {
    best = v;
    n = c;
  } else if (v == best) {
    n += c;
  }
}

// Shard s's pair, by the whole block (module comment): K7 walks its w4
// positions.
template <int kMaxD, bool kFilter, bool kChain, bool kRanges, bool kMin>
__device__ __forceinline__ void shard_pair(const TreeProg& prog, const Leaves& leaves,
                                           const RangeLeaf& planes, const int* mask, int s,
                                           int w4, unsigned long long* vals, long long* counts) {
  const int t = threadIdx.x;
  if (mask[s] == 0) {  // unrequested shard: no reads, an empty pair
    if (t == 0) {
      vals[s] = 0ull;
      counts[s] = 0;
    }
    return;
  }
  const int depth = planes.depth;
  const size_t shard_off = (size_t)s * (size_t)w4;
  unsigned long long best = 0ull, n = 0ull;
  for (int i = t; i < w4; i += kThreads) {
    size_t off = shard_off + i;
    uint4 k4 = load_plane(planes, depth, off);
    if (kFilter) {
      uint4 f;
      if (kChain)
        eval_chain<1, kRanges, true>(prog, leaves, &off, &f);
      else
        f = eval_tree<kRanges, true>(prog, leaves, off);
      k4 = and4(k4, f);
    }
    unsigned int keep[4] = {k4.x, k4.y, k4.z, k4.w};
    const bool any[4] = {keep[0] != 0u, keep[1] != 0u, keep[2] != 0u, keep[3] != 0u};
    if (!(any[0] || any[1] || any[2] || any[3])) continue;
    unsigned long long v[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
    for (int p = kMaxD - 1; p >= 0; --p) {
      if (p >= depth) continue;
      const uint4 r4 = load_plane(planes, p, off);
      const unsigned int row[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned int sel = keep[c] & (kMin ? ~row[c] : row[c]);
        const bool has = sel != 0u;
        keep[c] = has ? sel : keep[c];
        if (kMin ? !has : has) v[c] |= 1ull << p;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (any[c]) fold<kMin>(best, n, v[c], (unsigned long long)__popc(keep[c]));
  }

  // The block's pairs: warp shuffles, then the warps' pairs in shared
  // memory, folded in warp order by thread 0.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ob = __shfl_down_sync(0xffffffffu, best, o);
    const unsigned long long on = __shfl_down_sync(0xffffffffu, n, o);
    fold<kMin>(best, n, ob, on);
  }
  __shared__ unsigned long long wb[kWarps], wn[kWarps];
  if ((t & 31) == 0) {
    wb[t >> 5] = best;
    wn[t >> 5] = n;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w) fold<kMin>(best, n, wb[w], wn[w]);
    vals[s] = n ? best : 0ull;
    counts[s] = (long long)n;
  }
}

template <int kMaxD, bool kFilter, bool kChain, bool kMin>
__global__ void __launch_bounds__(kThreads)
    minmax_tree_kernel(TreeProg prog, Leaves leaves, RangeLeaf planes,
                       const int* __restrict__ mask, int w4,
                       unsigned long long* __restrict__ vals,
                       long long* __restrict__ counts) {
  shard_pair<kMaxD, kFilter, kChain, true, kMin>(prog, leaves, planes, mask, blockIdx.x, w4,
                                                 vals, counts);
}

// ---- K7P ----

constexpr int kPoolThreads = 128;
constexpr int kPoolWarps = kPoolThreads / 32;

// Each pool leaf's slot at each live block of the CTA (slot[k][i]: leaf k
// at live block i), resolved once.
struct LiveSlots {
  int slot[MAX_LEAVES][kPoolBlocks];
};

// An item of the filter at this thread's position of U live blocks
// g..g + U - 1 (uint4 offsets `off` of the shard's row): a stack row, a
// pool row (its block's slot from `ls`, one load, or zeros for slot 0 with
// none), a range leaf (tree_eval.cuh eval_range) or zero.
template <int U, bool kRanges>
__device__ __forceinline__ void live_items(int code, const Leaves& leaves, const LiveSlots& ls,
                                           int s, int g, const size_t* off, uint4* v) {
  const int op = code & 0xff;
  const int k = code >> 8;
  if (op == OP_LEAF) {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(leaves.base[k] + off[u]);
  } else if (op == OP_ROWB) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slot = ls.slot[k][g + u];
      v[u] = slot == 0 ? make_uint4(0u, 0u, 0u, 0u)
                       : __ldg(leaves.base[k] +
                               ((size_t)slot * leaves.pool_shards + s) * kPoolBlockVec +
                               threadIdx.x);
    }
  } else if (kRanges && op == OP_RANGE) {
    eval_range<U>(leaves.range[k], off, v);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// This thread's positions of live blocks g..g + U - 1: the filter (a chain
// over all U positions, its loads in flight together beside the not-null
// plane's; any other tree one position at a time), then for each position
// holding a considered column its value planes, all loads together, walked
// as shard_pair walks them, folded into (best, n).
template <int U, int kMaxD, bool kChain, bool kRanges, bool kMin>
__device__ __forceinline__ void live_positions(const TreeProg& prog, const Leaves& leaves,
                                               const RangeLeaf& planes, const LiveSlots& ls,
                                               const LiveBlocks& live, int s, int g,
                                               unsigned long long& best, unsigned long long& n) {
  const int depth = planes.depth;
  size_t off[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    off[u] = (size_t)s * kPoolRowVec + (size_t)live.block[g + u] * kPoolBlockVec + threadIdx.x;
  uint4 k4[U], f[U];
#pragma unroll
  for (int u = 0; u < U; ++u) k4[u] = load_plane(planes, depth, off[u]);
  if constexpr (kChain) {
    live_items<U, kRanges>(prog.ops[0], leaves, ls, s, g, off, f);
    for (int pc = 1; pc < prog.n; pc += 2) {
      uint4 v[U];
      live_items<U, kRanges>(prog.ops[pc], leaves, ls, s, g, off, v);
      const int op = prog.ops[pc + 1];
#pragma unroll
      for (int u = 0; u < U; ++u) f[u] = combine4(op, f[u], v[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint4 st[MAX_STACK];
      int sp = 0;
      for (int pc = 0; pc < prog.n; ++pc) {
        const int code = prog.ops[pc];
        const int op = code & 0xff;
        if (op == OP_LEAF || op == OP_ROWB || op == OP_ZERO || (kRanges && op == OP_RANGE)) {
          live_items<1, kRanges>(code, leaves, ls, s, g + u, off + u, &st[sp++]);
        } else {
          const uint4 r = st[--sp];
          st[sp - 1] = combine4(op, st[sp - 1], r);
        }
      }
      f[u] = st[0];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) k4[u] = and4(k4[u], f[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    unsigned int keep[4] = {k4[u].x, k4[u].y, k4[u].z, k4[u].w};
    const bool any[4] = {keep[0] != 0u, keep[1] != 0u, keep[2] != 0u, keep[3] != 0u};
    if (!(any[0] || any[1] || any[2] || any[3])) continue;
    // Up to 8 planes, every load goes out before the walk uses one (under
    // the register cap the compiler would otherwise issue them one by one);
    // deeper tiers load inside the walk, as shard_pair does.
    uint4 pre[kMaxD <= 8 ? kMaxD : 1];
    if constexpr (kMaxD <= 8) {
#pragma unroll
      for (int p = 0; p < kMaxD; ++p)
        pre[p] = p < depth ? load_plane(planes, p, off[u]) : make_uint4(0u, 0u, 0u, 0u);
    }
    unsigned long long v[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
    for (int p = kMaxD - 1; p >= 0; --p) {
      if (p >= depth) continue;
      uint4 r4;
      if constexpr (kMaxD <= 8)
        r4 = pre[p];
      else
        r4 = load_plane(planes, p, off[u]);
      const unsigned int row[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned int sel = keep[c] & (kMin ? ~row[c] : row[c]);
        const bool has = sel != 0u;
        keep[c] = has ? sel : keep[c];
        if (kMin ? !has : has) v[c] |= 1ull << p;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (any[c]) fold<kMin>(best, n, v[c], (unsigned long long)__popc(keep[c]));
  }
}

// K7P: one CTA a shard (module comment).
template <int kMaxD, bool kChain, bool kRanges, bool kMin>
__global__ void __launch_bounds__(kPoolThreads, kMaxD <= 16 ? 8 : 4)
    minmax_tree_pool_kernel(TreeProg prog, Leaves leaves, RangeLeaf planes,
                            const int* __restrict__ mask, int n_shards,
                            unsigned long long* __restrict__ vals,
                            long long* __restrict__ counts) {
  constexpr int U = kMaxD <= 16 ? 2 : 1;
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  if (mask[s] == 0) {  // unrequested shard: no reads, an empty pair
    if (t == 0) {
      vals[s] = 0ull;
      counts[s] = 0;
    }
    return;
  }
  __shared__ LiveBlocks live;
  __shared__ LiveSlots ls;
  const int n_live = live_block_list(prog, leaves, live);
  for (int i = t; i < MAX_LEAVES * n_live; i += kPoolThreads) {
    const int k = i / n_live;
    const int b = i - k * n_live;
    if (leaves.slot[k] != nullptr) ls.slot[k][b] = __ldg(leaves.slot[k] + live.block[b]);
  }
  __syncthreads();
  unsigned long long best = 0ull, n = 0ull;
  int g = 0;
  for (; g + U <= n_live; g += U)
    live_positions<U, kMaxD, kChain, kRanges, kMin>(prog, leaves, planes, ls, live, s, g, best,
                                                    n);
  for (; g < n_live; ++g)
    live_positions<1, kMaxD, kChain, kRanges, kMin>(prog, leaves, planes, ls, live, s, g, best,
                                                    n);
  // The CTA's pairs: warp shuffles, then the warps' pairs in shared memory,
  // folded in warp order by thread 0.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ob = __shfl_down_sync(0xffffffffu, best, o);
    const unsigned long long on = __shfl_down_sync(0xffffffffu, n, o);
    fold<kMin>(best, n, ob, on);
  }
  __shared__ unsigned long long wb[kPoolWarps], wn[kPoolWarps];
  if ((t & 31) == 0) {
    wb[t >> 5] = best;
    wn[t >> 5] = n;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kPoolWarps; ++w) fold<kMin>(best, n, wb[w], wn[w]);
    vals[s] = n ? best : 0ull;
    counts[s] = (long long)n;
  }
}

template <int kMaxD, bool kMin>
void launch_pool(int n_shards, bool chain, bool ranges, const TreeProg& prog,
                 const Leaves& leaves, const RangeLeaf& planes, const int* mask,
                 unsigned long long* vals, long long* counts, cudaStream_t stream) {
  auto kernel = chain ? (ranges ? minmax_tree_pool_kernel<kMaxD, true, true, kMin>
                                : minmax_tree_pool_kernel<kMaxD, true, false, kMin>)
                      : (ranges ? minmax_tree_pool_kernel<kMaxD, false, true, kMin>
                                : minmax_tree_pool_kernel<kMaxD, false, false, kMin>);
  kernel<<<n_shards, kPoolThreads, 0, stream>>>(prog, leaves, planes, mask, n_shards, vals,
                                                counts);
}

template <bool kMin>
void launch_pool_depth(int n_shards, bool chain, bool ranges, const TreeProg& prog,
                       const Leaves& leaves, const RangeLeaf& pl, const int* mask,
                       unsigned long long* vals, long long* counts, cudaStream_t st) {
  if (pl.depth <= 8)
    launch_pool<8, kMin>(n_shards, chain, ranges, prog, leaves, pl, mask, vals, counts, st);
  else if (pl.depth <= 16)
    launch_pool<16, kMin>(n_shards, chain, ranges, prog, leaves, pl, mask, vals, counts, st);
  else if (pl.depth <= 32)
    launch_pool<32, kMin>(n_shards, chain, ranges, prog, leaves, pl, mask, vals, counts, st);
  else
    launch_pool<MAX_PLANES - 1, kMin>(n_shards, chain, ranges, prog, leaves, pl, mask, vals,
                                      counts, st);
}


template <int kMaxD, bool kMin>
void launch(int n_shards, bool filter, bool chain, const TreeProg& prog,
            const Leaves& leaves, const RangeLeaf& planes, const int* mask,
            int w4, unsigned long long* vals, long long* counts,
            cudaStream_t stream) {
  if (!filter)
    minmax_tree_kernel<kMaxD, false, false, kMin><<<n_shards, kThreads, 0, stream>>>(
        prog, leaves, planes, mask, w4, vals, counts);
  else if (chain)
    minmax_tree_kernel<kMaxD, true, true, kMin><<<n_shards, kThreads, 0, stream>>>(
        prog, leaves, planes, mask, w4, vals, counts);
  else
    minmax_tree_kernel<kMaxD, true, false, kMin><<<n_shards, kThreads, 0, stream>>>(
        prog, leaves, planes, mask, w4, vals, counts);
}

template <bool kMin>
void launch_depth(int n_shards, bool filter, bool chain, const TreeProg& prog,
                  const Leaves& leaves, const RangeLeaf& pl, const int* mask,
                  int w4, unsigned long long* vals, long long* counts,
                  cudaStream_t st) {
  if (pl.depth <= 8)
    launch<8, kMin>(n_shards, filter, chain, prog, leaves, pl, mask, w4, vals, counts, st);
  else if (pl.depth <= 16)
    launch<16, kMin>(n_shards, filter, chain, prog, leaves, pl, mask, w4, vals, counts, st);
  else if (pl.depth <= 32)
    launch<32, kMin>(n_shards, filter, chain, prog, leaves, pl, mask, w4, vals, counts, st);
  else
    launch<MAX_PLANES - 1, kMin>(n_shards, filter, chain, prog, leaves, pl, mask, w4,
                                 vals, counts, st);
}

}  // namespace

// leaf_ptrs, ranges, range_rows, ops: the filter tree as in
// count_tree_dense, or n_ops = 0 for no filter.  planes, plane_rows: the
// BSI stack's planes as in sum_tree.  is_min: 1 for Min, 0 for Max.  mask:
// device int32[S].  vals: device uint64[S], counts: device int64[S], every
// entry written by the kernel.  Returns the cudaError_t of the launch.
extern "C" int minmax_tree(const void* const* leaf_ptrs, int n_leaves,
                           const void* ranges, const int* range_rows,
                           int n_ranges, const int* ops, int n_ops,
                           const void* planes, int plane_rows, int is_min,
                           const void* mask, int n_shards, int words,
                           void* vals, void* counts, void* stream) {
  TreeProg prog = {};
  Leaves leaves = {};
  const bool filter = n_ops > 0;
  if (filter && !pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges,
                           ops, n_ops, &prog, &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (planes == nullptr || vals == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  const RangeLeaf pl = *(const RangeLeaf*)planes;
  if (!planes_ok(pl, plane_rows) || words <= 0 || words % 4 != 0 || n_shards < 0)
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const bool chain = filter && is_chain(ops, n_ops);
  const int* m = (const int*)mask;
  unsigned long long* v = (unsigned long long*)vals;
  long long* c = (long long*)counts;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_min)
    launch_depth<true>(n_shards, filter, chain, prog, leaves, pl, m, words / 4, v, c, st);
  else
    launch_depth<false>(n_shards, filter, chain, prog, leaves, pl, m, words / 4, v, c, st);
  return (int)cudaGetLastError();
}

// K7P: minmax_tree's arguments and outputs, for a filter tree (n_ops >= 1)
// with pool leaves; words must be a pool row's full 32768.  Only the
// filter's live blocks are read, of its leaves and of every plane; any
// filter over full-width rows gives minmax_tree's answer.
extern "C" int minmax_tree_pool(const void* const* leaf_ptrs, int n_leaves,
                                const void* ranges, const int* range_rows, int n_ranges,
                                const int* ops, int n_ops, const void* planes,
                                int plane_rows, int is_min, const void* mask,
                                int n_shards, int words, void* vals, void* counts,
                                void* stream) {
  TreeProg prog = {};
  Leaves leaves = {};
  if (n_ops < 1 || !pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops,
                              &prog, &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (planes == nullptr || vals == nullptr || counts == nullptr || mask == nullptr)
    return (int)cudaErrorInvalidValue;
  const RangeLeaf pl = *(const RangeLeaf*)planes;
  if (!planes_ok(pl, plane_rows) || words != kPoolRowVec * 4 || n_shards < 0)
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const bool chain = is_chain(ops, n_ops), ranged = n_ranges > 0;
  const int* m = (const int*)mask;
  unsigned long long* v = (unsigned long long*)vals;
  long long* c = (long long*)counts;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_min)
    launch_pool_depth<true>(n_shards, chain, ranged, prog, leaves, pl, m, v, c, st);
  else
    launch_pool_depth<false>(n_shards, chain, ranged, prog, leaves, pl, m, v, c, st);
  return (int)cudaGetLastError();
}
