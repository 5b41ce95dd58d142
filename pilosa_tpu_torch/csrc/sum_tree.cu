// K6 sum_tree: the per-plane counts of a BSI Sum, in one pass.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:474 sum_tree
// (with pilosa_tpu/ops/bsi.py:131 sum_counts): over the requested shards,
// consider = notnull & filter(tree), then popcount(plane_i & consider) for
// each of the D value planes and popcount(consider), as uint64[D + 1]
// (plane counts, then the considered count).  The weighted sum
// sum(counts[i] << i) + n * min stays on the host in Python ints, as in
// the reference; here the counts are 64-bit (the reference sums in int32:
// at 960 shards a plane count reaches 2^30).
//
// Bound: device-memory bytes.  Each requested shard's D + 1 planes are
// read once (9 planes x 960 shards x 128 KiB = 1.132 GB at depth 8, about
// 0.338 ms at 3.35 TB/s), plus the filter tree's leaf rows; an AND, a
// popcount and an add per plane word, far below the card's integer rate.
//
// Design.  K1's grid: (chunks of a shard's words, shard), 256 threads, a
// block of an unrequested shard returns before it reads anything.  Each
// thread walks its positions as 16-byte vectors: it evaluates the filter
// tree (tree_eval.cuh, so range leaves work inside a filter), ANDs in the
// not-null plane, and keeps the D + 1 counts in registers (the plane loop
// is unrolled up to the launch's depth tier, 8, 16, 32 or 63, with a
// guard, so the counts stay in registers and a position's plane loads are
// all in flight together).  Each block sums its counts (reduce.cuh) and
// adds them into the output with one 64-bit atomic per count.  A missing
// plane (-1) reads as zeros; depth 0 (min == max) counts the considered
// columns alone.
//
// K6P (sum_tree_pool): K6 for a filter tree with pool leaves, a Sum over
// a segment whose rows are only partly resident (a block pool,
// tree_eval.cuh load_pool).  The filter can be non-zero only in the blocks
// of its live word, the same for every shard (tree_eval.cuh block_live),
// and no column outside it is considered.  Bound: device-memory bytes, the
// filter's leaves and the D + 1 planes read at the live blocks only:
// (2 + 8) rows x 8 live blocks x 960 shards x 2 KiB = 157 MB, 0.047 ms at
// 3.35 TB/s, for the residency sweep's Sum(Intersect(Row(wf0=0),
// Row(wf0=1)), field=rv), where K6 reads all eight planes whole (1.01 GB).
// Design: a Sum needs no per-shard result, so the work is one flat list
// of (shard, live position) items, shard-major, and a grid of as many CTAs
// as the card holds at once strides over it (K1P's grid): each CTA lists
// the live blocks in shared memory once (tree_eval.cuh live_block_list),
// then takes an item a thread at a time; a position of an unrequested
// shard reads nothing.  The counts stay in registers at K6's depth tiers
// across every item a thread takes, and the CTA adds each with one 64-bit
// atomic, as K6 does.  A live word of 0 reads nothing and adds nothing.
// (One CTA a shard was the first design: slower at 8 live blocks, and
// with a full live word slower than K6's walk, the last of its 1.8 waves
// a third full.)
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUint4PerThread = 8;

template <int kMaxD, bool kFilter, bool kChain>
__global__ void __launch_bounds__(kThreads)
    sum_tree_kernel(TreeProg prog, Leaves leaves, RangeLeaf planes,
                    const int* __restrict__ mask, int w4,
                    unsigned long long* __restrict__ out) {
  const int s = blockIdx.y;
  if (mask[s] == 0) return;  // unrequested shard: no reads at all
  const int depth = planes.depth;
  const size_t shard_off = (size_t)s * (size_t)w4;
  unsigned int cnt[kMaxD + 1];  // per value plane, then the considered count
#pragma unroll
  for (int p = 0; p <= kMaxD; ++p) cnt[p] = 0u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < w4;
       i += gridDim.x * blockDim.x) {
    const size_t off = shard_off + i;
    uint4 consider = load_plane(planes, depth, off);
    if (kFilter) {
      uint4 f;
      if (kChain)
        eval_chain<1>(prog, leaves, &off, &f);
      else
        f = eval_tree(prog, leaves, off);
      consider = and4(consider, f);
    }
    cnt[kMaxD] += popc4(consider);
#pragma unroll
    for (int p = 0; p < kMaxD; ++p)
      if (p < depth) cnt[p] += popc4(and4(load_plane(planes, p, off), consider));
  }
  const unsigned int sum = cluster_sum<kMaxD + 1, kThreads>(cnt, 0, 1);
  const int t = threadIdx.x;
  if (t < depth && sum) atomicAdd(out + t, (unsigned long long)sum);
  if (t == kMaxD && sum) atomicAdd(out + depth, (unsigned long long)sum);
}

// K6P: items are (shard, live position) pairs, shard-major; a grid of as
// many CTAs as the card holds at once strides over them.
template <int kMaxD, bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    sum_tree_pool_kernel(TreeProg prog, Leaves leaves, RangeLeaf planes,
                         const int* __restrict__ mask, int n_shards,
                         unsigned long long* __restrict__ out) {
  __shared__ LiveBlocks live;
  const int n_pos = live_block_list(prog, leaves, live) * kPoolBlockVec;
  if (n_pos == 0) return;  // uniform over the block: nothing live
  const int depth = planes.depth;
  unsigned int cnt[kMaxD + 1];  // per value plane, then the considered count
#pragma unroll
  for (int p = 0; p <= kMaxD; ++p) cnt[p] = 0u;
  const int n_items = n_pos * n_shards;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_items; i += gridDim.x * kThreads) {
    const int s = i / n_pos;
    const int j = i - s * n_pos;
    if (mask[s] == 0) continue;  // an unrequested shard's positions read nothing
    const size_t off = (size_t)s * kPoolRowVec + live.block[j / kPoolBlockVec] * kPoolBlockVec +
                       j % kPoolBlockVec;
    uint4 f;
    if (kChain)
      eval_chain<1, kRanges, true>(prog, leaves, &off, &f);
    else
      f = eval_tree<kRanges, true>(prog, leaves, off);
    const uint4 consider = and4(load_plane(planes, depth, off), f);
    cnt[kMaxD] += popc4(consider);
#pragma unroll
    for (int p = 0; p < kMaxD; ++p)
      if (p < depth) cnt[p] += popc4(and4(load_plane(planes, p, off), consider));
  }
  const unsigned int sum = cluster_sum<kMaxD + 1, kThreads>(cnt, 0, 1);
  const int t = threadIdx.x;
  if (t < depth && sum) atomicAdd(out + t, (unsigned long long)sum);
  if (t == kMaxD && sum) atomicAdd(out + depth, (unsigned long long)sum);
}

template <int kMaxD>
void launch_pool(int n_shards, bool chain, bool ranges, const TreeProg& prog,
                 const Leaves& leaves, const RangeLeaf& planes, const int* mask,
                 unsigned long long* out, cudaStream_t stream) {
  auto kernel = chain ? (ranges ? sum_tree_pool_kernel<kMaxD, true, true>
                                : sum_tree_pool_kernel<kMaxD, true, false>)
                      : (ranges ? sum_tree_pool_kernel<kMaxD, false, true>
                                : sum_tree_pool_kernel<kMaxD, false, false>);
  // As many CTAs as the card holds at once (the variant's registers decide
  // how many an SM takes), at most enough for every block live: with fewer
  // live blocks the same CTAs take fewer items each.
  static int per_sm[2][2];
  int& fit = per_sm[chain][ranges];
  if (fit == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, 0) != cudaSuccess ||
       fit <= 0))
    fit = 1;
  const long long most = ((long long)kPoolRowVec * n_shards + kThreads - 1) / kThreads;
  const int ctas = (int)(most < (long long)fit * n_sms() ? most : (long long)fit * n_sms());
  kernel<<<ctas, kThreads, 0, stream>>>(prog, leaves, planes, mask, n_shards, out);
}

template <int kMaxD>
void launch(dim3 grid, bool filter, bool chain, const TreeProg& prog,
            const Leaves& leaves, const RangeLeaf& planes, const int* mask,
            int w4, unsigned long long* out, cudaStream_t stream) {
  if (!filter)
    sum_tree_kernel<kMaxD, false, false><<<grid, kThreads, 0, stream>>>(
        prog, leaves, planes, mask, w4, out);
  else if (chain)
    sum_tree_kernel<kMaxD, true, true><<<grid, kThreads, 0, stream>>>(
        prog, leaves, planes, mask, w4, out);
  else
    sum_tree_kernel<kMaxD, true, false><<<grid, kThreads, 0, stream>>>(
        prog, leaves, planes, mask, w4, out);
}

}  // namespace

// leaf_ptrs, ranges, range_rows, ops: the filter tree as in
// count_tree_dense, or n_ops = 0 for no filter (every column).  planes:
// one host RangeLeaf whose base, stride, depth and plane[0..depth] name the
// BSI field stack's planes (kind and predicates unused); plane_rows is that
// stack's row count.  mask: device int32[S].  out: device uint64[depth + 1],
// zeroed by the caller: the plane counts, then the considered count.
// Returns the cudaError_t of the launch.
extern "C" int sum_tree(const void* const* leaf_ptrs, int n_leaves,
                        const void* ranges, const int* range_rows, int n_ranges,
                        const int* ops, int n_ops, const void* planes,
                        int plane_rows, const void* mask, int n_shards,
                        int words, void* out, void* stream) {
  TreeProg prog = {};
  Leaves leaves = {};
  const bool filter = n_ops > 0;
  if (filter && !pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges,
                           ops, n_ops, &prog, &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (planes == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  const RangeLeaf pl = *(const RangeLeaf*)planes;
  if (!planes_ok(pl, plane_rows) || words <= 0 || words % 4 != 0 ||
      n_shards < 0 || n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const int w4 = words / 4;
  int chunks = (w4 + kThreads * kUint4PerThread - 1) / (kThreads * kUint4PerThread);
  if (chunks < 1) chunks = 1;
  const dim3 grid(chunks, n_shards);
  const bool chain = filter && is_chain(ops, n_ops);
  const int* m = (const int*)mask;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (pl.depth <= 8)
    launch<8>(grid, filter, chain, prog, leaves, pl, m, w4, o, st);
  else if (pl.depth <= 16)
    launch<16>(grid, filter, chain, prog, leaves, pl, m, w4, o, st);
  else if (pl.depth <= 32)
    launch<32>(grid, filter, chain, prog, leaves, pl, m, w4, o, st);
  else
    launch<MAX_PLANES - 1>(grid, filter, chain, prog, leaves, pl, m, w4, o, st);
  return (int)cudaGetLastError();
}

// K6P: sum_tree's arguments and output, for a filter tree (n_ops >= 1)
// with pool leaves; words must be a pool row's full 32768.  Only the
// filter's live blocks are read, of its leaves and of every plane; any
// filter over full-width rows gives sum_tree's answer.
extern "C" int sum_tree_pool(const void* const* leaf_ptrs, int n_leaves,
                             const void* ranges, const int* range_rows, int n_ranges,
                             const int* ops, int n_ops, const void* planes,
                             int plane_rows, const void* mask, int n_shards,
                             int words, void* out, void* stream) {
  TreeProg prog = {};
  Leaves leaves = {};
  if (n_ops < 1 || !pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops,
                              &prog, &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (planes == nullptr || out == nullptr || mask == nullptr) return (int)cudaErrorInvalidValue;
  const RangeLeaf pl = *(const RangeLeaf*)planes;
  if (!planes_ok(pl, plane_rows) || words != kPoolRowVec * 4 || n_shards < 0 ||
      n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const bool chain = is_chain(ops, n_ops), ranged = n_ranges > 0;
  const int* m = (const int*)mask;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (pl.depth <= 8)
    launch_pool<8>(n_shards, chain, ranged, prog, leaves, pl, m, o, st);
  else if (pl.depth <= 16)
    launch_pool<16>(n_shards, chain, ranged, prog, leaves, pl, m, o, st);
  else if (pl.depth <= 32)
    launch_pool<32>(n_shards, chain, ranged, prog, leaves, pl, m, o, st);
  else
    launch_pool<MAX_PLANES - 1>(n_shards, chain, ranged, prog, leaves, pl, m, o, st);
  return (int)cudaGetLastError();
}
