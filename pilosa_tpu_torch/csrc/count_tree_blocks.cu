// K2 count_tree_blocks: Count(tree) over only the listed 2 KiB occupancy
// blocks of each shard.
//
// Replaces the Pallas kernel pilosa_tpu/parallel/sparse.py:164
// _pallas_shard_count (entered by count_tree_blocks_pallas :233): for each
// shard s and each slot j < blk_n[s] it reads block blk_idx[s, j] (512
// words) of every leaf row, combines them through the tree, popcounts and
// sums.  The Pallas kernel ran its (shard, slot) grid in order on one core,
// DMA'd each block into VMEM and carried the sum in SMEM between steps; here
// every (shard, slot) pair is its own block of 128 threads (128 x 16 bytes =
// exactly one occupancy block), the blocks run in parallel across the SMs,
// and the carried sum becomes one atomic add per block.
//
// Bound: device-memory bytes, n_leaves * sum(blk_n) * 2 KiB, read once.
// Padding slots (j >= blk_n[s]) and unrequested shards (the caller folds the
// shard mask into blk_n, as sparse.py:239 does) return before reading
// anything.  Kb, the slot count, stays on the power-of-two tiers of the
// engine's planner.
//
// Grid: (Kb slots, shard).  Block: 128 threads, one uint4 each.  Chain
// programs run in registers, other trees on the general interpreter
// (tree_eval.cuh).
#include "tree_eval.cuh"

namespace {

constexpr int kBlockWords = 512;            // words per occupancy block
constexpr int kThreads = kBlockWords / 4;   // one uint4 per thread

template <bool kChain>
__global__ void __launch_bounds__(kThreads)
    count_tree_blocks_kernel(TreeProg prog, Leaves leaves,
                             const int* __restrict__ blk_idx,
                             const int* __restrict__ blk_n, int kb, int w4,
                             unsigned long long* __restrict__ out) {
  const int s = blockIdx.y;
  const int j = blockIdx.x;
  if (j >= blk_n[s]) return;  // padding slot or unrequested shard
  const int b = blk_idx[(size_t)s * kb + j];
  const size_t off = (size_t)s * (size_t)w4 + (size_t)b * kThreads + threadIdx.x;
  uint4 v;
  if (kChain)
    eval_chain<1>(prog, leaves, &off, &v);
  else
    v = eval_tree(prog, leaves, off);
  block_add(popc4(v), out);
}

}  // namespace

// leaf_ptrs: host array of n_leaves device pointers, each the [S, W] words
// of one leaf row.  ops: host array of n_ops postfix opcodes.  blk_idx:
// device int32[S, Kb] block ids; blk_n: device int32[S] listed-slot counts
// (0 for unrequested shards).  out: device uint64 accumulator (zeroed by
// the caller).  Returns the cudaError_t of the launch.
extern "C" int count_tree_blocks(const void* const* leaf_ptrs, int n_leaves,
                                 const int* ops, int n_ops,
                                 const void* blk_idx, const void* blk_n,
                                 int n_shards, int kb, int words, void* out,
                                 void* stream) {
  TreeProg prog;
  Leaves leaves;
  if (!pack_args(leaf_ptrs, n_leaves, ops, n_ops, &prog, &leaves))
    return (int)cudaErrorInvalidValue;
  if (words <= 0 || words % kBlockWords != 0 || kb < 1 || kb > words / kBlockWords ||
      n_shards < 0 || n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const dim3 grid(kb, n_shards);
  if (is_chain(ops, n_ops))
    count_tree_blocks_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        prog, leaves, (const int*)blk_idx, (const int*)blk_n, kb, words / 4,
        (unsigned long long*)out);
  else
    count_tree_blocks_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        prog, leaves, (const int*)blk_idx, (const int*)blk_n, kb, words / 4,
        (unsigned long long*)out);
  return (int)cudaGetLastError();
}
