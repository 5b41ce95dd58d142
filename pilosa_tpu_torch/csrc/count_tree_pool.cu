// K1P count_tree_pool: Count(tree) for a tree with block-pool leaves, over
// only the 2 KiB blocks that the tree can make non-zero.
//
// Replaces, for trees that read a partial stack, the XLA program
// pilosa_tpu/parallel/kernels.py:242 count_tree through apply_prog's `rowb`
// leaf (:84-97): sum(popcount(tree(rows) & mask)), where a pool row is
// gathered from a block pool int32[P, S, 512] through its slot vector
// int32[64] (slot 0 all zero).  K1 (count_tree_dense.cu) evaluates such a
// tree too, but steps through every one of a row's 8192 16-byte positions
// in every shard, so a pool row of 8 occupied blocks costs it the loop of 64.
//
// Bound: device-memory bytes.  Each leaf's live blocks over the requested
// shards are read once: 2 pool rows x 8 live blocks x 960 shards x 2 KiB =
// 31.46 MB for the residency dashboard's Count(Intersect), 9.4 us at
// 3.35 TB/s; the bitwise ops and popcounts are a few integer instructions
// per 16 bytes.
//
// Design.
// 1. The live word.  Block b of a pool row sits in slot slot[b] in every
//    shard, so which blocks a tree can read is one 64-bit word for all
//    shards (tree_eval.cuh block_live).  Each CTA works it out on entry
//    (tree_eval.cuh live_block_list, shared with K3P and K6P): 64 threads
//    take one block each over the slot vectors, two warp ballots give the
//    word, and the live blocks are listed in shared memory.  No host read
//    of the slot table, no extra argument.
// 2. The grid covers live work only.  A work item is a (live block, shard)
//    pair, numbered block-major, so neighbouring items are neighbouring
//    shards of one block: for a pool leaf, neighbouring 2 KiB in memory
//    (slot p of the pool holds its block for all S shards back to back).
//    128 threads take an item, one uint4 each of every leaf (a coalesced
//    2 KiB read); a CTA of 512 threads takes four items at a time, and the
//    grid (as many CTAs as the card holds at once) strides over the rest.
//    Items of an unrequested shard are passed over by a test uniform over
//    the 128 threads, before anything is read.  Chain programs have two
//    items' loads of every leaf in flight per thread (eval_chain, as K2's
//    chain_blocks): two keep a chain without range leaves small enough in
//    registers for several CTAs an SM, which holds more bytes in flight
//    than four items a thread in one CTA.  Other trees run the interpreter
//    one item at a time.  Stack rows and range planes are read in place at
//    the block's words, the pool through tree_eval.cuh's load_pool; a tree
//    without range leaves compiles without them (kRanges false, kPools
//    true).
// 3. Dead work costs nothing: no thread steps through a dead block, and a
//    live word of 0 reads no leaf and adds nothing to the zeroed output.
// 4. One reduction per CTA and one atomic add (K1's scheme, block_add).
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kGroups = kThreads / kPoolBlockVec;     // items per CTA at a time
constexpr int kBlocks = kPoolRowVec / kPoolBlockVec;  // 64 blocks a row
constexpr int kInFlight = 2;                          // items read together
constexpr int kMaxShards = 65535;  // keeps a CTA's count within 32 bits

// The next item at or after i, in steps of `stride`, whose shard is
// requested (n_items when none is left).
__device__ __forceinline__ int next_item(int i, int n_items, int n_shards, int stride,
                                         const int* __restrict__ mask) {
  while (i < n_items && mask[i % n_shards] == 0) i += stride;
  return i;
}

// The uint4 offset of the thread's position `vec` in item i's block of
// its shard, in a row's [S, W] words.
__device__ __forceinline__ size_t item_off(int i, int n_shards, const int* blocks, int vec) {
  const int j = i / n_shards;
  const int s = i - j * n_shards;
  return (size_t)s * kPoolRowVec + (size_t)blocks[j] * kPoolBlockVec + vec;
}

template <bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    count_tree_pool_kernel(TreeProg prog, Leaves leaves, const int* __restrict__ mask,
                           int n_shards, unsigned long long* __restrict__ out) {
  __shared__ LiveBlocks live;
  const int n_items = live_block_list(prog, leaves, live) * n_shards;
  const int* blocks = live.block;
  if (n_items == 0) return;  // uniform over the CTA: nothing to read

  const int vec = threadIdx.x % kPoolBlockVec;
  const int stride = gridDim.x * kGroups;
  int i = blockIdx.x * kGroups + threadIdx.x / kPoolBlockVec;
  unsigned int count = 0;
  if (kChain) {
    for (i = next_item(i, n_items, n_shards, stride, mask); i < n_items;
         i = next_item(i, n_items, n_shards, stride, mask)) {
      size_t off[kInFlight];
      off[0] = item_off(i, n_shards, blocks, vec);
      i += stride;
      int n = 1;
#pragma unroll
      for (int u = 1; u < kInFlight; ++u) {
        i = next_item(i, n_items, n_shards, stride, mask);
        if (i < n_items) {
          off[u] = item_off(i, n_shards, blocks, vec);
          i += stride;
          n = u + 1;
        } else {
          off[u] = off[0];  // read again from L1, not counted
        }
      }
      uint4 acc[kInFlight];
      eval_chain<kInFlight, kRanges, true>(prog, leaves, off, acc);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (u < n) count += popc4(acc[u]);
    }
  } else {
    for (i = next_item(i, n_items, n_shards, stride, mask); i < n_items;
         i = next_item(i + stride, n_items, n_shards, stride, mask))
      count += popc4(eval_tree<kRanges, true>(prog, leaves,
                                              item_off(i, n_shards, blocks, vec)));
  }
  block_add(count, out);
}

}  // namespace

// The arguments of count_tree_dense (count_tree_dense.cu): leaf_ptrs (each
// leaf's base, then each leaf's slot vector, null for a stack row), the
// range leaves, the opcodes, mask device int32[S], the shard count, the row
// width (the full 32768 words of a pool row), out a device uint64
// accumulator zeroed by the caller.  Returns the cudaError_t of the launch.
extern "C" int count_tree_pool(const void* const* leaf_ptrs, int n_leaves,
                               const void* ranges, const int* range_rows,
                               int n_ranges, const int* ops, int n_ops, const void* mask,
                               int n_shards, int words, void* out, void* stream) {
  TreeProg prog;
  Leaves leaves;
  if (!pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops, &prog,
                 &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (words != kPoolRowVec * 4 || n_shards < 0 || n_shards > kMaxShards ||
      (mask == nullptr && n_shards > 0) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const bool chain = is_chain(ops, n_ops), ranged = n_ranges > 0;
  auto kernel = chain ? (ranged ? count_tree_pool_kernel<true, true>
                                : count_tree_pool_kernel<true, false>)
                      : (ranged ? count_tree_pool_kernel<false, true>
                                : count_tree_pool_kernel<false, false>);
  // Enough CTAs for every block live, at most as many as the card holds at
  // once (the variant's registers decide how many an SM takes): with fewer
  // live blocks the extra CTAs find no item after the live word.
  static int per_sm[2][2];
  int& fit = per_sm[chain][ranged];
  if (fit == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, 0) != cudaSuccess ||
       fit <= 0))
    fit = 1;
  int ctas = (kBlocks * n_shards + kGroups - 1) / kGroups;
  if (ctas > fit * n_sms()) ctas = fit * n_sms();
  kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(prog, leaves, (const int*)mask,
                                                      n_shards, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
