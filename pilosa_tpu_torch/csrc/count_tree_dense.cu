// K1 count_tree_dense: Count(tree) over every word of the requested shards.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:242 count_tree
// (evaluated by apply_prog :64): the masked popcount of the evaluated tree,
// sum(popcount(tree(rows) & mask)), over field stacks int32[R, S, W].
//
// Bound: device-memory bytes.  The work is n_leaves * n_requested_shards *
// W * 4 bytes read once (2 * 960 * 128 KiB = 251.7 MB for the two-row
// Intersect over 960 shards, about 75 us at 3.35 TB/s); the popcount and
// bitwise ops are a few integer instructions per 16 bytes, far below the
// card's integer rate.  The design streams each leaf word once with 16-byte
// loads (neighbouring threads on neighbouring addresses), combines in
// registers, and never writes an intermediate row.  A block whose shard is
// not requested returns before it reads anything, so unrequested shards
// cost no bytes.  One atomic add per block finishes the reduction.
//
// A BSI range leaf (tree_eval.cuh) reads its depth + 1 planes per
// position instead of one row: Count(Range(v > N)) at depth 8 reads 9 x 960
// x 128 KiB = 1.132 GB, about 0.338 ms.
//
// Grid: (chunks of the shard's words, shard).  Block: 256 threads, each
// walking its chunk with a stride of the whole x-grid.  Chain programs
// (every n-ary Intersect/Union/Difference/Xor of rows, the north star
// included) keep their two live values in registers and have four
// positions' loads in flight per thread; other trees take the general
// interpreter with its stack in thread-local memory.
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUint4PerThread = 8;  // uint4 each thread visits per shard
constexpr int kChainUnroll = 4;     // positions per pass of a chain program

template <bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    count_tree_dense_kernel(TreeProg prog, Leaves leaves,
                            const int* __restrict__ mask, int w4,
                            unsigned long long* __restrict__ out) {
  const int s = blockIdx.y;
  if (mask[s] == 0) return;  // unrequested shard: no reads at all
  const size_t shard_off = (size_t)s * (size_t)w4;
  const int stride = gridDim.x * blockDim.x;
  unsigned int count = 0;
  if (kChain) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < w4;
         i += kChainUnroll * stride) {
      size_t off[kChainUnroll];
      uint4 acc[kChainUnroll];
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u) {
        const int j = i + u * stride;
        off[u] = shard_off + (j < w4 ? j : i);  // clamp the ragged edge
      }
      eval_chain<kChainUnroll, kRanges>(prog, leaves, off, acc);
#pragma unroll
      for (int u = 0; u < kChainUnroll; ++u)
        if (i + u * stride < w4) count += popc4(acc[u]);
    }
  } else {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < w4; i += stride)
      count += popc4(eval_tree<kRanges>(prog, leaves, shard_off + i));
  }
  block_add(count, out);
}

}  // namespace

// leaf_ptrs: host array of n_leaves device pointers, each the [S, W] words
// of one leaf row.  ranges: host array of n_ranges RangeLeaf (tree_eval.cuh),
// range_rows the row count of each one's stack.  ops: host array of n_ops
// postfix opcodes.  mask: device int32[S].  out: device uint64 accumulator
// (zeroed by the caller).  Returns the cudaError_t of the launch.
extern "C" int count_tree_dense(const void* const* leaf_ptrs, int n_leaves,
                                const void* ranges, const int* range_rows,
                                int n_ranges, const int* ops, int n_ops, const void* mask,
                                int n_shards, int words, void* out,
                                void* stream) {
  TreeProg prog;
  Leaves leaves;
  if (!pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops, &prog,
                 &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (words <= 0 || words % 4 != 0 || n_shards < 0 || n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const int w4 = words / 4;
  int chunks = (w4 + kThreads * kUint4PerThread - 1) / (kThreads * kUint4PerThread);
  if (chunks < 1) chunks = 1;
  const dim3 grid(chunks, n_shards);
  const bool extra = has_extra_leaves(ops, n_ops, n_ranges);
  auto kernel = is_chain(ops, n_ops)
                    ? (extra ? count_tree_dense_kernel<true, true>
                             : count_tree_dense_kernel<true, false>)
                    : (extra ? count_tree_dense_kernel<false, true>
                             : count_tree_dense_kernel<false, false>);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      prog, leaves, (const int*)mask, w4, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
