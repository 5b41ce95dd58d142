// K10 eval_tree: the masked words of an evaluated tree.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:284 eval_tree
// (and the local part of :297 eval_tree_replicated): out[s, w] =
// tree(rows)[s, w] & (mask[s] ? ~0 : 0) over field stacks int32[R, S, W],
// written as int32[S, W].  No popcount, no reduction and no atomics: the
// words themselves are the result (a Row() query's bitmap).
//
// Bound: device-memory bytes.  Each requested shard reads its leaf rows
// once and every shard writes its W words once: for the two-row Intersect
// over 960 shards, 2 x 960 x 128 KiB read plus 960 x 128 KiB written =
// 377 MB, about 0.113 ms at 3.35 TB/s.  An unrequested shard reads nothing
// and writes zeros.
//
// Grid: (chunks of the shard's words, shard).  Block: 256 threads, each
// walking its chunk with a stride of the whole x-grid over 16-byte vectors
// (four words a thread and position, neighbouring threads on neighbouring
// addresses).  Chain programs keep four positions' loads in flight per
// thread, as K1 does; other trees take the general interpreter.  Row, range
// and pool leaves all come from tree_eval.cuh.
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUint4PerThread = 8;  // uint4 each thread visits per shard
constexpr int kChainUnroll = 4;     // positions per pass of a chain program

template <bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    eval_tree_kernel(TreeProg prog, Leaves leaves, const int* __restrict__ mask, int w4,
                     uint4* __restrict__ out) {
  const int s = blockIdx.y;
  const size_t shard_off = (size_t)s * (size_t)w4;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (mask[s] == 0) {  // unrequested shard: zeros, no reads
    for (int i = first; i < w4; i += stride) out[shard_off + i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  if (kChain) {
    for (int i = first; i < w4; i += kChainUnroll * stride) {
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
        if (i + u * stride < w4) out[shard_off + i + u * stride] = acc[u];
    }
  } else {
    for (int i = first; i < w4; i += stride)
      out[shard_off + i] = eval_tree<kRanges>(prog, leaves, shard_off + i);
  }
}

}  // namespace

// The tree's arguments as in count_tree_dense (host arrays; each leaf
// pointer the [S, W] words of one row, or a pool's slot 0 beside its slot
// vector).  mask: device int32[S].  out: device int32[S, W], every word
// written.  Returns the cudaError_t of the launch.
extern "C" int eval_tree(const void* const* leaf_ptrs, int n_leaves, const void* ranges,
                         const int* range_rows, int n_ranges, const int* ops, int n_ops,
                         const void* mask, int n_shards, int words, void* out, void* stream) {
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
                    ? (extra ? eval_tree_kernel<true, true> : eval_tree_kernel<true, false>)
                    : (extra ? eval_tree_kernel<false, true> : eval_tree_kernel<false, false>);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(prog, leaves, (const int*)mask, w4,
                                                        (uint4*)out);
  return (int)cudaGetLastError();
}
