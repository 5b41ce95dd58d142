// K3 score_rows: TopN candidate scoring against a masked src tree, per shard.
//
//   score[k, s] = popcount(cand_rows[cand_idx[k], s] & tree(s) & mask[s])
//
// Replaces the XLA programs pilosa_tpu/parallel/kernels.py:227 score_rows,
// :316 topn_tree and :346 topn_full_tree (the phase-1 scores, the src
// counts, and the gated per-candidate totals).  (The Pallas kernel
// scripts/pallas_vs_xla.py:56, one shard against a single src row, has its
// own kernel, P2, in and_popcount_rows.cu.)
//
// Bound: device-memory bytes.  Each requested (candidate, shard) row is
// 128 KiB read once, plus the src tree's leaf rows (16 * 960 * 128 KiB +
// 960 * 128 KiB = 2.14 GB for TopN(top, Row(f=10), n=5) over 960 shards,
// about 0.64 ms at 3.35 TB/s); the AND, popcount and add are three integer
// instructions per word and candidate, far below the card's integer rate.
//
// Design.  A block owns one shard and a group of up to kGroup candidates.
// Its threads walk the shard's words as 16-byte vectors: at each position
// the src tree is evaluated once (tree_eval.cuh) and shared in registers by
// every candidate of the group, whose rows are read by index straight from
// the resident field stack, so no [K, S, W] gather is ever written and each
// src word is read once per candidate group, not once per candidate.  The
// block reduces its kGroup counts with warp shuffles and shared memory.  An
// unrequested shard reads nothing and stores zero scores and src count.
//
// When there are too few (shard, group) pairs to fill the card (a handful
// of shards), the launcher splits the words into grid-z chunks of at most
// kMaxChunks, launched as one thread-block cluster per (shard, group): the
// cluster's rank 0 sums the chunks' partial counts through distributed
// shared memory.  Either way the sums are finished before anything is
// stored: scores and src counts are stored whole (zeros included), with no
// atomics and no zeroed buffer; for TopN's totals the block applies the
// gate cnt[k, s] >= thr && score >= thr to each finished score and adds the
// gated score into totals[k] (summed over shards: zeroed by the caller)
// with one 64-bit atomic.
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;     // candidates per block
constexpr int kMaxChunks = 8;   // word chunks per (shard, group): a cluster

template <bool kChain>
__global__ void __launch_bounds__(kThreads)
    score_rows_kernel(TreeProg prog, Leaves leaves, const int* __restrict__ mask,
                      const uint4* __restrict__ cand_base,
                      const int* __restrict__ cand_idx, int n_cands,
                      int n_shards, int w4, int* __restrict__ scores,
                      int* __restrict__ src_counts, const int* __restrict__ cnt,
                      int thr, unsigned long long* __restrict__ totals) {
  const int s = blockIdx.y;
  const int k0 = blockIdx.x * kGroup;
  const int n_here = min(kGroup, n_cands - k0);
  const int chunks = gridDim.z;
  const int chunk = blockIdx.z;  // the block's rank in its cluster
  if (mask != nullptr && mask[s] == 0) {  // unrequested: no reads, zeros
    if (chunk == 0) {                     // (the whole cluster returns here)
      if (scores != nullptr && (int)threadIdx.x < n_here)
        scores[(size_t)(k0 + threadIdx.x) * n_shards + s] = 0;
      if (src_counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        src_counts[s] = 0;
    }
    return;
  }
  const size_t shard_off = (size_t)s * (size_t)w4;
  const size_t row_stride = (size_t)n_shards * (size_t)w4;
  const uint4* cand[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int k = k0 + (u < n_here ? u : 0);
    const int r = cand_idx != nullptr ? cand_idx[k] : k;
    cand[u] = cand_base + (size_t)r * row_stride + shard_off;
  }
  const int begin = (int)((long long)w4 * chunk / chunks);
  const int end = (int)((long long)w4 * (chunk + 1) / chunks);

  unsigned int acc[kGroup + 1];  // the candidates' counts, then the src's
#pragma unroll
  for (int u = 0; u <= kGroup; ++u) acc[u] = 0u;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const size_t off = shard_off + i;
    uint4 v;
    if (kChain)
      eval_chain<1>(prog, leaves, &off, &v);
    else
      v = eval_tree(prog, leaves, off);
    acc[kGroup] += popc4(v);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (u < n_here) {
        const uint4 c = __ldg(cand[u] + i);
        acc[u] += popc4(make_uint4(c.x & v.x, c.y & v.y, c.z & v.z, c.w & v.w));
      }
    }
  }

  // The kGroup candidate sums and the src sum over the block, then over a
  // split launch's cluster (reduce.cuh).
  const unsigned int sum = cluster_sum<kGroup + 1, kThreads>(acc, chunk, chunks);
  const int t = threadIdx.x;
  if (chunk != 0 || t > kGroup) return;
  if (t == kGroup) {  // the src count, once per shard (the first group)
    if (src_counts != nullptr && blockIdx.x == 0) src_counts[s] = (int)sum;
    return;
  }
  if (t >= n_here) return;
  const int k = k0 + t;
  if (scores != nullptr) scores[(size_t)k * n_shards + s] = (int)sum;
  if (totals != nullptr && sum && cnt[(size_t)k * n_shards + s] >= thr &&
      (int)sum >= thr)
    atomicAdd(totals + k, (unsigned long long)sum);
}

int launch(const TreeProg& prog, const Leaves& leaves, const int* ops,
           int n_ops, const int* mask, const uint4* cand_base,
           const int* cand_idx, int n_cands, int n_shards, int words,
           int* scores, int* src_counts, const int* cnt, int thr,
           unsigned long long* totals, cudaStream_t stream) {
  if (words <= 0 || words % 4 != 0 || n_cands < 0 || n_shards < 0 ||
      n_shards > 65535 || cand_base == nullptr)
    return (int)cudaErrorInvalidValue;
  if (totals != nullptr && cnt == nullptr) return (int)cudaErrorInvalidValue;
  if (n_cands == 0 || n_shards == 0) return (int)cudaSuccess;
  const int w4 = words / 4;
  const int groups = (n_cands + kGroup - 1) / kGroup;
  // Split the words only where the (shard, group) blocks cannot fill the
  // card, and never below one vector per thread.
  int chunks = 1;
  const long long want = 2LL * n_sms();
  while ((long long)groups * n_shards * chunks < want && chunks < kMaxChunks &&
         w4 / (2 * chunks) >= kThreads)
    chunks *= 2;
  const bool chain = is_chain(ops, n_ops);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, n_shards, chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)chunks;
  cfg.attrs = attr;
  cfg.numAttrs = chunks > 1 ? 1 : 0;
  const cudaError_t err =
      chain ? cudaLaunchKernelEx(&cfg, score_rows_kernel<true>, prog, leaves, mask,
                                 cand_base, cand_idx, n_cands, n_shards, w4,
                                 scores, src_counts, cnt, thr, totals)
            : cudaLaunchKernelEx(&cfg, score_rows_kernel<false>, prog, leaves,
                                 mask, cand_base, cand_idx, n_cands, n_shards,
                                 w4, scores, src_counts, cnt, thr, totals);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// leaf_ptrs/ops: the src tree as in count_tree_dense (host arrays; each
// leaf pointer the [S, W] words of one row).  mask: device int32[S], or
// null for every shard.  cand_base: device int32[R, S, W] field stack;
// cand_idx: device int32[K] stack rows of the candidates, or null for rows
// 0..K-1.  Outputs, each optional (null): scores int32[K, S] and src_counts
// int32[S], every entry written by the kernel; totals uint64[K], zeroed by
// the caller (gated by cnt int32[K, S] >= thr and score >= thr).  Returns
// the cudaError_t of the launch.
extern "C" int score_rows(const void* const* leaf_ptrs, int n_leaves,
                          const int* ops, int n_ops, const void* mask,
                          const void* cand_base, const void* cand_idx,
                          int n_cands, int n_shards, int words, void* scores,
                          void* src_counts, const void* cnt, int thr,
                          void* totals, void* stream) {
  TreeProg prog;
  Leaves leaves;
  if (!pack_args(leaf_ptrs, n_leaves, ops, n_ops, &prog, &leaves))
    return (int)cudaErrorInvalidValue;
  return launch(prog, leaves, ops, n_ops, (const int*)mask,
                (const uint4*)cand_base, (const int*)cand_idx, n_cands,
                n_shards, words, (int*)scores, (int*)src_counts,
                (const int*)cnt, thr, (unsigned long long*)totals,
                (cudaStream_t)stream);
}
