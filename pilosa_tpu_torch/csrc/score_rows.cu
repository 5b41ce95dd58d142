// K3 score_rows: TopN candidate scoring against a masked src tree, per shard.
//
//   score[k, s] = popcount(cand_rows[cand_idx[k], s] & tree(s) & mask[s])
//
// Replaces the XLA programs pilosa_tpu/parallel/kernels.py:227 score_rows,
// :316 topn_tree and :346 topn_full_tree (the phase-1 scores, the src
// counts, and the gated per-candidate totals), and, through the
// and_popcount_rows entry, the Pallas kernel scripts/pallas_vs_xla.py:56
// matrix_and_popcount_pallas (counts[r] = popcount(matrix[r] & row): one
// shard, the src a single row, the candidates every row of the matrix).
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
// unrequested shard returns before it reads anything (its outputs were
// zeroed by the caller).
//
// When the block owns the whole (shard, group) (grid z = 1) its sums are the
// finished scores: it stores them and, for TopN's totals, applies the gate
// cnt[k, s] >= thr && score >= thr to each and adds the gated score into
// totals[k] with one 64-bit atomic.  When there are too few (shard, group)
// pairs to fill the card (one shard, as the and_popcount_rows entry has),
// the launcher splits the words into grid-z chunks whose partial sums are
// added atomically; it never splits a launch that asks for gated totals,
// since a gate on a partial sum would be wrong.
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;     // candidates per block
constexpr int kMaxChunks = 32;  // word chunks per (shard, group), at most

template <bool kChain>
__global__ void __launch_bounds__(kThreads)
    score_rows_kernel(TreeProg prog, Leaves leaves, const int* __restrict__ mask,
                      const uint4* __restrict__ cand_base,
                      const int* __restrict__ cand_idx, int n_cands,
                      int n_shards, int w4, int* __restrict__ scores,
                      int* __restrict__ src_counts, const int* __restrict__ cnt,
                      int thr, unsigned long long* __restrict__ totals) {
  const int s = blockIdx.y;
  if (mask != nullptr && mask[s] == 0) return;  // unrequested: no reads
  const int k0 = blockIdx.x * kGroup;
  const int n_here = min(kGroup, n_cands - k0);
  const size_t shard_off = (size_t)s * (size_t)w4;
  const size_t row_stride = (size_t)n_shards * (size_t)w4;
  const uint4* cand[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int k = k0 + (u < n_here ? u : 0);
    const int r = cand_idx != nullptr ? cand_idx[k] : k;
    cand[u] = cand_base + (size_t)r * row_stride + shard_off;
  }
  const int chunks = gridDim.z;
  const int begin = (int)((long long)w4 * blockIdx.z / chunks);
  const int end = (int)((long long)w4 * (blockIdx.z + 1) / chunks);

  unsigned int acc[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) acc[u] = 0u;
  unsigned int src_acc = 0u;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const size_t off = shard_off + i;
    uint4 v;
    if (kChain)
      eval_chain<1>(prog, leaves, &off, &v);
    else
      v = eval_tree(prog, leaves, off);
    src_acc += popc4(v);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (u < n_here) {
        const uint4 c = __ldg(cand[u] + i);
        acc[u] += popc4(make_uint4(c.x & v.x, c.y & v.y, c.z & v.z, c.w & v.w));
      }
    }
  }

  // Block reduction of the kGroup candidate sums and the src sum.
  __shared__ unsigned int part[kGroup + 1][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u <= kGroup; ++u) {
    unsigned int x = u < kGroup ? acc[u] : src_acc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) part[u][warp] = x;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t > kGroup) return;
  unsigned int sum = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += part[t][w];
  if (t == kGroup) {  // the src count, once per shard (the first group)
    if (src_counts != nullptr && blockIdx.x == 0 && sum) {
      if (chunks == 1)
        src_counts[s] = (int)sum;
      else
        atomicAdd(src_counts + s, (int)sum);
    }
    return;
  }
  if (t >= n_here) return;
  const int k = k0 + t;
  if (scores != nullptr && sum) {
    int* dst = scores + (size_t)k * n_shards + s;
    if (chunks == 1)
      *dst = (int)sum;
    else
      atomicAdd(dst, (int)sum);
  }
  // chunks == 1 here: the launcher never splits a totals launch.
  if (totals != nullptr && cnt[(size_t)k * n_shards + s] >= thr &&
      (int)sum >= thr && sum)
    atomicAdd(totals + k, (unsigned long long)sum);
}

int n_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
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
  // card, never below one vector per thread, and never for gated totals.
  int chunks = 1;
  if (totals == nullptr) {
    const long long want = 2LL * n_sms();
    while ((long long)groups * n_shards * chunks < want &&
           chunks < kMaxChunks && w4 / (2 * chunks) >= kThreads)
      chunks *= 2;
  }
  const dim3 grid(groups, n_shards, chunks);
  if (is_chain(ops, n_ops))
    score_rows_kernel<true><<<grid, kThreads, 0, stream>>>(
        prog, leaves, mask, cand_base, cand_idx, n_cands, n_shards, w4, scores,
        src_counts, cnt, thr, totals);
  else
    score_rows_kernel<false><<<grid, kThreads, 0, stream>>>(
        prog, leaves, mask, cand_base, cand_idx, n_cands, n_shards, w4, scores,
        src_counts, cnt, thr, totals);
  return (int)cudaGetLastError();
}

}  // namespace

// leaf_ptrs/ops: the src tree as in count_tree_dense (host arrays; each
// leaf pointer the [S, W] words of one row).  mask: device int32[S], or
// null for every shard.  cand_base: device int32[R, S, W] field stack;
// cand_idx: device int32[K] stack rows of the candidates, or null for rows
// 0..K-1.  Outputs, each optional (null) and zeroed by the caller: scores
// int32[K, S], src_counts int32[S], totals uint64[K] (gated by cnt int32[K,
// S] >= thr and score >= thr).  Returns the cudaError_t of the launch.
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

// The P2 entry: out[r] = popcount(matrix[r] & row) for every row of a
// device int32[n_rows, words] matrix against a device int32[words] row.
// out: device int32[n_rows], zeroed by the caller.
extern "C" int and_popcount_rows(const void* matrix, const void* row,
                                 int n_rows, int words, void* out,
                                 void* stream) {
  const int ops[1] = {OP_LEAF};
  const void* leaf[1] = {row};
  TreeProg prog;
  Leaves leaves;
  if (row == nullptr || !pack_args(leaf, 1, ops, 1, &prog, &leaves))
    return (int)cudaErrorInvalidValue;
  return launch(prog, leaves, ops, 1, nullptr, (const uint4*)matrix, nullptr,
                n_rows, 1, words, (int*)out, nullptr, nullptr, 0, nullptr,
                (cudaStream_t)stream);
}
