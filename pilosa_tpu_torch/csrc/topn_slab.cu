// K9 topn_slab: TopN's per-shard slab, the closed form of fragment.top's
// heap walk run for every shard of a cluster node on the card.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:396 topn_slab_tree
// (no Pallas kernel): the slab lane of a cluster's TopN, which serves a
// peer's phase 1 and the coordinator's own shards once one shard is remote.
//
// For each shard s, over K_pad candidate rows (id-descending, K_pad a power
// of two <= 4096) with the shard's ranked-cache counts cnt[k, s] (0 where a
// candidate is absent from that shard's cache) and a threshold thr >= 1:
//
//   score[k]  = popcount(cand_rows[cand_idx[k], s] & tree(s) & mask[s])
//   g[k]      = score[k] if cnt[k, s] >= thr and score[k] >= thr, else 0
//   walk      = the candidates by (cnt desc, position asc): the stable
//               argsort of -cnt, the heap walk's (count desc, id desc)
//   T         = the least g among the first n_sel qualifiers (g > 0) of the
//               walk, or thr when fewer than n_sel qualify (or n_sel = 0)
//   keep[k]   = g[k] >= T;  qual[s] = sum(keep)
//   vals, idx = the first k_out of (keep ? g : 0) by (value desc, position
//               asc): jax.lax.top_k's order, lower index first on ties
//
// Bound: device-memory bytes.  Each requested (candidate, shard) row is
// 128 KiB read once, plus the src tree's leaf rows: (16 + 1) x 640 x 128 KiB
// = 1.43 GB for a cluster node's TopN(top, Row(f=a), n=5) over its 640
// shards, 0.43 ms at 3.35 TB/s.  The selection reads K_pad pairs a shard
// and sorts them twice in shared memory: 2 x 78 bitonic steps over 4096 keys
// at K_pad = 4096, integer operations far below the scores' bytes except on
// small launches.
//
// Design: two launches on the current stream.
//
// (a) topn_slab_scores_kernel, a grid of (candidate group, shard) blocks of
// kThreads: the threads walk the shard's words as 16-byte vectors, the src
// tree evaluated once per position (tree_eval.cuh, as K3 does) and shared
// in registers by the group's kGroup candidates, whose rows are read by
// index from the resident field stack.  The block sums its counts
// (reduce.cuh) and stores scores int32[K_pad, S] whole; an unrequested
// shard reads nothing and stores zeros.
//
// (b) topn_slab_select_kernel, one CTA of kSelThreads a shard: it packs
// each candidate into one 64-bit key, (cnt << 34) | ((8191 - k) << 21) | g,
// whose unsigned descending order is the walk order and which carries g in
// its low 21 bits (a score is at most 2^20), and bitonic-sorts the K_pad
// keys in shared memory.  A block scan over the sorted keys gives each
// qualifier its rank; the least g of ranks 1..n_sel is T.  Each thread then
// rewrites its keys in place as ((keep ? g : 0) << 13) | (8191 - k), one
// more bitonic sort orders them by (value desc, position asc), and the
// first k_out are the slab.  32 KiB of keys at K_pad = 4096.
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;      // (a): threads a block
constexpr int kGroup = 16;         // (a): candidates a block
constexpr int kSelThreads = 1024;  // (b): threads a shard's block
constexpr int kMaxCands = 4096;    // K_pad at most (the engine's MAX_TOPN_CANDIDATES)

template <bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads, 2)
    topn_slab_scores_kernel(TreeProg prog, Leaves leaves, const int* __restrict__ mask,
                            const uint4* __restrict__ cand_base,
                            const int* __restrict__ cand_idx, int n_cands, int n_shards,
                            int w4, int* __restrict__ scores) {
  const int s = blockIdx.y;
  const int k0 = blockIdx.x * kGroup;
  const int n_here = min(kGroup, n_cands - k0);
  const int t = threadIdx.x;
  if (mask[s] == 0) {  // unrequested: no reads, zero scores
    if (t < n_here) scores[(size_t)(k0 + t) * n_shards + s] = 0;
    return;
  }
  const size_t shard_off = (size_t)s * (size_t)w4;
  const size_t row_stride = (size_t)n_shards * (size_t)w4;
  const uint4* cand[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int k = k0 + (u < n_here ? u : 0);
    cand[u] = cand_base + (size_t)cand_idx[k] * row_stride + shard_off;
  }
  unsigned int acc[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) acc[u] = 0u;
  for (int i = t; i < w4; i += kThreads) {
    const size_t off = shard_off + i;
    uint4 v;
    if (kChain)
      eval_chain<1, kRanges, kRanges>(prog, leaves, &off, &v);
    else
      v = eval_tree<kRanges, kRanges>(prog, leaves, off);
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (u < n_here) acc[u] += popc4(and4(__ldg(cand[u] + i), v));
  }
  const unsigned int sum = cluster_sum<kGroup, kThreads>(acc, 0, 1);
  if (t < n_here) scores[(size_t)(k0 + t) * n_shards + s] = (int)sum;
}

// Sort keys[0..P) descending (P a power of two), the whole block.
__device__ void bitonic_desc(unsigned long long* keys, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          const bool desc = (i & k) == 0;
          if (desc ? a < b : a > b) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
    topn_slab_select_kernel(const int* __restrict__ scores, const int* __restrict__ cnt,
                            int n_cands, int n_shards, int thr, int n_sel, int k_out,
                            int* __restrict__ vals, int* __restrict__ idx,
                            int* __restrict__ qual) {
  __shared__ unsigned long long keys[kMaxCands];
  __shared__ int warp_part[kSelThreads / 32];
  __shared__ int warp_min[kSelThreads / 32];
  __shared__ int block_t;
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  constexpr int kWarps = kSelThreads / 32;
  const unsigned long long kG = (1ull << 21) - 1ull;

  // The walk keys: (cnt desc, position asc), g riding in the low bits.
  for (int k = t; k < n_cands; k += kSelThreads) {
    const int sc = scores[(size_t)k * n_shards + s];
    const int c = cnt[(size_t)k * n_shards + s];
    const unsigned long long g = (c >= thr && sc >= thr) ? (unsigned long long)sc : 0ull;
    const unsigned long long cc = (unsigned long long)min(max(c, 0), (1 << 21) - 1);
    keys[k] = (cc << 34) | ((unsigned long long)(8191 - k) << 21) | (g & kG);
  }
  __syncthreads();
  bitonic_desc(keys, n_cands);

  // Each thread takes a run of `per` consecutive walk positions: its
  // qualifier count, then the block's exclusive scan of the counts.
  const int per = (n_cands + kSelThreads - 1) / kSelThreads;
  const int first = t * per;
  const int last = min(first + per, n_cands);
  int mine = 0;
  for (int p = first; p < last; ++p) mine += (keys[p] & kG) != 0ull;
  int x = mine;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_part[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_part[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int n_qual = warp_part[kWarps - 1];
  int rank = x - mine + (warp > 0 ? warp_part[warp - 1] : 0);  // qualifiers before `first`
  int least = 0x7fffffff;
  for (int p = first; p < last; ++p) {
    const int g = (int)(keys[p] & kG);
    if (g == 0) continue;
    ++rank;
    if (rank <= n_sel) least = min(least, g);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) least = min(least, __shfl_down_sync(0xffffffffu, least, o));
  if (lane == 0) warp_min[warp] = least;
  __syncthreads();
  if (t == 0) {
    int m = 0x7fffffff;
    for (int w = 0; w < kWarps; ++w) m = min(m, warp_min[w]);
    block_t = (n_sel > 0 && n_qual >= n_sel) ? m : thr;
  }
  __syncthreads();
  const int T = block_t;

  // The slab keys in place: (value desc, position asc), kept scores only.
  int kept = 0;
  for (int p = t; p < n_cands; p += kSelThreads) {
    const unsigned long long key = keys[p];
    const int g = (int)(key & kG);
    const unsigned long long k = 8191ull - ((key >> 21) & 8191ull);
    const bool keep = g > 0 && g >= T;
    kept += keep;
    keys[p] = ((unsigned long long)(keep ? g : 0) << 13) | (8191ull - k);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, o);
  __syncthreads();  // the rewrite is done before the sort reads; warp_part is free
  if (lane == 0) warp_part[warp] = kept;
  bitonic_desc(keys, n_cands);  // its barriers publish warp_part too
  if (t == 0) {
    int q = 0;
    for (int w = 0; w < kWarps; ++w) q += warp_part[w];
    qual[s] = q;
  }
  for (int r = t; r < k_out; r += kSelThreads) {
    const unsigned long long key = keys[r];
    vals[(size_t)s * k_out + r] = (int)(key >> 13);
    idx[(size_t)s * k_out + r] = 8191 - (int)(key & 8191ull);
  }
}

}  // namespace

// leaf_ptrs/ranges/ops: the src tree as in count_tree_dense (host arrays).
// mask: device int32[S].  cand_base: device int32[R, S, W] field stack;
// cand_idx: device int32[K_pad] stack rows of the candidates (id-descending,
// K_pad a power of two, 8 <= K_pad <= 4096).  cnt: device int32[K_pad, S]
// ranked-cache counts.  thr >= 1; 0 <= n_sel; 1 <= k_out <= K_pad.
// scores: device int32[K_pad, S] scratch, every entry written.  Outputs:
// vals and idx int32[S, k_out], qual int32[S].  Two launches on `stream`;
// returns the cudaError_t of the launches.
extern "C" int topn_slab(const void* const* leaf_ptrs, int n_leaves, const void* ranges,
                         const int* range_rows, int n_ranges, const int* ops, int n_ops,
                         const void* mask, const void* cand_base, const void* cand_idx,
                         int n_cands, int n_shards, int words, const void* cnt, int thr,
                         int n_sel, int k_out, void* scores, void* vals, void* idx,
                         void* qual, void* stream) {
  TreeProg prog;
  Leaves leaves;
  if (!pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops, &prog,
                 &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (words <= 0 || words % 4 != 0 || n_cands < 8 || n_cands > kMaxCands ||
      (n_cands & (n_cands - 1)) != 0 || n_shards < 1 || n_shards > 65535 ||
      cand_base == nullptr || mask == nullptr || cand_idx == nullptr || cnt == nullptr ||
      thr < 1 || n_sel < 0 || k_out < 1 || k_out > n_cands)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool ranged = has_extra_leaves(ops, n_ops, n_ranges);
  const bool chain = is_chain(ops, n_ops);
  auto kernel = chain ? (ranged ? topn_slab_scores_kernel<true, true>
                                : topn_slab_scores_kernel<true, false>)
                      : (ranged ? topn_slab_scores_kernel<false, true>
                                : topn_slab_scores_kernel<false, false>);
  const int groups = (n_cands + kGroup - 1) / kGroup;
  kernel<<<dim3(groups, n_shards), kThreads, 0, st>>>(
      prog, leaves, (const int*)mask, (const uint4*)cand_base, (const int*)cand_idx, n_cands,
      n_shards, words / 4, (int*)scores);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topn_slab_select_kernel<<<n_shards, kSelThreads, 0, st>>>(
      (const int*)scores, (const int*)cnt, n_cands, n_shards, thr, n_sel, k_out, (int*)vals,
      (int*)idx, (int*)qual);
  return (int)cudaGetLastError();
}
