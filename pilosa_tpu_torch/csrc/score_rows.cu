// K3 score_rows: TopN candidate scoring against a masked src tree, per shard,
// and the whole fused TopN (gates, totals and the top-n trim) in one launch.
//
//   score[k, s] = popcount(cand_rows[cand_idx[k], s] & tree(s) & mask[s])
//
// Replaces the XLA programs pilosa_tpu/parallel/kernels.py:227 score_rows,
// :316 topn_tree and :346 topn_full_tree (the phase-1 scores, the src
// counts, the gated per-candidate totals and the trim, jax.lax.top_k at
// :382).  (The Pallas kernel scripts/pallas_vs_xla.py:56, one shard against
// a single src row, has its own kernel, P2, in and_popcount_rows.cu.)
//
// Bound: device-memory bytes.  Each requested (candidate, shard) row is
// 128 KiB read once, plus the src tree's leaf rows (16 * 960 * 128 KiB +
// 960 * 128 KiB = 2.14 GB for TopN(top, Row(f=10), n=5) over 960 shards,
// about 0.64 ms at 3.35 TB/s); the AND, popcount and add are three integer
// instructions per word and candidate, far below the card's integer rate.
// The trim reads K totals and writes n_out pairs: bytes too few to matter.
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
// atomics and no zeroed buffer.
//
// TopN's totals (cnt given) never leave the launch half-done.  Each rank-0
// block applies the gate cnt[k, s] >= thr && score >= thr to its finished
// scores and adds the gated ones into a scratch accumulator of kMaxCands
// int64 totals (one 64-bit atomic each), then arrives on a counter in the
// same scratch, masked shards and idle threads included.  The block that
// sees every other arrival holds the whole totals: it copies them out, or
// orders them (value descending, the lower index first on ties:
// jax.lax.top_k's order, and with candidates id-descending the reference's
// (-count, -id) pair order) and writes the top n_out as one int32[2, n_out]
// (vals, idx); then it leaves the totals and the counter at zero for the
// next launch.  So a full TopN of up to kThreads candidates is one launch,
// with no fill before it and no trim launch after it; past that, one more
// launch of one block sorts the totals.
//
// The trim sorts.  Each total and its index pack into one 64-bit key whose
// unsigned order is the trim's order (the total, at most S * 2^20 < 2^36,
// above 13 bits of 8191 - index; 0 pads), and a bitonic network sorts the
// P keys (P, the next power of two >= K) descending, each step a
// compare-exchange of the key at i with the one at i ^ j.  Up to kThreads
// candidates (the main path's K = 16) the last block sorts them itself,
// one key a thread: steps of j < 32 exchange through __shfl_xor_sync, the
// rest through a 2 KiB shared tile (the shared memory the rank by counting
// it replaced used).  Past kThreads the last block leaves the totals in
// the scratch and score_rows_trim_kernel, one block launched right after
// K3 on its stream, sorts them: thread t holds keys t * kTrimPer ..
// t * kTrimPer + kTrimPer - 1 in registers, so a step of j below kTrimPer
// swaps registers, one below 32 * kTrimPer exchanges them between lanes,
// and only the steps past that (j = 512, 1024, 2048: six of the 78 steps
// at K = 4096) go through 34 KiB of shared memory, one block barrier on
// each side.  (The trim ranked by counting before, K^2 comparisons in one
// block: 1.67 ms at K = 4096.)
//
// K3 is bounded to two CTAs of kThreads per SM (__launch_bounds__), the
// occupancy its registers gave it anyway: the bound lets ptxas take up to
// 128 registers and keep more of a group's candidate loads in flight.
// Without it, edits to the last block's code alone moved those loads
// (fewer of them in flight) and slowed the main loop on an H100.
// The wrapper keeps one scratch per (device, stream), so launches that
// share one run one after another.
//
// K3P (score_rows_pool): K3 for a src tree with pool leaves, the TopN over
// a field whose src rows are only partly resident (a block pool,
// tree_eval.cuh load_pool).  Such a tree can be non-zero only in the
// blocks of its live word, the same for every shard (tree_eval.cuh
// block_live), so no other position can add to a score or the src count.
// Bound: device-memory bytes, the src leaves and the K candidate rows read
// at the live blocks only: (1 + 4) rows x 8 live blocks x 960 shards x
// 2 KiB = 78.6 MB, 0.0235 ms at 3.35 TB/s, for the residency sweep's
// TopN(rt, Row(wf1=2), n=3), where K3 reads the candidate rows whole
// (503 MB).  Design: K3's grid, cluster split, stores, totals and trim;
// each block first lists the live blocks in shared memory (tree_eval.cuh
// live_block_list: 64 threads, two ballots), then walks their n_live * 128
// uint4 positions in place of the row's 8192, the src evaluated and every
// candidate of the group read at the same offsets.  At 8 live blocks a
// thread has 4 positions, so latency, not bytes, decides: K3P takes
// kGroupPool = 8 candidates a block (K3: 16), which leaves registers for
// kUnrollPool = 2 positions a thread in flight at once, 18 loads, under
// the same bound of two CTAs an SM.  (K3's shape, 16 candidates and one
// position, ran at a third of the bound there; 8 with two positions,
// about twice as fast, also beat K3 over a full live word.)  A live word
// of 0 walks nothing: zero scores and src count, stored, and the block
// still arrives on the totals counter.  K3 itself is the same code with
// the walk over every position (score_rows_body's kLive false).
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;       // candidates per block
constexpr int kMaxChunks = 8;    // word chunks per (shard, group): a cluster
constexpr int kMaxCands = 4096;  // totals the scratch holds (int64 each)
constexpr int kTrimPer = kMaxCands / kThreads;  // the trim kernel's keys a thread: 16

// Where a launch's totals go: the scratch (kMaxCands int64 totals, then a
// 32-bit arrival counter in the next int64), and the finished result.
struct Totals {
  const int* cnt;                // int32[K, S] row counts: the gate
  int thr;
  unsigned long long* acc;       // scratch: int64[kMaxCands], 0 between launches
  unsigned int* arrivals;        // scratch: after acc, 0 between launches
  int n_out;                     // 0: copy the totals to `all`
  int* trimmed;                  // int32[2, n_out]: vals, then idx
  long long* all;                // int64[K]
};

// The trim's sort key of candidate i with total v (module comment).
__device__ __forceinline__ unsigned long long trim_key(unsigned long long v, int i) {
  return (v << 13) | (unsigned long long)(8191 - i);
}

// One bitonic step for the key `a` at position i against its partner's
// `b` (position i ^ j) in the merge of width k: the lower position of a
// pair keeps the larger key where the k-run sorts descending (i & k == 0),
// the smaller one elsewhere.
__device__ __forceinline__ unsigned long long bitonic_pick(unsigned long long a,
                                                           unsigned long long b,
                                                           int i, int j, int k) {
  const bool keep_larger = ((i & j) == 0) == ((i & k) == 0);
  return keep_larger ? (a > b ? a : b) : (a < b ? a : b);
}

// Called by every thread of each rank-0 block once its gated adds are
// issued: arrive, and in the block that arrives last, finish the totals:
// copy them out, or trim up to kThreads of them (one key a thread), or,
// past kThreads, leave them in the scratch for score_rows_trim_kernel.
__device__ void finish_totals(const Totals& t, int n_cands,
                              unsigned int expected) {
  __shared__ unsigned long long tile[kThreads];
  __shared__ bool last;
  __threadfence();  // this block's adds, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(t.arrivals, 1u) == expected - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other block's adds, before the reads below
  const int tid = threadIdx.x;
  if (tid == 0) *t.arrivals = 0u;
  if (t.n_out > 0 && n_cands > kThreads) return;  // score_rows_trim_kernel's
  if (t.n_out == 0) {
    for (int i = tid; i < n_cands; i += kThreads) {
      t.all[i] = (long long)__ldcg(t.acc + i);
      t.acc[i] = 0ull;
    }
    return;
  }
  int P = 1;
  while (P < n_cands) P <<= 1;
  unsigned long long key = tid < n_cands ? trim_key(__ldcg(t.acc + tid), tid) : 0ull;
  if (tid < n_cands) t.acc[tid] = 0ull;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {  // partner in another warp: through shared memory
        tile[tid] = key;
        __syncthreads();
        other = tile[tid ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      key = bitonic_pick(key, other, tid, j, k);
    }
  }
  if (tid < t.n_out) {
    t.trimmed[tid] = (int)(key >> 13);
    t.trimmed[t.n_out + tid] = 8191 - (int)(key & 8191ull);
  }
}

// The trim, one block launched right after K3 on its stream: sort the K
// totals of the scratch as trim keys, descending, write the first n_out
// as (vals, idx), and leave the scratch at zero.
__global__ void __launch_bounds__(kThreads)
    score_rows_trim_kernel(Totals t, int n_cands) {
  // The cross-warp steps' keys, key i at i + i / kTrimPer: a warp's
  // threads, kTrimPer keys apart, then fall in different banks (34 KiB).
  __shared__ unsigned long long keys[kMaxCands + kMaxCands / kTrimPer];
  int P = 1;
  while (P < n_cands) P <<= 1;
  const int first = threadIdx.x * kTrimPer;  // this thread's keys: first + u
  unsigned long long key[kTrimPer];
#pragma unroll
  for (int u = 0; u < kTrimPer; ++u) {
    key[u] = 0ull;
    if (first + u < n_cands) {  // read, then leave at zero for the next launch
      key[u] = trim_key(__ldcg(t.acc + first + u), first + u);
      t.acc[first + u] = 0ull;
    }
  }
  for (int k = 2; k <= P; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32 * kTrimPer; j >>= 1) {  // partner in another warp
      __syncthreads();  // the previous step's reads are done
#pragma unroll
      for (int u = 0; u < kTrimPer; ++u) keys[first + threadIdx.x + u] = key[u];
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kTrimPer; ++u) {
        const int i = (first + u) ^ j;
        key[u] = bitonic_pick(key[u], keys[i + i / kTrimPer], first + u, j, k);
      }
    }
    for (; j >= kTrimPer; j >>= 1) {  // partner in another lane of the warp
#pragma unroll
      for (int u = 0; u < kTrimPer; ++u)
        key[u] = bitonic_pick(key[u], __shfl_xor_sync(0xffffffffu, key[u], j / kTrimPer),
                              first + u, j, k);
    }
#pragma unroll
    for (int jj = kTrimPer / 2; jj >= 1; jj >>= 1) {  // partner in this thread
      if (jj > j) continue;
#pragma unroll
      for (int u = 0; u < kTrimPer; ++u) {
        if (u & jj) continue;
        const unsigned long long a = key[u], b = key[u | jj];
        const bool desc = ((first + u) & k) == 0;
        const unsigned long long hi = a > b ? a : b, lo = a > b ? b : a;
        key[u] = desc ? hi : lo;
        key[u | jj] = desc ? lo : hi;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kTrimPer; ++u) {
    const int p = first + u;  // rank p of the trim's order
    if (p < t.n_out) {
      t.trimmed[p] = (int)(key[u] >> 13);
      t.trimmed[t.n_out + p] = 8191 - (int)(key[u] & 8191ull);
    }
  }
}

// K3P's shape (the module comment): candidates per block and positions of
// a thread in flight together.
constexpr int kGroupPool = 8;
constexpr int kUnrollPool = 2;

// The main loop of K3 (kLive false: every position of the shard's row, one
// at a time) and of K3P (kLive true: the positions of the src tree's live
// blocks, tree_eval.cuh live_block_list, kUnrollPool of them a thread at a
// time, each candidate row read at the same offsets).  kG candidates a
// block.  kPools compiles the pool leaf in (kRanges for K3, whose host
// sets it for range and pool leaves alike; always for K3P).
template <int kG, bool kChain, bool kRanges, bool kLive>
__device__ __forceinline__ void score_rows_body(
    const TreeProg& prog, const Leaves& leaves, const int* __restrict__ mask,
    const uint4* __restrict__ cand_base, const int* __restrict__ cand_idx, int n_cands,
    int n_shards, int w4, int* __restrict__ scores, int* __restrict__ src_counts,
    const Totals& totals) {
  constexpr bool kPools = kLive || kRanges;
  const int s = blockIdx.y;
  const int k0 = blockIdx.x * kG;
  const int n_here = min(kG, n_cands - k0);
  const int chunks = gridDim.z;
  const int chunk = blockIdx.z;  // the block's rank in its cluster
  const int t = threadIdx.x;
  const unsigned int expected = gridDim.x * gridDim.y;  // rank-0 blocks
  if (mask != nullptr && mask[s] == 0) {  // unrequested: no reads, zeros
    if (chunk != 0) return;               // (the whole cluster returns here)
    if (scores != nullptr && t < n_here)
      scores[(size_t)(k0 + t) * n_shards + s] = 0;
    if (src_counts != nullptr && blockIdx.x == 0 && t == 0) src_counts[s] = 0;
    if (totals.cnt != nullptr) finish_totals(totals, n_cands, expected);
    return;
  }
  const size_t shard_off = (size_t)s * (size_t)w4;
  const size_t row_stride = (size_t)n_shards * (size_t)w4;
  const uint4* cand[kG];
#pragma unroll
  for (int u = 0; u < kG; ++u) {
    const int k = k0 + (u < n_here ? u : 0);
    const int r = cand_idx != nullptr ? cand_idx[k] : k;
    cand[u] = cand_base + (size_t)r * row_stride + shard_off;
  }
  // K3P walks the n_live * kPoolBlockVec positions of the live blocks, in
  // block order; a live word of 0 walks none, so it reads no leaf and no
  // candidate and stores zeros.
  __shared__ LiveBlocks live;
  const int n_pos = kLive ? live_block_list(prog, leaves, live) * kPoolBlockVec : w4;
  const int begin = (int)((long long)n_pos * chunk / chunks);
  const int end = (int)((long long)n_pos * (chunk + 1) / chunks);

  unsigned int acc[kG + 1];  // the candidates' counts, then the src's
#pragma unroll
  for (int u = 0; u <= kG; ++u) acc[u] = 0u;
  if constexpr (kLive) {
    // A thread takes kUnrollPool positions kThreads apart at a time, their
    // loads in flight together; a position past the chunk's end reads the
    // first one again (from L1) and counts nothing.
    constexpr int U = kUnrollPool;
    for (int i = begin + t; i < end; i += U * kThreads) {
      int pos[U];
      bool in[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int j = i + q * kThreads;
        in[q] = j < end;
        const int jj = in[q] ? j : i;
        pos[q] = live.block[jj / kPoolBlockVec] * kPoolBlockVec + jj % kPoolBlockVec;
      }
      size_t off[U];
#pragma unroll
      for (int q = 0; q < U; ++q) off[q] = shard_off + pos[q];
      uint4 v[U];
      if (kChain) {
        eval_chain<U, kRanges, true>(prog, leaves, off, v);
      } else {
#pragma unroll
        for (int q = 0; q < U; ++q) v[q] = eval_tree<kRanges, true>(prog, leaves, off[q]);
      }
#pragma unroll
      for (int q = 0; q < U; ++q)
        if (!in[q]) v[q] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < U; ++q) acc[kG] += popc4(v[q]);
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        if (u < n_here) {
#pragma unroll
          for (int q = 0; q < U; ++q) acc[u] += popc4(and4(__ldg(cand[u] + pos[q]), v[q]));
        }
      }
    }
  } else {
    for (int i = begin + t; i < end; i += kThreads) {
      const size_t off = shard_off + i;
      uint4 v;
      if (kChain)
        eval_chain<1, kRanges, kPools>(prog, leaves, &off, &v);
      else
        v = eval_tree<kRanges, kPools>(prog, leaves, off);
      acc[kG] += popc4(v);
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        if (u < n_here) {
          const uint4 c = __ldg(cand[u] + i);
          acc[u] += popc4(make_uint4(c.x & v.x, c.y & v.y, c.z & v.z, c.w & v.w));
        }
      }
    }
  }

  // The kG candidate sums and the src sum over the block, then over a
  // split launch's cluster (reduce.cuh).
  const unsigned int sum = cluster_sum<kG + 1, kThreads>(acc, chunk, chunks);
  if (chunk != 0) return;  // the whole block: only rank 0 stores and arrives
  if (t == kG && src_counts != nullptr && blockIdx.x == 0)
    src_counts[s] = (int)sum;  // the src count, once per shard (the first group)
  if (t < n_here) {
    const int k = k0 + t;
    if (scores != nullptr) scores[(size_t)k * n_shards + s] = (int)sum;
    if (totals.cnt != nullptr && sum && (int)sum >= totals.thr &&
        totals.cnt[(size_t)k * n_shards + s] >= totals.thr)
      atomicAdd(totals.acc + k, (unsigned long long)sum);
  }
  if (totals.cnt != nullptr) finish_totals(totals, n_cands, expected);
}

template <bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads, 2)
    score_rows_kernel(TreeProg prog, Leaves leaves, const int* __restrict__ mask,
                      const uint4* __restrict__ cand_base,
                      const int* __restrict__ cand_idx, int n_cands,
                      int n_shards, int w4, int* __restrict__ scores,
                      int* __restrict__ src_counts, Totals totals) {
  score_rows_body<kGroup, kChain, kRanges, false>(prog, leaves, mask, cand_base, cand_idx,
                                                  n_cands, n_shards, w4, scores, src_counts,
                                                  totals);
}

// K3P: K3 over the live blocks of a src tree with pool leaves (w4 is a
// pool row's kPoolRowVec).
template <bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads, 2)
    score_rows_pool_kernel(TreeProg prog, Leaves leaves, const int* __restrict__ mask,
                           const uint4* __restrict__ cand_base,
                           const int* __restrict__ cand_idx, int n_cands,
                           int n_shards, int w4, int* __restrict__ scores,
                           int* __restrict__ src_counts, Totals totals) {
  score_rows_body<kGroupPool, kChain, kRanges, true>(prog, leaves, mask, cand_base, cand_idx,
                                                     n_cands, n_shards, w4, scores, src_counts,
                                                     totals);
}

int launch(const TreeProg& prog, const Leaves& leaves, bool ranges, bool live,
           const int* ops, int n_ops, const int* mask, const uint4* cand_base,
           const int* cand_idx, int n_cands, int n_shards, int words,
           int* scores, int* src_counts, const Totals& totals,
           cudaStream_t stream) {
  if (words <= 0 || words % 4 != 0 || n_cands < 0 || n_shards < 0 ||
      n_shards > 65535 || cand_base == nullptr || (live && words != kPoolRowVec * 4))
    return (int)cudaErrorInvalidValue;
  if (totals.cnt != nullptr &&
      (totals.acc == nullptr || n_cands < 1 || n_cands > kMaxCands ||
       n_shards < 1 || totals.n_out < 0 || totals.n_out > n_cands ||
       (totals.n_out == 0 ? totals.all == nullptr : totals.trimmed == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_cands == 0 || n_shards == 0) return (int)cudaSuccess;
  const int w4 = words / 4;
  const int group = live ? kGroupPool : kGroup;
  const int groups = (n_cands + group - 1) / group;
  // Split the words only where the (shard, group) blocks cannot fill the
  // card, and never below one vector per thread.  K3P splits the same way:
  // the host cannot know the live word without reading the slot table, so
  // it splits as for a full row, the most a live word can hold, and each
  // chunk takes its share of the live positions.  With few live blocks a
  // chunk then leaves threads idle, but a split happens only for a launch
  // too small to fill the card, where the prologue's latency decides.
  int chunks = 1;
  const long long want = 2LL * n_sms();
  while ((long long)groups * n_shards * chunks < want && chunks < kMaxChunks &&
         w4 / (2 * chunks) >= kThreads)
    chunks *= 2;
  const bool chain = is_chain(ops, n_ops);
  auto kernel = live ? (chain ? (ranges ? score_rows_pool_kernel<true, true>
                                        : score_rows_pool_kernel<true, false>)
                              : (ranges ? score_rows_pool_kernel<false, true>
                                        : score_rows_pool_kernel<false, false>))
                     : (chain ? (ranges ? score_rows_kernel<true, true>
                                        : score_rows_kernel<true, false>)
                              : (ranges ? score_rows_kernel<false, true>
                                        : score_rows_kernel<false, false>));
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
      cudaLaunchKernelEx(&cfg, kernel, prog, leaves, mask, cand_base, cand_idx,
                         n_cands, n_shards, w4, scores, src_counts, totals);
  if (err != cudaSuccess) return (int)err;
  if (totals.cnt != nullptr && totals.n_out > 0 && n_cands > kThreads)
    score_rows_trim_kernel<<<1, kThreads, 0, stream>>>(totals, n_cands);
  return (int)cudaGetLastError();
}

int score_rows_entry(bool live, const void* const* leaf_ptrs, int n_leaves,
                     const void* ranges, const int* range_rows, int n_ranges, const int* ops,
                     int n_ops, const void* mask, const void* cand_base, const void* cand_idx,
                     int n_cands, int n_shards, int words, void* scores, void* src_counts,
                     const void* cnt, int thr, void* scratch, int n_out, void* out,
                     void* stream) {
  TreeProg prog;
  Leaves leaves;
  if (!pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops, &prog,
                 &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  Totals totals;
  totals.cnt = (const int*)cnt;
  totals.thr = thr;
  totals.acc = (unsigned long long*)scratch;
  totals.arrivals =
      scratch == nullptr ? nullptr
                         : (unsigned int*)((unsigned long long*)scratch + kMaxCands);
  totals.n_out = n_out;
  totals.trimmed = n_out > 0 ? (int*)out : nullptr;
  totals.all = n_out == 0 ? (long long*)out : nullptr;
  // K3 compiles range and pool leaves in together; K3P always has the
  // pool leaf, and the range leaf only where the tree holds one.
  const bool ranged = live ? n_ranges > 0 : has_extra_leaves(ops, n_ops, n_ranges);
  return launch(prog, leaves, ranged, live, ops, n_ops, (const int*)mask,
                (const uint4*)cand_base, (const int*)cand_idx, n_cands,
                n_shards, words, (int*)scores, (int*)src_counts, totals,
                (cudaStream_t)stream);
}

}  // namespace

// leaf_ptrs/ranges/ops: the src tree as in count_tree_dense (host arrays;
// each leaf pointer the [S, W] words of one row).  mask: device int32[S], or
// null for every shard.  cand_base: device int32[R, S, W] field stack;
// cand_idx: device int32[K] stack rows of the candidates, or null for rows
// 0..K-1.  Outputs, each optional (null): scores int32[K, S] and src_counts
// int32[S], every entry written by the kernel.  TopN's totals, when cnt
// int32[K, S] is given (1 <= K <= 4096, S >= 1): gated by cnt >= thr and
// score >= thr and summed over shards in scratch (device int64[4097], zeroed
// once when allocated and left at 0 by every launch; launches that share it
// must run one after another, on one stream), then written whole to out
// int64[K] when n_out is 0, or trimmed to the top n_out (1 <= n_out <= K) as
// out int32[2, n_out], values then candidate indices, value descending and
// the lower index first on ties.  Returns the cudaError_t of the launch.
extern "C" int score_rows(const void* const* leaf_ptrs, int n_leaves,
                          const void* ranges, const int* range_rows,
                          int n_ranges, const int* ops, int n_ops, const void* mask,
                          const void* cand_base, const void* cand_idx,
                          int n_cands, int n_shards, int words, void* scores,
                          void* src_counts, const void* cnt, int thr,
                          void* scratch, int n_out, void* out, void* stream) {
  return score_rows_entry(false, leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops,
                          n_ops, mask, cand_base, cand_idx, n_cands, n_shards, words, scores,
                          src_counts, cnt, thr, scratch, n_out, out, stream);
}

// K3P: score_rows's arguments and outputs, for a src tree with pool
// leaves; words must be a pool row's full 32768.  Only the src tree's live
// blocks are read, of its leaves and of every candidate row; any tree over
// full-width rows gives score_rows's answer.
extern "C" int score_rows_pool(const void* const* leaf_ptrs, int n_leaves,
                               const void* ranges, const int* range_rows,
                               int n_ranges, const int* ops, int n_ops, const void* mask,
                               const void* cand_base, const void* cand_idx,
                               int n_cands, int n_shards, int words, void* scores,
                               void* src_counts, const void* cnt, int thr,
                               void* scratch, int n_out, void* out, void* stream) {
  return score_rows_entry(true, leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops,
                          n_ops, mask, cand_base, cand_idx, n_cands, n_shards, words, scores,
                          src_counts, cnt, thr, scratch, n_out, out, stream);
}

// The trim alone, over totals the caller passes in (TopN on a
// multi-process mesh, whose totals are summed across ranks on the host
// between K3 and the trim): totals device int64[n_cands], non-negative,
// 1 <= n_cands <= 4096; their top n_out (1 <= n_out <= n_cands) written to
// out int32[2, n_out] as K3's trim writes them, by the same one-block
// score_rows_trim_kernel, which leaves the totals at zero.  Returns the
// cudaError_t of the launch.
extern "C" int score_rows_trim(void* totals, int n_cands, int n_out, void* out,
                               void* stream) {
  if (totals == nullptr || out == nullptr || n_cands < 1 || n_cands > kMaxCands ||
      n_out < 1 || n_out > n_cands)
    return (int)cudaErrorInvalidValue;
  Totals t = {};
  t.acc = (unsigned long long*)totals;
  t.n_out = n_out;
  t.trimmed = (int*)out;
  score_rows_trim_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(t, n_cands);
  return (int)cudaGetLastError();
}
