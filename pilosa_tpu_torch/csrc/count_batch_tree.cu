// K5 count_batch_tree: K Count(tree) queries in one launch.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:255
// count_batch_tree: for each query k, sum(popcount(tree_k(rows) & mask_k))
// over field stacks int32[R, S, W], as int64[K] (the reference sums in
// int32; the two agree below 2^31).  The serving tier drains concurrent
// Counts into one launch and one readback (parallel/batcher.py).
//
// Bound: device-memory bytes.  A batch reads its table of distinct leaf rows
// (parallel/kernels.py compile_batch), each over the shards some query
// reading it requests: distinct rows x requested shards x 128 KiB, plus the
// packed programs.  On the north-star field f (24 distinct rows, 960
// shards) that is 3.02 GB, about 0.90 ms at 3.35 TB/s, whatever K is; K
// launches of K1 would read every query's leaves again.  So the design's
// one rule is that each distinct leaf word is read from device memory once
// per launch, not once per query.
//
// Design.  A CTA of 256 threads takes one shard (blockIdx.y) and strides
// over its tiles of T uint4 positions (blockIdx.x).  It first lists the
// queries whose mask requests its shard and the leaf rows those queries
// read.  Per tile, the CTA stages the tile's words of every listed leaf
// row into shared memory with asynchronous copies, all in flight at once
// (T chosen by the launcher so that the table's tile fits in 64 KiB:
// neighbouring threads copy neighbouring 16-byte words), then its warps
// take (query, chunk) items: a warp evaluates one
// query's postfix program over one chunk of 32 x U positions from shared
// memory (chain programs in registers, U positions per opcode fetch, as
// K1's eval_chain; other trees through the stack interpreter), reduces the
// popcounts with warp shuffles and adds them to the query's shared int32
// counter.  So a leaf row read by many queries costs one load per word and
// many shared-memory reads.  A table too wide to stage (more than 128 rows)
// takes the same loop with loads from device memory (L1 and L2 then give
// whatever reuse the batch has).  At the end each CTA adds its nonzero
// counters into an int64 scratch with one atomic per (CTA, query) and
// arrives on a counter after them; the CTA that arrives last copies the
// totals out (through the fan-out map, when the batch was deduplicated),
// then zeroes the scratch and the counter for the next launch on this
// stream (the K3 pattern), so the output needs no fill.  The programs,
// masks (one bit per shard), leaf row addresses and fan-out live in one
// device buffer the wrapper uploads with one copy.
//
// A BSI range leaf (OP_RANGE) names a record of the batch's range table:
// its condition (kind, depth, predicate bits) and its planes as rows of the
// leaf table, where the host de-duplicated them with every other row
// (parallel/kernels.py compile_batch).  So eight conditions on one field
// stage the field's planes once per tile, and each query walks them from
// shared memory (range_walk, eval_range's walk over staged planes); a
// missing plane (-1) reads as zeros with no load.  The stage's budget
// counts planes as rows: two depth-63 conditions on two fields fill its
// 128 rows, and a wider table takes the direct path.  A batch without a
// range leaf runs the kernel built without them (kRanges false).
//
// A leaf row of a partial stack's block pool (OP_ROWB, tree_eval.cuh) is
// staged through its slot vector: each 2 KiB block of the tile is copied
// from the pool slot the vector names, and a block in slot 0 (empty in
// every shard) is written as zeros with no load.  The programs then read
// the staged tile as they read any leaf row, so a batch of Counts over a
// partial stack is one launch that reads only the occupied blocks.
//
// K5P (count_batch_tree_pool), the same kernel for a batch with pool
// rows, also skips the blocks that no requesting query can read: each CTA
// first forms its shard's live word, the union of the live words of the
// leaf rows its requesting queries read (a pool row live where its slot
// is not 0, a stack row everywhere; from the slot vectors, no host read
// of the slot table; 256 threads, one block and every fourth row each,
// eight ballots), lists the live blocks in shared memory and runs the
// tile loop over live positions, not shard positions: live position i is
// shard position 128 block[i / 128] + i % 128, for the staged copy and
// for the direct path's loads alike.  So the 8-Count query over rows live
// in 8 of 64 blocks stages and evaluates 8 blocks a shard, not 64: 8 rows
// x 8 blocks x 960 shards x 2 KiB = 126 MB, 0.0376 ms at 3.35 TB/s.  The
// first design united the queries' own words (each program evaluated on
// one bit a block): a chain of dependent loads per query in every CTA's
// prologue, 0.0835 ms on that query on an H100, where the rows' words,
// one round trip, give the same 8 blocks.  K5P stages 32 KiB tiles and
// takes one CTA a shard at 960 shards (the launcher says why).  A live
// word of 0 stages nothing and adds nothing, and its CTA still arrives.
// A range leaf's planes are stack rows, live in every block: a shard where
// a query holding one is requested stages every block of the rows they
// read (correct, and no cheaper than K5 there).
#include <cuda_pipeline.h>

#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQueries = 1024;         // parallel/kernels.py BATCH_MAX
constexpr int kMaxLeaves = 4096;          // parallel/kernels.py MAX_BATCH_LEAVES
constexpr long long kStageBytes = 64 * 1024;  // a tile of the leaf table
constexpr int kDirectTile = 1024;         // uint4 per tile when not staged

struct Batch {
  const unsigned long long* leaves;  // address of each leaf row's [S, W] words
  // Per leaf, the address of its slot vector (device int32[64]) for a pool
  // row, whose `leaves` entry is then the pool's slot 0; 0 for a stack row.
  const unsigned long long* slots;
  unsigned int pool_shards;          // S of the pools (the launch's S)
  int has_pool;                      // any pool row: else no slot is read
  const int4* qinfo;                 // (ops offset, n ops, mask id, chain) per query
  const int* ops;                    // the postfix programs, back to back
  const unsigned int* masks;         // [n masks][s32]: bit s = shard s requested
  // Per range leaf (OP_RANGE's index): lo, hi, kind | depth << 8, and the
  // offset of its depth + 1 planes in `planes`, each a leaf row or -1.
  const long long* ranges;
  const int* planes;
  int n_leaves;
  int K;
  int s32;
  int w4;
};

// The address of position `pos` of this CTA's shard of pool leaf `l`, or
// null for a block in slot 0 (zeros, nothing to read).
__device__ __forceinline__ const uint4* pool_at(const Batch& b, int l, int pos) {
  const int* slot = reinterpret_cast<const int*>(__ldg(b.slots + l));
  const int sl = __ldg(slot + pos / kPoolBlockVec);
  if (sl == 0) return nullptr;
  const uint4* pool = reinterpret_cast<const uint4*>(__ldg(b.leaves + l));
  return pool + ((size_t)sl * b.pool_shards + blockIdx.y) * kPoolBlockVec +
         pos % kPoolBlockVec;
}

// Leaf `l`'s words at position `p` of the tile starting at uint4 `base` of
// the shard: from the staged tile, or from device memory (0 past the row).
// K5P (kLive) counts positions over the live blocks `blocks` only, n_pos
// of them: live position i is shard position 128 blocks[i / 128] + i % 128.
template <bool kStaged, bool kLive>
__device__ __forceinline__ uint4 leaf_at(const Batch& b, const uint4* stage,
                                         int tile, int code, size_t shard_off,
                                         int base, int p, const int* blocks, int n_pos) {
  const int l = code >> 8;
  if (kStaged) return stage[(size_t)l * tile + p];
  int pos = base + p;
  if constexpr (kLive) {
    if (pos >= n_pos) return make_uint4(0u, 0u, 0u, 0u);
    pos = blocks[pos / kPoolBlockVec] * kPoolBlockVec + pos % kPoolBlockVec;
  } else {
    if (pos >= b.w4) return make_uint4(0u, 0u, 0u, 0u);
  }
  if ((code & 0xff) == OP_ROWB) {
    const uint4* src = pool_at(b, l, pos);
    return src == nullptr ? make_uint4(0u, 0u, 0u, 0u) : __ldg(src);
  }
  const uint4* row = reinterpret_cast<const uint4*>(__ldg(b.leaves + l));
  return __ldg(row + shard_off + pos);
}

template <bool kStaged, bool kLive>
__device__ __forceinline__ uint4 item_at(const Batch& b, const uint4* stage,
                                         int tile, int code, size_t shard_off,
                                         int base, int p, const int* blocks, int n_pos) {
  return (code & 0xff) == OP_LEAF || (code & 0xff) == OP_ROWB
             ? leaf_at<kStaged, kLive>(b, stage, tile, code, shard_off, base, p, blocks, n_pos)
             : make_uint4(0u, 0u, 0u, 0u);
}

// A range leaf's condition (its record in Batch::ranges).
struct BatchRange {
  unsigned long long lo;
  unsigned long long hi;
  int kind;
  int depth;
};

// eval_range's walk (range_walk.cuh) with plane i at position u read by
// `plane(i, u)`: K5 reads the planes as leaf rows from its staged tile.
template <int U, class Plane>
__device__ __forceinline__ void range_walk(const BatchRange& r, const Plane& plane,
                                           uint4* out) {
#define RANGE_PLANE(i, u) plane(i, u)
#include "range_walk.cuh"
#undef RANGE_PLANE
}

// Range leaf `code`'s condition at this lane's U positions `p` of the tile,
// its planes read as leaf rows (leaf_at: the staged tile, or device
// memory), a missing plane (-1) as zeros with no load.
template <int U, bool kStaged, bool kLive>
__device__ __forceinline__ void range_at(const Batch& b, const uint4* stage, int tile,
                                         int code, size_t shard_off, int base, const int* p,
                                         const int* blocks, int n_pos, uint4* out) {
  const long long* rec = b.ranges + 4 * (size_t)(code >> 8);
  const long long kd = __ldg(rec + 2);
  const BatchRange r{(unsigned long long)__ldg(rec), (unsigned long long)__ldg(rec + 1),
                     (int)(kd & 0xff), (int)(kd >> 8)};
  const int* planes = b.planes + __ldg(rec + 3);
  range_walk<U>(
      r,
      [&](int i, int u) {
        const int l = __ldg(planes + i);
        return l < 0 ? make_uint4(0u, 0u, 0u, 0u)
                     : leaf_at<kStaged, kLive>(b, stage, tile, l << 8, shard_off, base, p[u],
                                               blocks, n_pos);
      },
      out);
}

// Marks the leaf rows that range leaf `code` reads (its present planes).
__device__ __forceinline__ void range_needs(const Batch& b, int code, int* needed) {
  const long long* rec = b.ranges + 4 * (size_t)(code >> 8);
  const int depth = (int)(__ldg(rec + 2) >> 8);
  const int* planes = b.planes + __ldg(rec + 3);
  for (int i = 0; i <= depth; ++i) {
    const int l = __ldg(planes + i);
    if (l >= 0) needed[l] = 1;
  }
}

// Popcount of query `q` over this lane's U positions of chunk `c`:
// positions c * 32U + u * 32 + lane of the tile, so that for each u the
// warp reads 32 neighbouring words.
template <int U, bool kStaged, bool kLive, bool kRanges>
__device__ __forceinline__ unsigned int eval_item(const Batch& b,
                                                  const uint4* stage, int tile,
                                                  int4 q, size_t shard_off,
                                                  int base, int c, int lane,
                                                  const int* blocks, int n_pos) {
  int p[U];
#pragma unroll
  for (int u = 0; u < U; ++u) p[u] = c * 32 * U + u * 32 + lane;
  const int* ops = b.ops + q.x;
  unsigned int count = 0u;
  if (q.w) {  // chain: item (item op)*, two live values per position
    uint4 acc[U];
    const int first = __ldg(ops);
    if (kRanges && (first & 0xff) == OP_RANGE) {
      range_at<U, kStaged, kLive>(b, stage, tile, first, shard_off, base, p, blocks, n_pos,
                                  acc);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] = item_at<kStaged, kLive>(b, stage, tile, first, shard_off, base, p[u], blocks,
                                         n_pos);
    }
    for (int pc = 1; pc < q.y; pc += 2) {
      const int code = __ldg(ops + pc);
      const int op = __ldg(ops + pc + 1);
      if (kRanges && (code & 0xff) == OP_RANGE) {
        uint4 v[U];
        range_at<U, kStaged, kLive>(b, stage, tile, code, shard_off, base, p, blocks, n_pos,
                                    v);
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] = combine4(op, acc[u], v[u]);
        continue;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] = combine4(
            op, acc[u],
            item_at<kStaged, kLive>(b, stage, tile, code, shard_off, base, p[u], blocks,
                                    n_pos));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) count += popc4(acc[u]);
    return count;
  }
  for (int u = 0; u < U; ++u) {  // any tree within the limits
    uint4 st[MAX_STACK];
    int sp = 0;
    for (int pc = 0; pc < q.y; ++pc) {
      const int code = __ldg(ops + pc);
      const int op = code & 0xff;
      if (op == OP_LEAF || op == OP_ROWB || op == OP_ZERO) {
        st[sp++] = item_at<kStaged, kLive>(b, stage, tile, code, shard_off, base, p[u],
                                           blocks, n_pos);
      } else if (kRanges && op == OP_RANGE) {
        range_at<1, kStaged, kLive>(b, stage, tile, code, shard_off, base, p + u, blocks,
                                    n_pos, &st[sp++]);
      } else {
        const uint4 r = st[--sp];
        st[sp - 1] = combine4(op, st[sp - 1], r);
      }
    }
    count += popc4(st[0]);
  }
  return count;
}

// One CTA's work (K5, kLive false: every tile of the shard's rows; K5P,
// kLive true: the tiles of the live positions only, see the file's head).
template <int U, bool kStaged, bool kLive, bool kRanges>
__device__ __forceinline__ void count_batch_body(const Batch& b, int tile, int tiles,
                                                 const int* __restrict__ out_index,
                                                 int k_out,
                                                 unsigned long long* __restrict__ scratch,
                                                 long long* __restrict__ out) {
  extern __shared__ uint4 smem[];
  __shared__ int n_req_s;
  __shared__ int n_need_s;
  __shared__ bool last;
  __shared__ LiveBlocks live;
  __shared__ unsigned int warp_live[kWarps];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Dynamic shared memory: the staged tile [n_leaves][tile] (staged only),
  // then per requesting query its counter and its query index, then (staged
  // only) a flag per leaf row and the list of rows to stage.
  uint4* stage = smem;
  unsigned int* cnt = reinterpret_cast<unsigned int*>(
      smem + (kStaged ? (size_t)b.n_leaves * tile : 0));
  int* qlist = reinterpret_cast<int*>(cnt + b.K);
  int* needed = qlist + b.K;
  int* nlist = needed + b.n_leaves;

  if (tid == 0) {
    n_req_s = 0;
    n_need_s = 0;
  }
  if (kStaged)
    for (int i = tid; i < b.n_leaves; i += kThreads) needed[i] = 0;
  __syncthreads();
  // The queries that request this shard, and the leaf rows they read.
  for (int k = tid; k < b.K; k += kThreads) {
    const int4 q = __ldg(b.qinfo + k);
    const unsigned int m = __ldg(b.masks + (size_t)q.z * b.s32 + (s >> 5));
    if ((m >> (s & 31)) & 1u) {
      const int j = atomicAdd(&n_req_s, 1);
      qlist[j] = k;
      cnt[j] = 0u;
      if (kStaged)
        for (int pc = 0; pc < q.y; ++pc) {
          const int code = __ldg(b.ops + q.x + pc);
          if ((code & 0xff) == OP_LEAF || (code & 0xff) == OP_ROWB)
            needed[code >> 8] = 1;
          else if (kRanges && (code & 0xff) == OP_RANGE)
            range_needs(b, code, needed);
        }
    }
  }
  __syncthreads();
  const int n_req = n_req_s;
  if (kStaged) {
    for (int i = tid; i < b.n_leaves; i += kThreads)
      if (needed[i]) nlist[atomicAdd(&n_need_s, 1)] = i;
    __syncthreads();
  }
  const int n_need = kStaged ? n_need_s : 0;
  const size_t shard_off = (size_t)s * (size_t)b.w4;
  const int chunks = tile / (32 * U);
  const int shift = __ffs(tile) - 1;  // tile is a power of two
  int n_pos = 0;
  const int* blocks = nullptr;
  if constexpr (kLive) {
    // The shard's live word: the union of the live words of the leaf rows
    // that its requesting queries read (the staged table's needed rows;
    // the direct path, which lists none, takes every row of the batch), a
    // stack row live everywhere.  It holds every query's own word, so the
    // answers are exact.  Thread t takes block t % 64 over every fourth
    // of those rows from row t / 64 on: one round trip for the slot
    // vectors, their loads all in flight.
    const int blk = tid & (kPoolBlocks - 1);
    const int n_rows = kStaged ? n_need : (n_req > 0 ? b.n_leaves : 0);
    bool on = false;
    for (int i = tid / kPoolBlocks; i < n_rows; i += kThreads / kPoolBlocks) {
      const unsigned long long sv = __ldg(b.slots + (kStaged ? nlist[i] : i));
      on |= sv == 0ull || __ldg(reinterpret_cast<const int*>(sv) + blk) != 0;
    }
    const unsigned int bits = __ballot_sync(0xffffffffu, on);
    if (lane == 0) warp_live[warp] = bits;
    __syncthreads();
    unsigned long long word = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      word |= (unsigned long long)warp_live[w] << (32 * (w & 1));
    if (tid < kPoolBlocks && ((word >> tid) & 1ull))
      live.block[__popcll(word & ((1ull << tid) - 1ull))] = tid;
    __syncthreads();
    n_pos = __popcll(word) * kPoolBlockVec;
    tiles = (n_pos + tile - 1) / tile;
    blocks = live.block;
  }
  if (n_req > 0) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int base = t * tile;
      if (kStaged) {
        // Asynchronous copies (cp.async): every load of the tile is in
        // flight at once, none waits on the one before.
        for (int i = tid; i < n_need * tile; i += kThreads) {
          const int l = nlist[i >> shift];
          const int p = i & (tile - 1);
          const int pos = base + p;
          uint4* dst = stage + (size_t)l * tile + p;
          const uint4* src = nullptr;
          if constexpr (kLive) {
            if (pos < n_pos) {
              const int at = live.block[pos / kPoolBlockVec] * kPoolBlockVec +
                             pos % kPoolBlockVec;
              src = __ldg(b.slots + l) != 0ull
                        ? pool_at(b, l, at)
                        : reinterpret_cast<const uint4*>(__ldg(b.leaves + l)) + shard_off + at;
            }
          } else {
            if (pos < b.w4) {
              src = b.has_pool && __ldg(b.slots + l) != 0ull
                        ? pool_at(b, l, pos)
                        : reinterpret_cast<const uint4*>(__ldg(b.leaves + l)) +
                              shard_off + pos;
            }
          }
          if (src != nullptr) {
            __pipeline_memcpy_async(dst, src, sizeof(uint4));
          } else {
            *dst = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
      }
      // Items are warp-uniform, so every lane reaches the shuffles.
      for (int it = warp; it < n_req * chunks; it += kWarps) {
        const int j = it / chunks;
        const int c = it - j * chunks;
        const int4 q = __ldg(b.qinfo + qlist[j]);
        unsigned int v = eval_item<U, kStaged, kLive, kRanges>(b, stage, tile, q, shard_off,
                                                               base, c, lane, blocks, n_pos);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0 && v) atomicAdd(&cnt[j], v);
      }
      if (kStaged) __syncthreads();  // the next tile overwrites the stage
    }
  }
  __syncthreads();
  for (int j = tid; j < n_req; j += kThreads)
    if (cnt[j]) atomicAdd(scratch + qlist[j], (unsigned long long)cnt[j]);
  __threadfence();  // this CTA's adds, before its arrival
  __syncthreads();
  if (tid == 0) {
    const unsigned long long ctas = (unsigned long long)gridDim.x * gridDim.y;
    last = atomicAdd(scratch + kMaxQueries, 1ull) == ctas - 1ull;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other CTA's adds, before the reads below
  for (int i = tid; i < k_out; i += kThreads) {
    const int src = out_index != nullptr ? __ldg(out_index + i) : i;
    out[i] = (long long)__ldcg(scratch + src);
  }
  __syncthreads();
  for (int i = tid; i < b.K; i += kThreads) scratch[i] = 0ull;
  if (tid == 0) scratch[kMaxQueries] = 0ull;
}

template <int U, bool kStaged, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    count_batch_tree_kernel(Batch b, int tile, int tiles,
                            const int* __restrict__ out_index, int k_out,
                            unsigned long long* __restrict__ scratch,
                            long long* __restrict__ out) {
  count_batch_body<U, kStaged, false, kRanges>(b, tile, tiles, out_index, k_out, scratch, out);
}

// K5P: K5 over the live blocks of the rows that each shard's requesting
// queries read.
template <int U, bool kStaged, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    count_batch_tree_pool_kernel(Batch b, int tile, int tiles,
                                 const int* __restrict__ out_index, int k_out,
                                 unsigned long long* __restrict__ scratch,
                                 long long* __restrict__ out) {
  count_batch_body<U, kStaged, true, kRanges>(b, tile, tiles, out_index, k_out, scratch, out);
}

template <int U, bool kStaged, bool kLive, bool kRanges>
int launch(const Batch& b, int tile, const int* out_index, int k_out,
           int n_shards, unsigned long long* scratch, long long* out,
           cudaStream_t stream) {
  auto kernel = kLive ? count_batch_tree_pool_kernel<U, kStaged, kRanges>
                      : count_batch_tree_kernel<U, kStaged, kRanges>;
  const size_t smem =
      (kStaged ? (size_t)b.n_leaves * tile * sizeof(uint4) : 0) +
      (size_t)b.K * 2 * sizeof(int) +
      (kStaged ? (size_t)b.n_leaves * 2 * sizeof(int) : 0);
  static size_t allowed = 48 * 1024;  // the default, per instantiation
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const int tiles = (b.w4 + tile - 1) / tile;
  // About eight CTAs per SM in all, at least one per shard.  K5P cannot
  // know the live word without reading the slot table, and each of its
  // CTAs pays a prologue (the live word, two barriers) before its first
  // tile, so it takes only as many CTAs as fill the card once (the
  // variant's occupancy at this stage), at least one a shard, each looping
  // over its shard's live tiles; those past the live tiles find none and
  // still arrive on the counter.  The residency phase's 8-Count query (960
  // shards, 8 rows: 256-position tiles, 4 CTAs an SM) runs one CTA a
  // shard over its 4 live tiles.
  int per_shard = (n_sms() * 8 + n_shards - 1) / n_shards;
  if (kLive) {
    // The occupancy at the last stage size, per instantiation: a batch's
    // stage changes with its leaf count, rarely from one launch to the next.
    static size_t fit_smem = ~(size_t)0;
    static int fit = 1;
    if (smem != fit_smem) {
      int f = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f, kernel, kThreads, smem) !=
              cudaSuccess || f <= 0)
        f = 1;
      fit = f;
      fit_smem = smem;
    }
    per_shard = (n_sms() * fit + n_shards - 1) / n_shards;
  }
  if (per_shard > tiles) per_shard = tiles;
  if (per_shard < 1) per_shard = 1;
  const dim3 grid(per_shard, n_shards);
  kernel<<<grid, kThreads, smem, stream>>>(b, tile, tiles, out_index, k_out, scratch, out);
  return (int)cudaGetLastError();
}

// Host side: count_batch_tree's launch (below), K5 or K5P, each with the
// range leaf compiled in only for a batch that has one (kRanges).
template <bool kLive, bool kRanges>
int dispatch(const Batch& b, int tile, const int* fan, int k_out, int n_shards,
             unsigned long long* sc, long long* o, cudaStream_t st) {
  if (tile >= 128)
    return launch<4, true, kLive, kRanges>(b, tile, fan, k_out, n_shards, sc, o, st);
  if (tile >= 32)
    return launch<1, true, kLive, kRanges>(b, tile, fan, k_out, n_shards, sc, o, st);
  return launch<4, false, kLive, kRanges>(b, kDirectTile, fan, k_out, n_shards, sc, o, st);
}

template <bool kLive>
int run(const void* leaves, int n_leaves, int has_pool, const void* qinfo, int K,
        const void* ops, const void* masks, const void* ranges, int n_ranges,
        const void* planes, const void* out_index, int k_out, int n_shards,
        int words, void* scratch, void* out, void* stream) {
  if (K < 1 || K > kMaxQueries || n_leaves < 0 || n_leaves > kMaxLeaves || n_ranges < 0 ||
      n_ranges > kMaxQueries * MAX_RANGES ||
      (n_ranges > 0 && (ranges == nullptr || planes == nullptr)) ||
      k_out < 1 || n_shards < 0 || n_shards > 65535 || words <= 0 ||
      words % 4 != 0 || (kLive && (has_pool == 0 || words != kPoolRowVec * 4)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_shards == 0)  // no CTA would write the (zero) totals
    return (int)cudaMemsetAsync(out, 0, (size_t)k_out * sizeof(long long), st);
  Batch b;
  b.leaves = (const unsigned long long*)leaves;
  b.slots = b.leaves + n_leaves;
  b.pool_shards = (unsigned int)n_shards;
  b.has_pool = has_pool != 0;
  b.qinfo = (const int4*)qinfo;
  b.ops = (const int*)ops;
  b.masks = (const unsigned int*)masks;
  b.ranges = (const long long*)ranges;
  b.planes = (const int*)planes;
  b.n_leaves = n_leaves;
  b.K = K;
  b.s32 = (n_shards + 31) / 32;
  b.w4 = words / 4;
  // The widest tile (a power of two, at most kDirectTile) whose words of
  // every leaf row fit the stage.  K5P stages half as much: its live
  // tiles are few, so a CTA spends a larger share of its time in its
  // prologue and evaluation, with nothing of its own in flight; at 32 KiB
  // four CTAs share an SM (its registers' limit) where three did, and one
  // CTA's copies overlap another's evaluation.  So its direct path starts
  // past 64 rows.
  const long long stage_bytes = kLive ? kStageBytes / 2 : kStageBytes;
  int tile = kDirectTile;
  while (tile >= 32 && (long long)n_leaves * tile * 16 > stage_bytes) tile >>= 1;
  unsigned long long* sc = (unsigned long long*)scratch;
  long long* o = (long long*)out;
  const int* fan = (const int*)out_index;
  return n_ranges > 0 ? dispatch<kLive, true>(b, tile, fan, k_out, n_shards, sc, o, st)
                      : dispatch<kLive, false>(b, tile, fan, k_out, n_shards, sc, o, st);
}

}  // namespace

// leaves: device uint64[2 * n_leaves], the leaf row addresses and then
// each leaf's slot vector address (0 for a stack row; a pool row's address
// is the pool's slot 0); has_pool: whether any leaf is a pool row.  qinfo:
// device int32[K][4].  ops: device int32 programs.  masks: device
// uint32[n masks][ceil(S / 32)].  ranges: device int64[n_ranges][4] (lo,
// hi, kind | depth << 8, planes offset), planes: device int32, each entry a
// leaf row or -1 (both unread, and may be null, for n_ranges 0).
// out_index: device int32[k_out], or null
// for out[i] = total of query i (k_out = K).  scratch: device
// uint64[kMaxQueries + 1], zero (each launch leaves it zero).  out: device
// int64[k_out], written whole.  Returns the cudaError_t of the launch.
extern "C" int count_batch_tree(const void* leaves, int n_leaves, int has_pool,
                                const void* qinfo, int K, const void* ops,
                                const void* masks, const void* ranges, int n_ranges,
                                const void* planes, const void* out_index,
                                int k_out, int n_shards, int words,
                                void* scratch, void* out, void* stream) {
  return run<false>(leaves, n_leaves, has_pool, qinfo, K, ops, masks, ranges, n_ranges, planes,
                    out_index, k_out, n_shards, words, scratch, out, stream);
}

// K5P: count_batch_tree's arguments for a batch with pool rows (has_pool
// 1, words the full 32768 of a pool row), reading the live blocks only.
extern "C" int count_batch_tree_pool(const void* leaves, int n_leaves, int has_pool,
                                     const void* qinfo, int K, const void* ops,
                                     const void* masks, const void* ranges, int n_ranges,
                                     const void* planes, const void* out_index,
                                     int k_out, int n_shards, int words,
                                     void* scratch, void* out, void* stream) {
  return run<true>(leaves, n_leaves, has_pool, qinfo, K, ops, masks, ranges, n_ranges, planes,
                   out_index, k_out, n_shards, words, scratch, out, stream);
}
