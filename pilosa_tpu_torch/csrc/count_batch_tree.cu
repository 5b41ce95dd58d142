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
// leaf table (parallel/kernels.py compile_batch).  The host groups the
// batch's distinct range leaves by the planes they walk (one field's, at
// one depth: `groups`) and gives each its walk form (`walks`: an
// equality, >= or <= chain, strict or not, or both for BETWEEN; kernels.py
// walk_form).  A batch with range leaves runs the grouped range pass
// (count_batch_range_body, in kernels built for it alone, one per depth
// tier): per tile, before its items, each thread takes positions of the
// tile, reads each plane word of a group once, straight from device memory
// into registers (all depth + 1 loads of a position in flight together),
// walks every condition of the group that a requesting query reads on
// those words, one condition at a time (walk_range: one three-input logic
// operation a plane word, the predicate bit a mask), and writes each
// condition's result word into a shared-memory row.  The items then read
// a range leaf as that row, like any staged leaf.  So eight conditions on
// a 9-plane field read each plane word once a position, not once a query
// (72 shared-memory reads a position when each query walked staged
// planes).  The stage holds the rows queries read as rows, twice (the
// next tile's copies are in flight under this tile's pass and items:
// cp.async groups, __pipeline_wait_prior(1)), and one row per range leaf;
// planes that no query reads as a row are not staged.  A wider stage
// (more than 128 rows) takes the direct path, where each query walks its
// condition's planes from device memory (range_at).  A missing plane (-1)
// reads as zeros with no load.  A batch without a range leaf runs the
// kernel built without them (kRanges false), whose code this design
// leaves as it was.

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
// a query holding one is requested walks every block (correct, and no
// cheaper than K5 there).
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
// `plane(i, u)`: K5's direct path reads the planes as leaf rows.
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

// ---- The grouped range pass: K5 and K5P over a batch with range leaves ----

// The walk classes and flags of a range leaf's walk form
// (parallel/kernels.py walk_form, WALK_*).
enum : int { kWalkEq = 0, kWalkGe = 1, kWalkLe = 2, kWalkBetween = 3 };
constexpr long long kWalkNeg = 1 << 8;
constexpr long long kWalkStrict = 1 << 9;

// A batch with range leaves: the Batch, its range groups and walk forms,
// and how many leaf rows are read as rows (table rows 0..n_rows-1; the
// rest are planes that only the pass reads).
struct RangeBatch {
  Batch b;
  const int4* groups;      // per group: first range, ranges, depth, planes offset
  const long long* walks;  // per range: lo, hi, class | flags
  int n_groups;
  int n_ranges;
  int n_rows;
};

// V consecutive 32-bit words of a row from word offset w: one 16, 8 or
// 4-byte load through the read-only cache.
template <int V>
__device__ __forceinline__ void load_words(const unsigned int* row, size_t w,
                                           unsigned int (&x)[V]) {
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + w));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (V == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + w));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg(row + w);
  }
}

// Bit i of x as a mask: all ones where it is set.
__device__ __forceinline__ unsigned int bit_mask(unsigned long long x, int i) {
  return 0u - (unsigned int)((x >> i) & 1ull);
}

// One range leaf's condition over V words whose planes are in registers
// (pl[i] value plane i, nn the not-null plane), in its walk form: a chain
// over the planes, low bit first, comparing each column's value with the
// predicate on the bits walked so far.  >= : c = x_i ? v_i & c : v_i | c,
// from all ones (or none, strictly: >); <= : c = x_i ? ~v_i | c : ~v_i & c;
// equality c &= ~(v_i ^ x_i); BETWEEN a >= chain on lo and a <= chain on
// hi.  Each step is one three-input logic operation a word with the
// predicate bit as a mask: no branch.  The planes past the depth are zero
// and the predicates' bits there are too (walk_form), which leaves every
// chain as it was, so the tier's planes are walked whatever the depth.
// fragment.go's rangeEQ/NEQ/LT/GT/Between walk high bit first
// (range_walk.cuh); the comparisons are the same.
template <int kMaxD, int V>
__device__ __forceinline__ void walk_range(unsigned long long lo, unsigned long long hi,
                                           long long form, const unsigned int (&pl)[kMaxD][V],
                                           const unsigned int (&nn)[V], unsigned int (&out)[V]) {
  unsigned int c[V], c2[V];
  const unsigned int init = (form & kWalkStrict) ? 0u : ~0u;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    c[v] = init;
    c2[v] = ~0u;
  }
  const int cls = (int)(form & 0xff);
  if (cls == kWalkEq) {
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      const unsigned int m = bit_mask(lo, i);
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] &= ~(pl[i][v] ^ m);
    }
  } else if (cls == kWalkLe) {
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      const unsigned int m = bit_mask(lo, i);
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] = (~pl[i][v] & c[v]) | (m & (~pl[i][v] | c[v]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      const unsigned int m = bit_mask(lo, i);
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] = (pl[i][v] & c[v]) | (~m & (pl[i][v] | c[v]));
    }
    if (cls == kWalkBetween) {
#pragma unroll
      for (int i = 0; i < kMaxD; ++i) {
        const unsigned int m = bit_mask(hi, i);
#pragma unroll
        for (int v = 0; v < V; ++v) c2[v] = (~pl[i][v] & c2[v]) | (m & (~pl[i][v] | c2[v]));
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = (form & kWalkNeg) ? nn[v] & ~c[v] : nn[v] & c[v] & c2[v];
}

// Unit u of the tile at uint4 `base` (V words of one position) of group
// g's planes (`rows`, leaf-table rows or -1) into registers, every load in
// flight at once: pl[i] value plane i (zeros past the depth and for a
// missing plane), nn the not-null plane.  K5P (kLive) takes live
// positions, as its staged rows do; a unit past the shard's (live) words
// reads nothing and holds zeros.
template <int kMaxD, int V, bool kLive>
__device__ __forceinline__ void load_unit(const Batch& b, const int* rows, int depth, int u,
                                          int base, size_t shard_off, const int* blocks,
                                          int n_pos, unsigned int (&pl)[kMaxD][V],
                                          unsigned int (&nn)[V]) {
  const int pos = base + ((u * V) >> 2);
  bool in;
  int at = pos;
  if constexpr (kLive) {
    in = pos < n_pos;
    if (in) at = blocks[pos / kPoolBlockVec] * kPoolBlockVec + pos % kPoolBlockVec;
  } else {
    in = pos < b.w4;
  }
  const size_t w = (shard_off + at) * 4 + ((u * V) & 3);
  {
    const int l = __ldg(rows + depth);
    if (in && l >= 0) {
      load_words<V>(reinterpret_cast<const unsigned int*>(__ldg(b.leaves + l)), w, nn);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) nn[v] = 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxD; ++i) {
    const int l = i < depth ? __ldg(rows + i) : -1;
    if (in && l >= 0) {
      load_words<V>(reinterpret_cast<const unsigned int*>(__ldg(b.leaves + l)), w, pl[i]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) pl[i][v] = 0u;
    }
  }
}

// Group g's pass over the tile at uint4 `base` of this CTA's shard: each
// thread takes units of V words (V = 4 at depth 8 and under, 2 to 16, 1
// deeper, so that a unit's planes fit in registers), loads the group's
// depth + 1 plane words of a unit at once (load_unit), then walks every
// condition of the group that a requesting query reads (rneed) and writes
// its result words to that condition's row of `rr` [n_ranges][tile] uint4.
template <int kMaxD, int V, bool kLive>
__device__ __forceinline__ void range_group_pass(const RangeBatch& rb, int4 g, const int* rneed,
                                                 uint4* rr, int tile, int base, size_t shard_off,
                                                 const int* blocks, int n_pos) {
  const Batch& b = rb.b;
  const int* rows = b.planes + g.w;
  unsigned int* out = reinterpret_cast<unsigned int*>(rr);
  const int units = tile * 4 / V;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    unsigned int pl[kMaxD][V], nn[V];
    load_unit<kMaxD, V, kLive>(b, rows, g.z, u, base, shard_off, blocks, n_pos, pl, nn);
    for (int c = g.x; c < g.x + g.y; ++c) {
      if (!rneed[c]) continue;
      const long long* rec = rb.walks + 3 * (size_t)c;
      unsigned int r[V];
      walk_range<kMaxD, V>((unsigned long long)__ldg(rec), (unsigned long long)__ldg(rec + 1),
                           __ldg(rec + 2), pl, nn, r);
      unsigned int* dst = out + (size_t)c * tile * 4 + u * V;
      if constexpr (V == 4) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(r[0], r[1], r[2], r[3]);
      } else if constexpr (V == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(r[0], r[1]);
      } else {
        dst[0] = r[0];
      }
    }
  }
}

// An item of a query over the staged tile: a leaf row from `rows`, a range
// leaf's result row from `rr`, zero otherwise.
__device__ __forceinline__ uint4 staged_item(int code, const uint4* rows, const uint4* rr,
                                             int tile, int p) {
  const int op = code & 0xff;
  if (op == OP_LEAF || op == OP_ROWB) return rows[(size_t)(code >> 8) * tile + p];
  if (op == OP_RANGE) return rr[(size_t)(code >> 8) * tile + p];
  return make_uint4(0u, 0u, 0u, 0u);
}

// eval_item over the staged tile and the range rows: query q's popcount at
// this lane's U positions of chunk c.
template <int U>
__device__ __forceinline__ unsigned int eval_staged(const Batch& b, const uint4* rows,
                                                    const uint4* rr, int tile, int4 q, int c,
                                                    int lane) {
  int p[U];
#pragma unroll
  for (int u = 0; u < U; ++u) p[u] = c * 32 * U + u * 32 + lane;
  const int* ops = b.ops + q.x;
  unsigned int count = 0u;
  if (q.w) {  // chain: item (item op)*, two live values per position
    uint4 acc[U];
    const int first = __ldg(ops);
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = staged_item(first, rows, rr, tile, p[u]);
    for (int pc = 1; pc < q.y; pc += 2) {
      const int code = __ldg(ops + pc);
      const int op = __ldg(ops + pc + 1);
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] = combine4(op, acc[u], staged_item(code, rows, rr, tile, p[u]));
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
      if (op == OP_LEAF || op == OP_ROWB || op == OP_ZERO || op == OP_RANGE) {
        st[sp++] = staged_item(code, rows, rr, tile, p[u]);
      } else {
        const uint4 r = st[--sp];
        st[sp - 1] = combine4(op, st[sp - 1], r);
      }
    }
    count += popc4(st[0]);
  }
  return count;
}

// One CTA's work over a batch with range leaves (K5, kLive false: every
// tile of its shard; K5P: the live tiles).  The prologue lists the
// requesting queries, the rows they read as rows, the range leaves and
// groups they read, and (K5P) the live word, a range leaf making every
// block live.  Per tile: the next tile's row copies are issued, the range
// pass writes this tile's range rows, this tile's copies are waited for,
// then the (query, chunk) items run as in count_batch_body.
template <int U, bool kLive, int kTier>
__device__ __forceinline__ void count_batch_range_body(const RangeBatch& rb, int tile, int tiles,
                                                       const int* __restrict__ out_index,
                                                       int k_out,
                                                       unsigned long long* __restrict__ scratch,
                                                       long long* __restrict__ out) {
  const Batch& b = rb.b;
  extern __shared__ uint4 smem[];
  __shared__ int n_req_s;
  __shared__ int n_need_s;
  __shared__ int any_range_s;
  __shared__ bool last;
  __shared__ LiveBlocks live;
  __shared__ unsigned int warp_live[kWarps];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_rows = rb.n_rows;
  // Dynamic shared memory: two stages of the rows read as rows
  // [2][n_rows][tile], the range rows [n_ranges][tile], then per requesting
  // query its counter and index, a flag and list entry per row, a flag per
  // range leaf and per group.
  uint4* rows0 = smem;
  uint4* rows1 = smem + (size_t)n_rows * tile;
  uint4* rr = smem + (size_t)2 * n_rows * tile;
  unsigned int* cnt = reinterpret_cast<unsigned int*>(rr + (size_t)rb.n_ranges * tile);
  int* qlist = reinterpret_cast<int*>(cnt + b.K);
  int* needed = qlist + b.K;
  int* nlist = needed + n_rows;
  int* rneed = nlist + n_rows;
  int* gneed = rneed + rb.n_ranges;

  if (tid == 0) {
    n_req_s = 0;
    n_need_s = 0;
    any_range_s = 0;
  }
  for (int i = tid; i < n_rows; i += kThreads) needed[i] = 0;
  for (int i = tid; i < rb.n_ranges; i += kThreads) rneed[i] = 0;
  __syncthreads();
  for (int k = tid; k < b.K; k += kThreads) {
    const int4 q = __ldg(b.qinfo + k);
    const unsigned int m = __ldg(b.masks + (size_t)q.z * b.s32 + (s >> 5));
    if ((m >> (s & 31)) & 1u) {
      const int j = atomicAdd(&n_req_s, 1);
      qlist[j] = k;
      cnt[j] = 0u;
      for (int pc = 0; pc < q.y; ++pc) {
        const int code = __ldg(b.ops + q.x + pc);
        if ((code & 0xff) == OP_LEAF || (code & 0xff) == OP_ROWB) {
          needed[code >> 8] = 1;
        } else if ((code & 0xff) == OP_RANGE) {
          rneed[code >> 8] = 1;
          any_range_s = 1;
        }
      }
    }
  }
  __syncthreads();
  const int n_req = n_req_s;
  for (int i = tid; i < n_rows; i += kThreads)
    if (needed[i]) nlist[atomicAdd(&n_need_s, 1)] = i;
  for (int g = tid; g < rb.n_groups; g += kThreads) {
    const int4 gr = __ldg(rb.groups + g);
    int any = 0;
    for (int c = gr.x; c < gr.x + gr.y; ++c) any |= rneed[c];
    gneed[g] = any;
  }
  __syncthreads();
  const int n_need = n_need_s;
  const size_t shard_off = (size_t)s * (size_t)b.w4;
  const int chunks = tile / (32 * U);
  const int shift = __ffs(tile) - 1;  // tile is a power of two
  int n_pos = 0;
  const int* blocks = nullptr;
  if constexpr (kLive) {
    // count_batch_body's live word, every block live where a requesting
    // query reads a range leaf (its planes are stack rows).
    const int blk = tid & (kPoolBlocks - 1);
    bool on = any_range_s != 0;
    for (int i = tid / kPoolBlocks; i < n_need; i += kThreads / kPoolBlocks) {
      const unsigned long long sv = __ldg(b.slots + nlist[i]);
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
  // This thread's copies of tile t's needed rows into `buf` (cp.async,
  // all in flight at once), committed as one group.
  auto stage_tile = [&](uint4* buf, int t) {
    const int base = t * tile;
    for (int i = tid; i < n_need * tile; i += kThreads) {
      const int l = nlist[i >> shift];
      const int p = i & (tile - 1);
      const int pos = base + p;
      uint4* dst = buf + (size_t)l * tile + p;
      const uint4* src = nullptr;
      if constexpr (kLive) {
        if (pos < n_pos) {
          const int at = live.block[pos / kPoolBlockVec] * kPoolBlockVec + pos % kPoolBlockVec;
          src = __ldg(b.slots + l) != 0ull
                    ? pool_at(b, l, at)
                    : reinterpret_cast<const uint4*>(__ldg(b.leaves + l)) + shard_off + at;
        }
      } else {
        if (pos < b.w4) {
          src = b.has_pool && __ldg(b.slots + l) != 0ull
                    ? pool_at(b, l, pos)
                    : reinterpret_cast<const uint4*>(__ldg(b.leaves + l)) + shard_off + pos;
        }
      }
      if (src != nullptr) {
        __pipeline_memcpy_async(dst, src, sizeof(uint4));
      } else {
        *dst = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __pipeline_commit();
  };
  if (n_req > 0) {
    if ((int)blockIdx.x < tiles) stage_tile(rows0, blockIdx.x);
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const uint4* cur = (it & 1) ? rows1 : rows0;
      if (t + (int)gridDim.x < tiles) {
        stage_tile((it & 1) ? rows0 : rows1, t + gridDim.x);
      } else {
        __pipeline_commit();  // an empty group: one group a tile
      }
      const int base = t * tile;
      for (int g = 0; g < rb.n_groups; ++g) {
        if (gneed[g])
          range_group_pass<kTier, kTier <= 8 ? 4 : kTier <= 16 ? 2 : 1, kLive>(
              rb, __ldg(rb.groups + g), rneed, rr, tile, base, shard_off, blocks, n_pos);
      }
      __pipeline_wait_prior(1);  // this tile's copies; the next tile's stay in flight
      __syncthreads();
      // Items are warp-uniform, so every lane reaches the shuffles.
      for (int item = warp; item < n_req * chunks; item += kWarps) {
        const int j = item / chunks;
        const int c = item - j * chunks;
        const int4 q = __ldg(b.qinfo + qlist[j]);
        unsigned int v = eval_staged<U>(b, cur, rr, tile, q, c, lane);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0 && v) atomicAdd(&cnt[j], v);
      }
      __syncthreads();  // the next tile overwrites this stage and the range rows
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

// K5 and K5P over a batch with range leaves (staged): overloads of the
// kernels above, taking the batch with its range groups, one kernel per
// depth tier (8, 16, 32 or 63 planes: the deepest group's), so that a
// batch of shallow fields keeps the registers of its tier: three CTAs an
// SM up to depth 32.
template <int U, int kTier>
__global__ void __launch_bounds__(kThreads, kTier <= 32 ? 3 : 2)
    count_batch_tree_kernel(RangeBatch rb, int tile, int tiles,
                            const int* __restrict__ out_index, int k_out,
                            unsigned long long* __restrict__ scratch,
                            long long* __restrict__ out) {
  count_batch_range_body<U, false, kTier>(rb, tile, tiles, out_index, k_out, scratch, out);
}

template <int U, int kTier>
__global__ void __launch_bounds__(kThreads, kTier <= 32 ? 3 : 2)
    count_batch_tree_pool_kernel(RangeBatch rb, int tile, int tiles,
                                 const int* __restrict__ out_index, int k_out,
                                 unsigned long long* __restrict__ scratch,
                                 long long* __restrict__ out) {
  count_batch_range_body<U, true, kTier>(rb, tile, tiles, out_index, k_out, scratch, out);
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

// K5 or K5P over a batch with range leaves, staged (count_batch_range_body):
// count_batch_body's grid and shared-memory rules for the range stage.
template <int U, bool kLive, int kTier>
int launch_ranges(const RangeBatch& rb, int tile, const int* out_index, int k_out,
                  int n_shards, unsigned long long* scratch, long long* out,
                  cudaStream_t stream) {
  void (*kernel)(RangeBatch, int, int, const int*, int, unsigned long long*, long long*) =
      kLive ? count_batch_tree_pool_kernel<U, kTier> : count_batch_tree_kernel<U, kTier>;
  const Batch& b = rb.b;
  const size_t smem = (size_t)(2 * rb.n_rows + rb.n_ranges) * tile * sizeof(uint4) +
                      ((size_t)b.K * 2 + (size_t)rb.n_rows * 2 + rb.n_ranges + rb.n_groups) *
                          sizeof(int);
  static size_t allowed = 48 * 1024;  // the default, per instantiation
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const int tiles = (b.w4 + tile - 1) / tile;
  int per_shard = (n_sms() * 8 + n_shards - 1) / n_shards;
  if (kLive) {
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
  kernel<<<grid, kThreads, smem, stream>>>(rb, tile, tiles, out_index, k_out, scratch, out);
  return (int)cudaGetLastError();
}

template <bool kLive, int kTier>
int launch_tier(const RangeBatch& rb, int tile, const int* fan, int k_out, int n_shards,
                unsigned long long* sc, long long* o, cudaStream_t st) {
  return tile >= 128 ? launch_ranges<4, kLive, kTier>(rb, tile, fan, k_out, n_shards, sc, o, st)
                     : launch_ranges<1, kLive, kTier>(rb, tile, fan, k_out, n_shards, sc, o, st);
}

// Host side: count_batch_tree's launch (below), K5 or K5P, for a batch
// without range leaves (kRanges false: the range leaf compiled out).
template <bool kLive>
int dispatch(const Batch& b, int tile, const int* fan, int k_out, int n_shards,
             unsigned long long* sc, long long* o, cudaStream_t st) {
  if (tile >= 128) return launch<4, true, kLive, false>(b, tile, fan, k_out, n_shards, sc, o, st);
  if (tile >= 32) return launch<1, true, kLive, false>(b, tile, fan, k_out, n_shards, sc, o, st);
  return launch<4, false, kLive, false>(b, kDirectTile, fan, k_out, n_shards, sc, o, st);
}

template <bool kLive>
int run(const void* leaves, int n_leaves, int has_pool, const void* qinfo, int K,
        const void* ops, const void* masks, const void* ranges, int n_ranges,
        const void* planes, const void* groups, const void* walks, int n_groups, int n_rows,
        int range_depth, const void* out_index, int k_out, int n_shards,
        int words, void* scratch, void* out, void* stream) {
  if (K < 1 || K > kMaxQueries || n_leaves < 0 || n_leaves > kMaxLeaves || n_ranges < 0 ||
      n_ranges > kMaxQueries * MAX_RANGES ||
      (n_ranges > 0 && (ranges == nullptr || planes == nullptr || groups == nullptr ||
                        walks == nullptr || n_groups < 1 || n_groups > n_ranges)) ||
      n_rows < 0 || n_rows > n_leaves || range_depth < 0 || range_depth >= MAX_PLANES ||
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
  if (n_ranges == 0) return dispatch<kLive>(b, tile, fan, k_out, n_shards, sc, o, st);
  // With range leaves the stage holds each row read as a row twice (the
  // next tile's copies in flight) and one result row per range leaf
  // (parallel/kernels.py batch_tile); past 128 rows, the direct path.
  const RangeBatch rb{b, (const int4*)groups, (const long long*)walks, n_groups, n_ranges,
                      n_rows};
  const long long staged = 2LL * n_rows + n_ranges;
  int rtile = kDirectTile;
  while (rtile >= 32 && staged * rtile * 16 > stage_bytes) rtile >>= 1;
  if (rtile < 32) return launch<4, false, kLive, true>(b, kDirectTile, fan, k_out, n_shards, sc,
                                                      o, st);
  return range_depth <= 8    ? launch_tier<kLive, 8>(rb, rtile, fan, k_out, n_shards, sc, o, st)
         : range_depth <= 16 ? launch_tier<kLive, 16>(rb, rtile, fan, k_out, n_shards, sc, o, st)
         : range_depth <= 32 ? launch_tier<kLive, 32>(rb, rtile, fan, k_out, n_shards, sc, o, st)
                             : launch_tier<kLive, MAX_PLANES - 1>(rb, rtile, fan, k_out,
                                                                  n_shards, sc, o, st);
}

}  // namespace

// leaves: device uint64[2 * n_leaves], the leaf row addresses and then
// each leaf's slot vector address (0 for a stack row; a pool row's address
// is the pool's slot 0), the n_rows rows read as rows first; has_pool:
// whether any leaf is a pool row.  qinfo: device int32[K][4].  ops: device
// int32 programs.  masks: device uint32[n masks][ceil(S / 32)].  ranges:
// device int64[n_ranges][4] (lo, hi, kind | depth << 8, planes offset),
// planes: device int32, each entry a leaf row or -1; groups: device
// int32[n_groups][4] (first range, ranges, depth, planes offset), walks:
// device int64[n_ranges][3] (lo, hi, class | flags) (all four unread, and
// may be null, for n_ranges 0); range_depth: the deepest group's depth.
// out_index: device int32[k_out], or null for out[i] = total of query i
// (k_out = K).  scratch: device uint64[kMaxQueries + 1], zero (each launch
// leaves it zero).  out: device int64[k_out], written whole.  Returns the
// cudaError_t of the launch.
extern "C" int count_batch_tree(const void* leaves, int n_leaves, int has_pool,
                                const void* qinfo, int K, const void* ops,
                                const void* masks, const void* ranges, int n_ranges,
                                const void* planes, const void* groups, const void* walks,
                                int n_groups, int n_rows, int range_depth,
                                const void* out_index, int k_out, int n_shards, int words,
                                void* scratch, void* out, void* stream) {
  return run<false>(leaves, n_leaves, has_pool, qinfo, K, ops, masks, ranges, n_ranges, planes,
                    groups, walks, n_groups, n_rows, range_depth, out_index, k_out, n_shards,
                    words, scratch, out, stream);
}

// K5P: count_batch_tree's arguments for a batch with pool rows (has_pool
// 1, words the full 32768 of a pool row), reading the live blocks only.
extern "C" int count_batch_tree_pool(const void* leaves, int n_leaves, int has_pool,
                                     const void* qinfo, int K, const void* ops,
                                     const void* masks, const void* ranges, int n_ranges,
                                     const void* planes, const void* groups,
                                     const void* walks, int n_groups, int n_rows,
                                     int range_depth, const void* out_index, int k_out,
                                     int n_shards, int words, void* scratch, void* out,
                                     void* stream) {
  return run<true>(leaves, n_leaves, has_pool, qinfo, K, ops, masks, ranges, n_ranges, planes,
                   groups, walks, n_groups, n_rows, range_depth, out_index, k_out, n_shards,
                   words, scratch, out, stream);
}
