// F1 fused_tree: the mask slots and count edges of a whole-dashboard drain.
//
// Replaces the slot table and count edges of the XLA program
// pilosa_tpu/parallel/kernels.py:545 fused_tree (:594-613): every distinct
// Row subtree of a drain's queries is a mask slot, evaluated once per word
// however many queries (or later slots) read it, and each count edge is
// sum(popcount(slot & shard gate)).  The aggregate edges (Sum, Min/Max,
// TopN, GroupBy) run after it on the same stream, in K6, K7, K3 and K8,
// each reading its slot as an ordinary filter row from the scratch this
// kernel writes (parallel/kernels.py fused_tree).
//
// A slot is a flat node (parallel/fusion.py builds nothing else): an op
// over leaf rows, range leaves, zeros and references to earlier slots.
// Each thread walks one uint4 (four words) of a shard at a time and keeps
// every slot's value for that uint4 in registers, v[kSlots]: a reference to
// slot q is a register read, resolved by a loop over q unrolled at compile
// time against the slot's bit set of references (uniform across the grid),
// so no slot value is ever indexed at run time or written to memory unless
// an aggregate edge reads it.  The kernel is templated on the slot tier
// kSlots (1, 2, 4, 8, 16) and, as the tree kernels are, on whether any
// range leaf is present.  Registers and the unrolled reference tests grow
// with the tier (101 registers at 16), so parallel/kernels.py
// compile_fused passes a slot of one row that no edge reads as an item of
// the slots that read it: a dashboard's F1 holds only its nodes (5 slots
// of 13 at ten widgets), and a slot that reads no slot comes first, so
// its loads are in flight before any node waits on one.
//
// Bound: device-memory bytes.  A drain reads each distinct leaf row of the
// requested shards once and writes each materialized slot once: the
// dashboard of ten widgets over 960 shards reads its 8 rows and writes 2
// slots (10 x 960 x 128 KiB = 1.26 GB, 0.376 ms at 3.35 TB/s).  The integer
// work is a few operations per 16 bytes per slot.  A block whose shard no
// edge asks for returns before it reads anything.  Per block, each counted
// slot's sum is reduced once (warp shuffles, then shared memory), and each
// count edge whose gate holds the shard adds it with one atomic.
//
// F1P, the same kernel over a table with pool leaves (OP_ROWB), reads and
// writes only the 2 KiB blocks its slots can make non-zero.  Block b of a
// pool row sits in the same pool slot in every shard, so each slot's live
// word (tree_eval.cuh slots_live: the live-word rules on the flat node,
// OP_MREF reading the earlier slots' bits) is one 64-bit word for all
// shards, worked out by every CTA from the slot vectors (fused_live_list:
// 64 threads, a ballot per slot).  A CTA walks the positions of U, the
// union of the words of the counted and materialized slots; every slot is
// zero outside its own word.  A materialized slot is written as a pool
// row (the block pool and slot table of tree_eval.cuh's pool leaf), its
// live blocks only, so the drain's Sum and TopN edges read it through
// their pool walks (K6P, K3P) and K7/K8 through load_pool.  Bound, bytes:
// the live blocks of the leaves read and of the slots written; the
// residency drain (3 pool rows read, 2 slots written, 8 live blocks of 64,
// 960 shards) moves 78.6 MB, 0.0235 ms at 3.35 TB/s.
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUint4PerThread = 8;  // uint4 each thread visits per shard
constexpr int kMaxSlots = 16;       // parallel/kernels.py MAX_FUSED_SLOTS
constexpr int kMaxEdges = 32;       // MAX_FUSED_EDGES
constexpr int kMaxItems = 128;      // MAX_FUSED_ITEMS

// The slot table by value in the parameter space (uniform across the
// grid).  Slot k: the node op[k] over first[k] (ANDNOT's left side: an
// item code or OP_MREF | j << 8; -1 for the other ops, which start from
// their first item, or their identity when they have none), the items
// items[item_off[k] .. + item_len[k]) (OP_LEAF, OP_RANGE, OP_ZERO) and the
// earlier slots of the bit set mref[k].
struct FusedProg {
  int n_slots;
  int n_edges;
  unsigned counted;  // bit k: a count edge reads slot k
  int op[kMaxSlots];
  int first[kMaxSlots];
  int item_off[kMaxSlots];
  int item_len[kMaxSlots];
  unsigned mref[kMaxSlots];
  int mat_row[kMaxSlots];  // row of slot k in the scratch, or -1
  int edge_slot[kMaxEdges];
  const int* gate[kMaxEdges];  // int32[S] per count edge
  int items[kMaxItems];
};

// F1P's live words in shared memory: each slot's, as two ballots, and U,
// the union of the words of the slots an edge reads, with its blocks
// listed in ascending order.
struct FusedLive {
  unsigned int half[kMaxSlots][2];
  LiveBlocks walk;
};

__device__ __forceinline__ unsigned long long slot_word(const FusedLive& live, int k) {
  return live.half[k][0] | ((unsigned long long)live.half[k][1] << 32);
}

// F1P's prologue: threads 0..63 (warps 0 and 1, whole) take one block
// each and evaluate every slot's live bit there (tree_eval.cuh
// slots_live, from the slot vectors: no host read of the slot table), a
// ballot per slot and warp gives the slots' words, and U's blocks are
// listed.  Returns U's block count, the same in every thread.  Every
// thread of the CTA must call it (two barriers).
__device__ __forceinline__ int fused_live_list(const FusedProg& fp, const Leaves& leaves,
                                               FusedLive& live) {
  const int t = threadIdx.x;
  if (t < kPoolBlocks) {
    const unsigned int bits = slots_live(fp, leaves, t);
    for (int k = 0; k < fp.n_slots; ++k) {
      const unsigned int h = __ballot_sync(0xffffffffu, (bits >> k) & 1u);
      if ((t & 31) == 0) live.half[k][t >> 5] = h;
    }
  }
  __syncthreads();
  unsigned long long u = 0ull;
  for (int k = 0; k < fp.n_slots; ++k)
    if (((fp.counted >> k) & 1u) || fp.mat_row[k] >= 0) u |= slot_word(live, k);
  if (t < kPoolBlocks && ((u >> t) & 1ull))
    live.walk.block[__popcll(u & ((1ull << t) - 1ull))] = t;
  __syncthreads();
  return __popcll(u);
}

// The slot table of F1P's pool: entry b of row r is pool slot
// 1 + 64 r + b where materialized slot r is live at block b, else 0.
__device__ __forceinline__ void write_table(const FusedProg& fp, const FusedLive& live,
                                            int* __restrict__ table) {
  const int b = threadIdx.x;
  if (b >= kPoolBlocks) return;
  for (int k = 0; k < fp.n_slots; ++k) {
    const int r = fp.mat_row[k];
    if (r >= 0)
      table[r * kPoolBlocks + b] =
          ((slot_word(live, k) >> b) & 1ull) ? 1 + kPoolBlocks * r + b : 0;
  }
}

// One CTA's work over shard blockIdx.y.  F1 (kLive false) walks every
// position of the shard's rows and writes a materialized slot r whole, to
// row r of `mat` int32[n_mat, S, W].  F1P (kLive true) walks the positions
// of U's blocks only (every slot is zero outside its live word, so no edge
// reads anything there) and writes slot r's live blocks to a block pool
// `mat` int32[1 + 64 n_mat, S, 512], block b to pool slot 1 + 64 r + b,
// with its slot table (write_table).  A block outside the slot's own word
// is never written: its table entry is 0, the pool's shared zero slot.
// kPools compiles the pool leaf in (kRanges for F1, whose host sets it
// for range and pool leaves alike; always for F1P).
template <int kSlots, bool kRanges, bool kLive>
__device__ __forceinline__ void fused_tree_body(const FusedProg& fp, const Leaves& leaves,
                                                const int* __restrict__ need, int w4,
                                                uint4* __restrict__ mat,
                                                int* __restrict__ table,
                                                unsigned long long* __restrict__ out) {
  constexpr bool kPools = kLive || kRanges;
  const int s = blockIdx.y;
  __shared__ FusedLive live;
  int n_pos = w4;
  if constexpr (kLive) {
    // CTA (0, 0) writes the table, so `need` never skips its prologue.
    const bool tabler = (blockIdx.x | blockIdx.y) == 0;
    if (need != nullptr && need[s] == 0 && !tabler) return;  // uniform over the CTA
    n_pos = fused_live_list(fp, leaves, live) * kPoolBlockVec;
    if (tabler) write_table(fp, live, table);
    if (need != nullptr && need[s] == 0) return;
  } else {
    if (need != nullptr && need[s] == 0) return;  // no edge asks for it
  }
  const size_t row_stride = (size_t)gridDim.y * (size_t)w4;  // uint4 per slot row
  const size_t shard_off = (size_t)s * (size_t)w4;
  const int stride = gridDim.x * blockDim.x;
  const int n_slots = fp.n_slots;
  unsigned cnt[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) cnt[k] = 0u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_pos; i += stride) {
    const int blk = kLive ? live.walk.block[i / kPoolBlockVec] : 0;
    const size_t off = shard_off + (kLive ? blk * kPoolBlockVec + i % kPoolBlockVec : i);
    uint4 v[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (k >= n_slots) continue;
      const int op = fp.op[k];
      const int first = fp.first[k];
      uint4 acc;
      int pc = fp.item_off[k];
      const int end = pc + fp.item_len[k];
      if (first < 0 && pc < end) {
        // The first item is the start value, not combined into an
        // identity: a slot of one row then leaves its load unused until a
        // later slot reads it, so the loads of the leading slots (those
        // that read no slot) are all in flight together.
        load_items<1, kRanges, kPools>(fp.items[pc++], leaves, &off, &acc);
      } else if (first < 0) {
        const unsigned id = op == OP_AND ? 0xffffffffu : 0u;
        acc = make_uint4(id, id, id, id);
      } else if ((first & 0xff) == OP_MREF) {
        acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < k; ++q)
          if ((first >> 8) == q) acc = v[q];
      } else {
        load_items<1, kRanges, kPools>(first, leaves, &off, &acc);
      }
      for (; pc < end; ++pc) {
        uint4 x;
        load_items<1, kRanges, kPools>(fp.items[pc], leaves, &off, &x);
        acc = combine4(op, acc, x);
      }
      const unsigned m = fp.mref[k];
#pragma unroll
      for (int q = 0; q < k; ++q)
        if ((m >> q) & 1u) acc = combine4(op, acc, v[q]);
      v[k] = acc;
      if ((fp.counted >> k) & 1u) cnt[k] += popc4(acc);
      const int r = fp.mat_row[k];
      if (kLive) {
        if (r >= 0 && ((live.half[k][blk >> 5] >> (blk & 31)) & 1u))
          mat[((size_t)(1 + kPoolBlocks * r + blk) * gridDim.y + s) * kPoolBlockVec +
              i % kPoolBlockVec] = acc;
      } else if (r >= 0) {
        mat[(size_t)r * row_stride + off] = acc;
      }
    }
  }
  __shared__ unsigned part[kSlots][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (!((fp.counted >> k) & 1u)) continue;
    unsigned x = cnt[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) part[k][warp] = x;
  }
  __syncthreads();
  const int e = threadIdx.x;
  if (e < fp.n_edges && fp.gate[e][s] != 0) {
    const int k = fp.edge_slot[e];
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += part[k][w];
    if (sum) atomicAdd(out + e, sum);
  }
}

template <int kSlots, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    fused_tree_kernel(const FusedProg fp, const Leaves leaves,
                      const int* __restrict__ need, int w4,
                      uint4* __restrict__ mat,
                      unsigned long long* __restrict__ out) {
  fused_tree_body<kSlots, kRanges, false>(fp, leaves, need, w4, mat, nullptr, out);
}

// F1P: F1 over U's live blocks, for a table with pool leaves (rows of the
// full kPoolRowVec), writing its materialized slots as pool rows.
template <int kSlots, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    fused_tree_pool_kernel(const FusedProg fp, const Leaves leaves,
                           const int* __restrict__ need, uint4* __restrict__ pool,
                           int* __restrict__ table, unsigned long long* __restrict__ out) {
  fused_tree_body<kSlots, kRanges, true>(fp, leaves, need, kPoolRowVec, pool, table, out);
}

template <int kSlots>
void launch(bool ranges, dim3 grid, cudaStream_t stream, const FusedProg& fp,
            const Leaves& leaves, const int* need, int w4, uint4* mat,
            unsigned long long* out) {
  if (ranges)
    fused_tree_kernel<kSlots, true><<<grid, kThreads, 0, stream>>>(fp, leaves, need, w4, mat, out);
  else
    fused_tree_kernel<kSlots, false><<<grid, kThreads, 0, stream>>>(fp, leaves, need, w4, mat, out);
}

// F1P's grid: one row of CTAs a shard, as F1, each CTA taking every
// stride-th position of U.  The host cannot know U without reading the
// slot table, so the split is sized as for a full row: at most one
// position a thread of a full row, and no more CTAs a shard than it takes
// to fill the card once (the variant's occupancy); with fewer live blocks
// the CTAs past U's positions find none after the prologue.  At 960 shards
// that is one CTA a shard, whose prologue then serves every position.
template <int kSlots, bool kRanges>
int launch_pool(int n_shards, cudaStream_t stream, const FusedProg& fp, const Leaves& leaves,
                const int* need, uint4* pool, int* table, unsigned long long* out) {
  auto kernel = fused_tree_pool_kernel<kSlots, kRanges>;
  static int fit = 0;
  if (fit == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, 0) != cudaSuccess ||
       fit <= 0))
    fit = 1;
  int chunks = (fit * n_sms() + n_shards - 1) / n_shards;
  if (chunks > kPoolRowVec / kThreads) chunks = kPoolRowVec / kThreads;
  if (chunks < 1) chunks = 1;
  kernel<<<dim3(chunks, n_shards), kThreads, 0, stream>>>(fp, leaves, need, pool, table, out);
  return (int)cudaGetLastError();
}

template <int kSlots>
int launch_pool(bool ranges, int n_shards, cudaStream_t stream, const FusedProg& fp,
                const Leaves& leaves, const int* need, uint4* pool, int* table,
                unsigned long long* out) {
  return ranges ? launch_pool<kSlots, true>(n_shards, stream, fp, leaves, need, pool, table, out)
                : launch_pool<kSlots, false>(n_shards, stream, fp, leaves, need, pool, table, out);
}

// An item code of slot table entries: a leaf (a pool leaf with its slot
// vector) or range leaf within the tables, or zero.
bool item_ok(int code, const void* const* leaf_ptrs, int n_leaves, int n_ranges) {
  const int op = code & 0xff, arg = code >> 8;
  return (op == OP_LEAF && arg >= 0 && arg < n_leaves) ||
         (op == OP_ROWB && arg >= 0 && arg < n_leaves &&
          leaf_ptrs[n_leaves + arg] != nullptr) ||
         (op == OP_RANGE && arg >= 0 && arg < n_ranges) || code == OP_ZERO;
}

// Host side: the launch's slot table and leaf table in the by-value
// parameter structs, checked (fused_tree's arguments, below).  Returns
// cudaSuccess, or cudaErrorInvalidValue for a table past the limits or an
// item, reference or edge that names nothing.
int pack_fused(const void* const* leaf_ptrs, int n_leaves, const void* ranges,
               const int* range_rows, int n_ranges, int n_slots, const int* info,
               const int* items, int n_items, const int* mat_row, int counted, int n_edges,
               const int* edge_slot, const void* const* gates, int n_shards, int words,
               bool has_mat, FusedProg* fp_out, Leaves* leaves) {
  TreeProg unused;
  const int zero = OP_ZERO;
  if (!pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, &zero, 1, &unused,
                 leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (n_slots < 1 || n_slots > kMaxSlots || n_items < 0 || n_items > kMaxItems ||
      n_edges < 0 || n_edges > kMaxEdges || words <= 0 || words % 4 != 0 ||
      n_shards < 0 || n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  FusedProg& fp = *fp_out;
  fp = FusedProg{};
  fp.n_slots = n_slots;
  fp.n_edges = n_edges;
  fp.counted = (unsigned)counted;
  if (fp.counted >> n_slots) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_items; ++i) {
    if (!item_ok(items[i], leaf_ptrs, n_leaves, n_ranges)) return (int)cudaErrorInvalidValue;
    fp.items[i] = items[i];
  }
  for (int k = 0; k < n_slots; ++k) {
    const int op = info[5 * k], first = info[5 * k + 1];
    const int off = info[5 * k + 2], len = info[5 * k + 3];
    const unsigned m = (unsigned)info[5 * k + 4];
    const bool first_ok =
        op == OP_ANDNOT
            ? (item_ok(first, leaf_ptrs, n_leaves, n_ranges) ||
               ((first & 0xff) == OP_MREF && (first >> 8) >= 0 && (first >> 8) < k))
            : first == -1;
    if (op < OP_AND || op > OP_XOR || !first_ok || off < 0 || len < 0 ||
        off + len > n_items || (m >> k) != 0u || mat_row[k] < -1 || mat_row[k] >= n_slots ||
        (mat_row[k] >= 0 && !has_mat))
      return (int)cudaErrorInvalidValue;
    fp.op[k] = op;
    fp.first[k] = first;
    fp.item_off[k] = off;
    fp.item_len[k] = len;
    fp.mref[k] = m;
    fp.mat_row[k] = mat_row[k];
  }
  for (int e = 0; e < n_edges; ++e) {
    const int k = edge_slot[e];
    if (k < 0 || k >= n_slots || !((fp.counted >> k) & 1u) || gates[e] == nullptr)
      return (int)cudaErrorInvalidValue;
    fp.edge_slot[e] = k;
    fp.gate[e] = (const int*)gates[e];
  }
  return (int)cudaSuccess;
}

}  // namespace

// leaf_ptrs, ranges, range_rows: the leaf table as for K1 (tree_eval.cuh
// pack_args).  info: host int32[n_slots][5], per slot (op, first,
// item_off, item_len, mref).  items: host int32[n_items].  mat_row: host
// int32[n_slots], the scratch row of each materialized slot or -1.
// counted: bit k set iff a count edge reads slot k.  edge_slot, gates:
// host arrays of n_edges, each edge's slot and its device int32[S] gate.
// need: device int32[S] or null (every shard).  mat: device int32[n_mat, S,
// W] (null when no slot is materialized).  out: device uint64[n_edges]
// accumulator (zeroed by the caller).  Returns the cudaError_t of the
// launch.
extern "C" int fused_tree(const void* const* leaf_ptrs, int n_leaves,
                          const void* ranges, const int* range_rows, int n_ranges,
                          int n_slots, const int* info, const int* items, int n_items,
                          const int* mat_row, int counted, int n_edges,
                          const int* edge_slot, const void* const* gates,
                          const void* need, int n_shards, int words, void* mat,
                          void* out, void* stream) {
  FusedProg fp;
  Leaves leaves;
  const int err = pack_fused(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, n_slots, info,
                             items, n_items, mat_row, counted, n_edges, edge_slot, gates,
                             n_shards, words, mat != nullptr, &fp, &leaves);
  if (err != (int)cudaSuccess) return err;
  if (n_shards == 0) return (int)cudaSuccess;
  const int w4 = words / 4;
  int chunks = (w4 + kThreads * kUint4PerThread - 1) / (kThreads * kUint4PerThread);
  if (chunks < 1) chunks = 1;
  const dim3 grid(chunks, n_shards);
  const cudaStream_t st = (cudaStream_t)stream;
  bool r = has_extra_leaves(items, n_items, n_ranges);
  for (int k = 0; k < n_slots; ++k) r = r || (fp.first[k] & 0xff) == OP_ROWB;
  const int* nd = (const int*)need;
  uint4* mt = (uint4*)mat;
  unsigned long long* o = (unsigned long long*)out;
  if (n_slots <= 1) launch<1>(r, grid, st, fp, leaves, nd, w4, mt, o);
  else if (n_slots <= 2) launch<2>(r, grid, st, fp, leaves, nd, w4, mt, o);
  else if (n_slots <= 4) launch<4>(r, grid, st, fp, leaves, nd, w4, mt, o);
  else if (n_slots <= 8) launch<8>(r, grid, st, fp, leaves, nd, w4, mt, o);
  else launch<16>(r, grid, st, fp, leaves, nd, w4, mt, o);
  return (int)cudaGetLastError();
}

// F1P: fused_tree's arguments for a table with pool leaves (words the full
// 32768 of a pool row), its materialized slots written as pool rows: pool
// device int32[1 + 64 n_mat, S, 512], slot 0 zero and never written
// (parallel/kernels.py zeroes it before each launch), and table device int32[n_mat, 64],
// written whole (both null when no slot is materialized).
extern "C" int fused_tree_pool(const void* const* leaf_ptrs, int n_leaves,
                               const void* ranges, const int* range_rows, int n_ranges,
                               int n_slots, const int* info, const int* items, int n_items,
                               const int* mat_row, int counted, int n_edges,
                               const int* edge_slot, const void* const* gates,
                               const void* need, int n_shards, int words, void* pool,
                               void* table, void* out, void* stream) {
  FusedProg fp;
  Leaves leaves;
  if ((pool == nullptr) != (table == nullptr) || words != kPoolRowVec * 4)
    return (int)cudaErrorInvalidValue;
  const int err = pack_fused(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, n_slots, info,
                             items, n_items, mat_row, counted, n_edges, edge_slot, gates,
                             n_shards, words, pool != nullptr, &fp, &leaves);
  if (err != (int)cudaSuccess) return err;
  if (n_shards == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool r = n_ranges > 0;
  const int* nd = (const int*)need;
  uint4* pl = (uint4*)pool;
  int* tb = (int*)table;
  unsigned long long* o = (unsigned long long*)out;
  if (n_slots <= 1) return launch_pool<1>(r, n_shards, st, fp, leaves, nd, pl, tb, o);
  if (n_slots <= 2) return launch_pool<2>(r, n_shards, st, fp, leaves, nd, pl, tb, o);
  if (n_slots <= 4) return launch_pool<4>(r, n_shards, st, fp, leaves, nd, pl, tb, o);
  if (n_slots <= 8) return launch_pool<8>(r, n_shards, st, fp, leaves, nd, pl, tb, o);
  return launch_pool<16>(r, n_shards, st, fp, leaves, nd, pl, tb, o);
}
