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

template <int kSlots, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    fused_tree_kernel(const FusedProg fp, const Leaves leaves,
                      const int* __restrict__ need, int w4,
                      uint4* __restrict__ mat,
                      unsigned long long* __restrict__ out) {
  const int s = blockIdx.y;
  if (need != nullptr && need[s] == 0) return;  // no edge asks for it
  const size_t row_stride = (size_t)gridDim.y * (size_t)w4;  // uint4 per slot row
  const size_t shard_off = (size_t)s * (size_t)w4;
  const int stride = gridDim.x * blockDim.x;
  const int n_slots = fp.n_slots;
  unsigned cnt[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) cnt[k] = 0u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < w4; i += stride) {
    const size_t off = shard_off + i;
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
        load_items<1, kRanges>(fp.items[pc++], leaves, &off, &acc);
      } else if (first < 0) {
        const unsigned id = op == OP_AND ? 0xffffffffu : 0u;
        acc = make_uint4(id, id, id, id);
      } else if ((first & 0xff) == OP_MREF) {
        acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < k; ++q)
          if ((first >> 8) == q) acc = v[q];
      } else {
        load_items<1, kRanges>(first, leaves, &off, &acc);
      }
      for (; pc < end; ++pc) {
        uint4 x;
        load_items<1, kRanges>(fp.items[pc], leaves, &off, &x);
        acc = combine4(op, acc, x);
      }
      const unsigned m = fp.mref[k];
#pragma unroll
      for (int q = 0; q < k; ++q)
        if ((m >> q) & 1u) acc = combine4(op, acc, v[q]);
      v[k] = acc;
      if ((fp.counted >> k) & 1u) cnt[k] += popc4(acc);
      const int r = fp.mat_row[k];
      if (r >= 0) mat[(size_t)r * row_stride + off] = acc;
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

template <int kSlots>
void launch(bool ranges, dim3 grid, cudaStream_t stream, const FusedProg& fp,
            const Leaves& leaves, const int* need, int w4, uint4* mat,
            unsigned long long* out) {
  if (ranges)
    fused_tree_kernel<kSlots, true><<<grid, kThreads, 0, stream>>>(fp, leaves, need, w4, mat, out);
  else
    fused_tree_kernel<kSlots, false><<<grid, kThreads, 0, stream>>>(fp, leaves, need, w4, mat, out);
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
  TreeProg unused;
  Leaves leaves;
  const int zero = OP_ZERO;
  if (!pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, &zero, 1, &unused,
                 &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (n_slots < 1 || n_slots > kMaxSlots || n_items < 0 || n_items > kMaxItems ||
      n_edges < 0 || n_edges > kMaxEdges || words <= 0 || words % 4 != 0 ||
      n_shards < 0 || n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  FusedProg fp{};
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
        (mat_row[k] >= 0 && mat == nullptr))
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
