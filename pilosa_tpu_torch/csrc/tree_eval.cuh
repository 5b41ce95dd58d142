// Shared device code of the kernels that evaluate a tree (K1
// count_tree_dense.cu, K1P count_tree_pool.cu, K2 count_tree_blocks.cu,
// K3/K3P score_rows.cu, K5/K5P count_batch_tree.cu, K6/K6P sum_tree.cu,
// K7/K7P minmax_tree.cu, K8's and K8P's filters in groupn_tree.cu and
// groupn_tree_pool.cu, F1/F1P fused_tree.cu):
// the postfix tree program, the per-thread tree evaluation over 16-byte
// word vectors, the BSI range leaf, the block-pool leaf and a pool tree's
// (or a fused slot table's) live blocks, and the block reduction.
//
// A normalized count tree (leaves: a row of a field stack, a row of a block
// pool, zero, or a BSI range condition; nodes: and / or / andnot / xor)
// reaches the kernels as
// a short postfix program.  Each thread walks it over one uint4 (four 32-bit words) at a
// time with a small stack, so no intermediate row is ever written to
// device memory: every word of every leaf row is read once, combined in
// registers/L1, popcounted and summed.  The program and the leaf base
// pointers travel by value in the kernel's parameter space (uniform
// across the grid), so a launch needs no device allocation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Opcodes; parallel/kernels.py keeps the same numbers.  A leaf opcode
// carries its leaf index in bits 8 and up.
enum : int {
  OP_LEAF = 0,
  OP_ZERO = 1,
  OP_AND = 2,
  OP_OR = 3,
  OP_ANDNOT = 4,
  OP_XOR = 5,
  OP_RANGE = 6,  // a BSI range leaf; its index into Leaves::range in bits 8+
  OP_MREF = 7,   // an earlier mask slot of a fused program (fused_tree.cu only)
  OP_ROWB = 8,   // a row of a block pool; its leaf index in bits 8+
};

// Range-leaf kinds; parallel/kernels.py keeps the same numbers.
enum : int {
  RANGE_EQ = 0,
  RANGE_NEQ = 1,
  RANGE_LT = 2,
  RANGE_LTE = 3,
  RANGE_GT = 4,
  RANGE_GTE = 5,
  RANGE_BETWEEN = 6,
};

// Limits; parallel/kernels.py checks every program against them (and
// raises ValueError) before it launches.
constexpr int MAX_PROG = 128;
constexpr int MAX_LEAVES = 32;
constexpr int MAX_STACK = 16;
constexpr int MAX_RANGES = 4;   // range leaves per tree
constexpr int MAX_PLANES = 64;  // BSI depth up to 63, then the not-null plane

struct TreeProg {
  int n;
  int ops[MAX_PROG];
};

// The bit planes of one BSI field stack, and for a range leaf the
// condition.  Plane i of a column position `off` (a uint4 offset into one
// row's [S, W] words) is base[plane[i] * stride + off]; plane[depth] is
// the not-null plane, and a plane missing from the stack (-1) reads as
// zeros.  The predicate bits are data (the rebased value, bit i = plane
// i), so one build serves every value.  The planes are stack rows named
// here, never entries of the leaf table.
struct RangeLeaf {
  const uint4* base;         // the stack's row 0
  unsigned long long stride;  // uint4 per stack row (S * W / 4)
  unsigned long long lo;      // the predicate; BETWEEN's lower bound
  unsigned long long hi;      // BETWEEN's upper bound
  int kind;                   // RANGE_*
  int depth;                  // value planes (0..63)
  int plane[MAX_PLANES];
};

// The block pool of a partial stack (parallel/engine.py _promote): int32
// [P, S, 512], slot p holding one 2 KiB occupancy block of some row for
// every shard, slot 0 all zero.  A pool row is its slot vector int32[64]:
// block b of the row, in every shard, is slot slot[b] of the pool.  Pool
// rows are always full width (W = 32768 words, 8192 uint4 per shard).
constexpr int kPoolBlockVec = 128;  // uint4 per 2 KiB block
constexpr int kPoolRowVec = 8192;   // uint4 per [W] row of one shard
constexpr int kPoolBlocks = kPoolRowVec / kPoolBlockVec;  // 64 blocks a row

// Base of each leaf row (that row's [S, W] words in its field stack; for an
// OP_ROWB leaf the pool's slot 0), its slot vector (OP_ROWB leaves only, a
// device int32[64]; null otherwise), the pool's shard count, and the range
// leaves.  The slot vectors stay in device memory, read through the
// read-only cache, so a launch's parameters grow by one pointer a leaf and
// not by the 256 bytes of a vector.
struct Leaves {
  const uint4* base[MAX_LEAVES];
  const int* slot[MAX_LEAVES];
  unsigned int pool_shards;
  RangeLeaf range[MAX_RANGES];
};

// Leaf k of a block pool at uint4 offset `off` of its [S, W] row: the
// block's slot from the slot vector, then that slot's words for the shard.
// The slot is the same for 128 consecutive offsets, so a warp on
// neighbouring offsets takes one branch; a block in slot 0 (empty in every
// shard) reads as zero with no load at all.
__device__ __forceinline__ uint4 load_pool(const Leaves& leaves, int k, size_t off) {
  const size_t s = off / kPoolRowVec;
  const unsigned int w = (unsigned int)(off - s * kPoolRowVec);
  const int slot = __ldg(leaves.slot[k] + (w / kPoolBlockVec));
  if (slot == 0) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(leaves.base[k] +
               ((size_t)slot * leaves.pool_shards + s) * kPoolBlockVec +
               (w % kPoolBlockVec));
}

// The live word (K1P count_tree_pool.cu, K3P score_rows.cu, K6P
// sum_tree.cu, K7P minmax_tree.cu, K8P groupn_tree_pool.cu, K5P
// count_batch_tree.cu, F1P fused_tree.cu).  Block b of a
// pool row sits in slot slot[b] in every shard, so which blocks a tree can
// make non-zero is one 64-bit word for all shards: the tree evaluated on
// one bit a block, a pool leaf live where its slot is not 0, a stack row or
// range leaf live everywhere, zero dead; `and` intersects, `or`/`xor`
// unite, `andnot` keeps its left side (the sparse planner's rules,
// parallel/engine.py _sparse_plan; on the host, parallel/kernels.py
// live_blocks).  K5P unites its leaves' words instead (count_batch_tree.cu).

// Whether block b of the tree's words can be non-zero in some shard: the
// postfix program evaluated on one bit a value, the stack in the bits of a
// register.
__device__ __forceinline__ bool block_live(const TreeProg& prog, const Leaves& leaves, int b) {
  unsigned int stack = 0u;
  int sp = 0;
  for (int pc = 0; pc < prog.n; ++pc) {
    const int code = prog.ops[pc];
    const int op = code & 0xff;
    unsigned int v;
    if (op == OP_LEAF || op == OP_RANGE) {
      v = 1u;
    } else if (op == OP_ZERO) {
      v = 0u;
    } else if (op == OP_ROWB) {
      v = __ldg(leaves.slot[code >> 8] + b) != 0 ? 1u : 0u;
    } else {
      --sp;
      const unsigned int right = (stack >> sp) & 1u;
      const unsigned int left = (stack >> (sp - 1)) & 1u;
      v = op == OP_AND ? (left & right) : op == OP_ANDNOT ? left : (left | right);
      --sp;
    }
    stack = (stack & ~(1u << sp)) | (v << sp);
    ++sp;
  }
  return stack & 1u;
}

// Whether an item of a fused slot (a leaf, range leaf, zero or OP_MREF)
// can be non-zero at block b: the rules above, an OP_MREF where the
// earlier slot it names is (bit j of `earlier`).
__device__ __forceinline__ unsigned int item_live(int code, const Leaves& leaves, int b,
                                                  unsigned int earlier) {
  const int op = code & 0xff;
  if (op == OP_ROWB) return __ldg(leaves.slot[code >> 8] + b) != 0 ? 1u : 0u;
  if (op == OP_MREF) return (earlier >> (code >> 8)) & 1u;
  return op == OP_ZERO ? 0u : 1u;
}

// The live bits at block b of a table of flat slots (F1P, fused_tree.cu
// FusedProg: op, first, item_off, item_len, items, mref), bit k for slot
// k, in table order: block_live generalized to the flat node.  `and`
// intersects its items and referenced slots (all ones with none), `or`
// and `xor` unite them (xor's mref set holds only the slots named an odd
// number of times: parallel/kernels.py compile_fused), `andnot` keeps its
// left side `first`.
template <class Slots>
__device__ __forceinline__ unsigned int slots_live(const Slots& fp, const Leaves& leaves, int b) {
  unsigned int bits = 0u;
  for (int k = 0; k < fp.n_slots; ++k) {
    const int op = fp.op[k];
    unsigned int v;
    if (op == OP_ANDNOT) {
      v = item_live(fp.first[k], leaves, b, bits);
    } else {
      const bool conj = op == OP_AND;
      v = conj ? 1u : 0u;
      const int end = fp.item_off[k] + fp.item_len[k];
      for (int pc = fp.item_off[k]; pc < end; ++pc) {
        const unsigned int x = item_live(fp.items[pc], leaves, b, bits);
        v = conj ? (v & x) : (v | x);
      }
      const unsigned int m = fp.mref[k];
      v = conj ? (v & ((m & ~bits) == 0u ? 1u : 0u)) : (v | ((m & bits) != 0u ? 1u : 0u));
    }
    bits |= v << k;
  }
  return bits;
}

// A CTA's live blocks, in shared memory: the live word's two ballots, and
// the live blocks in ascending order.
struct LiveBlocks {
  unsigned int half[2];
  int block[kPoolBlocks];
};

// The CTA's prologue: threads 0..63 (warps 0 and 1, whole) take one block
// each over the slot vectors (in device memory, read through the read-only
// cache), two warp ballots give the live word, and the live blocks are
// listed in `live` (the caller's shared memory).  Returns how many are
// live, the same in every thread.  No host read of the slot table, no
// extra argument.  Every thread of a CTA of at least kPoolBlocks threads
// must call it (two barriers).
__device__ __forceinline__ int live_block_list(const TreeProg& prog, const Leaves& leaves,
                                               LiveBlocks& live) {
  if (threadIdx.x < kPoolBlocks) {
    const unsigned int bits = __ballot_sync(0xffffffffu, block_live(prog, leaves, threadIdx.x));
    if ((threadIdx.x & 31) == 0) live.half[threadIdx.x >> 5] = bits;
  }
  __syncthreads();
  const unsigned long long word = live.half[0] | ((unsigned long long)live.half[1] << 32);
  if (threadIdx.x < kPoolBlocks && ((word >> threadIdx.x) & 1ull))
    live.block[__popcll(word & ((1ull << threadIdx.x) - 1ull))] = threadIdx.x;
  __syncthreads();
  return __popcll(word);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 andn4(uint4 a, uint4 b) {  // a & ~b
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}

// Plane i of a BSI stack at offset `off`: zeros for a missing plane.
__device__ __forceinline__ uint4 load_plane(const RangeLeaf& r, int i,
                                            size_t off) {
  const int p = r.plane[i];
  return p < 0 ? make_uint4(0u, 0u, 0u, 0u)
               : __ldg(r.base + (size_t)p * r.stride + off);
}

// The range condition at U offsets: the bit-plane walks of
// pilosa_tpu/ops/bsi.py (fragment.go rangeEQ/NEQ/LT/GT/Between), high bit
// first.  The predicate bits are uniform across the grid, so each step's
// branch is too; every plane word is read once per position, the U
// positions' loads in flight together.
template <int U>
__device__ __forceinline__ void eval_range(const RangeLeaf& r, const size_t* off,
                                           uint4* out) {
#define RANGE_PLANE(i, u) load_plane(r, i, off[u])
#include "range_walk.cuh"
#undef RANGE_PLANE
}

__device__ __forceinline__ uint4 combine4(int op, uint4 a, uint4 b) {
  switch (op) {
    case OP_AND:
      return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    case OP_OR:
      return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    case OP_ANDNOT:
      return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
    default:  // OP_XOR
      return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
}

// Evaluate the program at uint4 offset `off` of every leaf row, with the
// stack in thread-local memory (any program within the limits).  kRanges
// false compiles the range and pool leaves out: a kernel launched for a
// program with neither keeps the registers, and the occupancy, it had
// without them (the host picks it with has_extra_leaves).  kPools, kRanges
// unless named, keeps the pool leaf alone (K1P's trees without a range
// leaf).
template <bool kRanges = true, bool kPools = kRanges>
__device__ __forceinline__ uint4 eval_tree(const TreeProg& prog,
                                           const Leaves& leaves, size_t off) {
  uint4 stack[MAX_STACK];
  int sp = 0;
  for (int pc = 0; pc < prog.n; ++pc) {
    const int code = prog.ops[pc];
    const int op = code & 0xff;
    if (op == OP_LEAF) {
      stack[sp++] = __ldg(leaves.base[code >> 8] + off);
    } else if (kRanges && op == OP_RANGE) {
      eval_range<1>(leaves.range[code >> 8], &off, &stack[sp++]);
    } else if (kPools && op == OP_ROWB) {
      stack[sp++] = load_pool(leaves, code >> 8, off);
    } else if (op == OP_ZERO) {
      stack[sp++] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      const uint4 b = stack[--sp];
      stack[sp - 1] = combine4(op, stack[sp - 1], b);
    }
  }
  return stack[0];
}

// One item of a chain (a row, zero or a range leaf) at U offsets.
template <int U, bool kRanges = true, bool kPools = kRanges>
__device__ __forceinline__ void load_items(int code, const Leaves& leaves,
                                           const size_t* off, uint4* v) {
  const int op = code & 0xff;
  if (op == OP_LEAF) {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(leaves.base[code >> 8] + off[u]);
  } else if (kRanges && op == OP_RANGE) {
    eval_range<U>(leaves.range[code >> 8], off, v);
  } else if (kPools && op == OP_ROWB) {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load_pool(leaves, code >> 8, off[u]);
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// A chain program is `item (item op)*` with items LEAF, ROWB, ZERO or RANGE: the
// left-deep form of every n-ary Intersect/Union/Difference/Xor of rows and
// range conditions.  At most two values are live, so it runs in registers,
// at U positions per thread whose loads are all in flight together.
template <int U, bool kRanges = true, bool kPools = kRanges>
__device__ __forceinline__ void eval_chain(const TreeProg& prog,
                                           const Leaves& leaves,
                                           const size_t* off, uint4* acc) {
  load_items<U, kRanges, kPools>(prog.ops[0], leaves, off, acc);
  for (int pc = 1; pc < prog.n; pc += 2) {
    uint4 v[U];
    load_items<U, kRanges, kPools>(prog.ops[pc], leaves, off, v);
    const int op = prog.ops[pc + 1];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = combine4(op, acc[u], v[u]);
  }
}

__device__ __forceinline__ unsigned int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Sum `v` over the block and add it to *out with one atomic.  Every
// thread of the block must call it.
__device__ __forceinline__ void block_add(unsigned int v,
                                          unsigned long long* out) {
  __shared__ unsigned int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(out, (unsigned long long)v);
  }
}

// Host side: whether a program has the chain form of eval_chain.
static inline bool is_chain(const int* ops, int n_ops) {
  auto item = [](int code) {
    return (code & 0xff) == OP_LEAF || (code & 0xff) == OP_ZERO ||
           (code & 0xff) == OP_RANGE || (code & 0xff) == OP_ROWB;
  };
  if (n_ops < 1 || n_ops % 2 == 0 || !item(ops[0])) return false;
  for (int pc = 1; pc < n_ops; pc += 2)
    if (!item(ops[pc]) || item(ops[pc + 1])) return false;
  return true;
}

// Host side: whether a plane table is well formed (depth 0..63, every
// plane -1 or a row of the stack).
static inline bool planes_ok(const RangeLeaf& r, int n_rows) {
  if (r.depth < 0 || r.depth >= MAX_PLANES || (r.base == nullptr && n_rows > 0))
    return false;
  for (int i = 0; i <= r.depth; ++i)
    if (r.plane[i] < -1 || r.plane[i] >= n_rows) return false;
  return true;
}

// Host side: whether a program needs the range/pool leaf paths (kRanges).
static inline bool has_extra_leaves(const int* ops, int n_ops, int n_ranges) {
  if (n_ranges > 0) return true;
  for (int i = 0; i < n_ops; ++i)
    if ((ops[i] & 0xff) == OP_ROWB) return true;
  return false;
}

// Host side: copy the program, the leaf pointers and the range leaves
// (host array of n_ranges RangeLeaf, each with the row count of its stack
// in range_rows) into the by-value parameter structs.  leaf_ptrs holds
// 2 * n_leaves pointers: each leaf's base, then each leaf's slot vector
// (null for a stack row; an OP_ROWB leaf needs one).  n_shards is the
// launch's shard count (the pools' S).  Returns false when they exceed the
// limits or a leaf index or plane is out of bounds.
static inline bool pack_args(const void* const* leaf_ptrs, int n_leaves,
                             const void* ranges, const int* range_rows,
                             int n_ranges, const int* ops, int n_ops,
                             TreeProg* prog, Leaves* leaves, int n_shards) {
  if (n_ops < 1 || n_ops > MAX_PROG || n_leaves < 0 || n_leaves > MAX_LEAVES ||
      n_ranges < 0 || n_ranges > MAX_RANGES || n_shards < 0)
    return false;
  prog->n = n_ops;
  for (int i = 0; i < n_ops; ++i) {
    const int op = ops[i] & 0xff, arg = ops[i] >> 8;
    if ((op == OP_LEAF && (arg < 0 || arg >= n_leaves)) ||
        (op == OP_ROWB && (arg < 0 || arg >= n_leaves ||
                           leaf_ptrs[n_leaves + arg] == nullptr)) ||
        (op == OP_RANGE && (arg < 0 || arg >= n_ranges)) ||
        (op > OP_RANGE && op != OP_ROWB))
      return false;
    prog->ops[i] = ops[i];
  }
  for (int i = 0; i < MAX_LEAVES; ++i) {
    leaves->base[i] = i < n_leaves ? (const uint4*)leaf_ptrs[i] : nullptr;
    leaves->slot[i] = i < n_leaves ? (const int*)leaf_ptrs[n_leaves + i] : nullptr;
  }
  leaves->pool_shards = (unsigned int)n_shards;
  const RangeLeaf* rs = (const RangeLeaf*)ranges;
  for (int i = 0; i < MAX_RANGES; ++i) {
    if (i < n_ranges) {
      if (!planes_ok(rs[i], range_rows[i]) || rs[i].kind < RANGE_EQ ||
          rs[i].kind > RANGE_BETWEEN)
        return false;
      leaves->range[i] = rs[i];
    } else {
      leaves->range[i] = RangeLeaf{};
    }
  }
  return true;
}
