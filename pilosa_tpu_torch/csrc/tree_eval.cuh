// Shared device code of the two count kernels (count_tree_dense.cu,
// count_tree_blocks.cu): the postfix tree program, the per-thread tree
// evaluation over 16-byte word vectors, and the block reduction.
//
// A normalized count tree (leaves: a row of a field stack, or zero;
// nodes: and / or / andnot / xor) reaches the kernels as a short postfix
// program.  Each thread walks it over one uint4 (four 32-bit words) at a
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
};

// Limits; parallel/kernels.py checks every program against them (and
// raises ValueError) before it launches.
constexpr int MAX_PROG = 128;
constexpr int MAX_LEAVES = 32;
constexpr int MAX_STACK = 16;

struct TreeProg {
  int n;
  int ops[MAX_PROG];
};

// Base of each leaf row: that row's [S, W] words in its field stack.
struct Leaves {
  const uint4* base[MAX_LEAVES];
};

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
// stack in thread-local memory (any program within the limits).
__device__ __forceinline__ uint4 eval_tree(const TreeProg& prog,
                                           const Leaves& leaves, size_t off) {
  uint4 stack[MAX_STACK];
  int sp = 0;
  for (int pc = 0; pc < prog.n; ++pc) {
    const int code = prog.ops[pc];
    const int op = code & 0xff;
    if (op == OP_LEAF) {
      stack[sp++] = __ldg(leaves.base[code >> 8] + off);
    } else if (op == OP_ZERO) {
      stack[sp++] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      const uint4 b = stack[--sp];
      stack[sp - 1] = combine4(op, stack[sp - 1], b);
    }
  }
  return stack[0];
}

__device__ __forceinline__ uint4 load_item(int code, const Leaves& leaves,
                                           size_t off) {
  return (code & 0xff) == OP_LEAF ? __ldg(leaves.base[code >> 8] + off)
                                  : make_uint4(0u, 0u, 0u, 0u);
}

// A chain program is `item (item op)*` with items LEAF or ZERO: the
// left-deep form of every n-ary Intersect/Union/Difference/Xor of rows.
// At most two values are live, so it runs in registers, at U positions
// per thread whose loads are all in flight together.
template <int U>
__device__ __forceinline__ void eval_chain(const TreeProg& prog,
                                           const Leaves& leaves,
                                           const size_t* off, uint4* acc) {
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = load_item(prog.ops[0], leaves, off[u]);
  for (int pc = 1; pc < prog.n; pc += 2) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load_item(prog.ops[pc], leaves, off[u]);
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
    return (code & 0xff) == OP_LEAF || (code & 0xff) == OP_ZERO;
  };
  if (n_ops < 1 || n_ops % 2 == 0 || !item(ops[0])) return false;
  for (int pc = 1; pc < n_ops; pc += 2)
    if (!item(ops[pc]) || item(ops[pc + 1])) return false;
  return true;
}

// Host side: copy the program and leaf pointers into the by-value
// parameter structs.  Returns false when they exceed the limits.
static inline bool pack_args(const void* const* leaf_ptrs, int n_leaves,
                             const int* ops, int n_ops, TreeProg* prog,
                             Leaves* leaves) {
  if (n_ops < 1 || n_ops > MAX_PROG || n_leaves < 0 || n_leaves > MAX_LEAVES)
    return false;
  prog->n = n_ops;
  for (int i = 0; i < n_ops; ++i) prog->ops[i] = ops[i];
  for (int i = 0; i < MAX_LEAVES; ++i)
    leaves->base[i] = i < n_leaves ? (const uint4*)leaf_ptrs[i] : nullptr;
  return true;
}
