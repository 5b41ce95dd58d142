// K8 groupn_tree: GroupBy's combination counts, every combination in one
// launch.
//
// Replaces the XLA program pilosa_tpu/parallel/kernels.py:707 groupn_tree:
// for n group fields (1 <= n <= kMaxFields), each a field stack
// int32[R_i, S, W] with K_i listed rows, and an optional filter tree,
//   out[k_1, ..., k_n] = sum over requested shards of
//       popcount(filter & row_1[k_1] & ... & row_n[k_n])
// as uint64[K_1 * ... * K_n], row-major, at most kMaxCombos combinations.
// A listed row of -1 (a row the stack lacks) reads as zeros.
//
// Bound: device-memory bytes.  Each listed row of each requested shard is
// read from device memory once, plus the filter's leaf rows (config 5's
// 8-way GroupBy, 4 x 2 rows over 960 shards: 6 x 960 x 128 KiB = 0.755 GB,
// about 0.225 ms at 3.35 TB/s).  The work per word is an AND and a
// popcount per combination, below the card's integer rate up to a few
// hundred combinations.
//
// Design.  The XLA version learned that each field row must stream from
// device memory once, not once per combination (kernels.py:718-723).  Here
// a CTA takes a tile of one shard's words (grid: tiles, shards; a CTA of an
// unrequested shard returns before it reads anything), and each thread
// holds U positions (16-byte vectors, neighbouring threads on neighbouring
// addresses).  It evaluates the filter once per position (tree_eval.cuh:
// the chain form in registers, else the interpreter; range leaves only in
// the kRanges build), then walks the combinations depth first with one
// running AND per level held in registers (the levels are a template
// recursion, so a prefix is shared by every combination under it).  The
// host puts the field with the most rows first and gives each level its
// stride in the row-major output, so the order of the fields does not
// matter.  Two forms of that walk:
//
// - Registers (the shallow shapes: at most kRegFields fields, the first
//   level listing at most kRegK0 rows and every later one at most kRegK,
//   so at most 32 combinations).  At the start of a pass each thread loads
//   every listed row's words at its positions into registers, all loads
//   issued together, so each listed row of the tile comes on chip once per
//   pass (3-field 4 x 2 x 2: 8 row loads a position, where the walk below
//   issues 28), and the walk reads registers only.  Every combination
//   counts into a per-thread register counter across all passes; the warp
//   sum and the add into shared memory run once per CTA, not once per
//   combination and pass.  The levels' row capacities are compile-time, so
//   every register index is a constant; a level lists fewer rows by
//   skipping slots.
// - The walk (every other shape, up to 8 fields and 1024 combinations):
//   the field with the most rows is level 0 too, and the deeper levels'
//   listed rows (at most 32 at C <= 1024 with the largest field first)
//   are staged once per pass: each thread copies its own positions of each
//   such row into shared memory with 16-byte asynchronous copies
//   (cp.async, all issued together, no barrier since a thread reads only
//   what it copied), and level 0's rows stream from device memory, the
//   next one loaded while the current one's subtree is walked.  So each
//   listed row of the tile comes on chip once per pass, where the walk
//   before re-read a deeper row from L2 for each prefix above it (32 x 32:
//   1024 row loads a position for 64 rows).  One position per thread and
//   pass (4 for one field, where nothing is staged), so the stage is 4 KiB
//   a row.  At the last level each combination's popcount is summed over
//   the warp (redux.sync) and lane 0 adds it to the warp's counter row in
//   shared memory, uint32[warps][C].  At the end the CTA sums its warps'
//   rows.
//
// Either way the CTA adds each nonzero combination to the output with one
// 64-bit atomic.  The listed row indices come from a device table.  The
// walks live in groupn_tree.cuh, shared with K8P (groupn_tree_pool.cu).
#include "groupn_tree.cuh"

namespace {

// The register form (module comment): N levels in f, each within its
// capacity, the fields' rows of this shard held per pass in registers and
// the counts per thread.
template <int N, int kFilter, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    groupn_tree_kernel_regs(TreeProg prog, Leaves leaves, Fields f,
                      const int* __restrict__ idx, const int* __restrict__ mask,
                      int w4, unsigned long long* __restrict__ out) {
  constexpr int U = reg_u(N);
  constexpr int kRows = kRegK0 + (N - 1) * kRegK;
  constexpr int kCombos = kRegK0 << (N - 1);  // kRegK = 2
  static_assert(kRegK == 2 && N <= kRegFields, "the capacity shape");
  const int s = blockIdx.y;
  if (mask[s] == 0) return;  // unrequested shard: no reads at all
  __shared__ unsigned int part[kWarps][kCombos];
  const size_t row_stride = (size_t)gridDim.y * (size_t)w4;
  const size_t shard_off = (size_t)s * (size_t)w4;
  // Each slot's row in this shard, or null (a row of -1, an unused slot).
  const uint4* rp[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int L = q < kRegK0 ? 0 : 1 + (q - kRegK0) / kRegK;
    const int k = q < kRegK0 ? q : (q - kRegK0) % kRegK;
    const int r = k < f.k[L] ? __ldg(idx + f.start[L] + k) : -1;
    rp[q] = r < 0 ? nullptr : f.base[L] + (size_t)r * row_stride + shard_off;
  }
  unsigned int cnt[kCombos];
#pragma unroll
  for (int v = 0; v < kCombos; ++v) cnt[v] = 0u;
  constexpr int kPass = kThreads * U;
  for (int base = blockIdx.x * kPass; base < w4; base += gridDim.x * kPass) {
    int j[U];
    size_t off[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      j[u] = base + u * kThreads + threadIdx.x;
      ok[u] = j[u] < w4;
      if (!ok[u]) j[u] = base;
      off[u] = shard_off + j[u];
    }
    uint4 row[kRows][U];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int u = 0; u < U; ++u)
        row[q][u] = rp[q] != nullptr ? __ldg(rp[q] + j[u]) : make_uint4(0u, 0u, 0u, 0u);
    uint4 acc[U];
    filter_words<U, kFilter, kRanges>(prog, leaves, off, ok, acc);
    reg_walk<0, N, U, kRows, kCombos>(acc, row, f, 0, cnt);
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < kCombos; ++v) {
    const unsigned int x = __reduce_add_sync(0xffffffffu, cnt[v]);
    if (lane == 0) part[threadIdx.x >> 5][v] = x;
  }
  __syncthreads();
  const int v = threadIdx.x;
  if (v < kCombos) {
    // v's digits, last level lowest: its place in the row-major output.
    int c = 0, rest = v;
    bool listed = true;
#pragma unroll
    for (int L = N - 1; L >= 0; --L) {
      const int cap = L == 0 ? kRegK0 : kRegK;
      const int k = rest % cap;
      rest /= cap;
      listed = listed && k < f.k[L];
      c += k * f.stride[L];
    }
    unsigned long long sum = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][v];
    if (listed && sum) atomicAdd(out + c, sum);
  }
}

// The walk (module comment).  kFilter: 0 none (every column), 1 a chain
// program, 2 any other tree.
template <int N, int kFilter, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    groupn_tree_kernel(TreeProg prog, Leaves leaves, Fields f,
                       const int* __restrict__ idx, int n_idx, int n_combos,
                       const int* __restrict__ mask, int w4,
                       unsigned long long* __restrict__ out) {
  constexpr int U = walk_u(N);
  constexpr int kPass = kThreads * U;
  const int s = blockIdx.y;
  if (mask[s] == 0) return;  // unrequested shard: no reads at all
  // Dynamic shared memory: the stage [deeper rows][kPass], the row table,
  // then the warps' counter rows [kWarps][n_combos].
  extern __shared__ uint4 smem[];
  const int n_stage = n_idx - f.k[0];
  uint4* stage = smem;
  int* table = (int*)(stage + (size_t)n_stage * kPass);
  unsigned int* warp_counts = (unsigned int*)(table + n_idx);
  for (int i = threadIdx.x; i < n_idx; i += kThreads) table[i] = idx[i];
  for (int i = threadIdx.x; i < kWarps * n_combos; i += kThreads) warp_counts[i] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned int* counts = warp_counts + (threadIdx.x >> 5) * n_combos;
  const size_t row_stride = (size_t)gridDim.y * (size_t)w4;
  const size_t shard_off = (size_t)s * (size_t)w4;
  // A deeper row of -1 is zeros in the stage, written once: no copy
  // lands in its slot.
  for (int q = 0; q < n_stage; ++q)
    if (table[f.k[0] + q] < 0)
#pragma unroll
      for (int u = 0; u < U; ++u)
        stage[(size_t)q * kPass + u * kThreads + threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  // Every thread of the CTA runs the same passes (positions past the row
  // read a valid word and count nothing), so each warp reduces with all
  // of its lanes.
  for (int base = blockIdx.x * kPass; base < w4; base += gridDim.x * kPass) {
    int j[U];
    size_t off[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      j[u] = base + u * kThreads + threadIdx.x;
      ok[u] = j[u] < w4;
      if (!ok[u]) j[u] = base;
      off[u] = shard_off + j[u];
    }
    // The deeper levels' rows of this tile, each copied once.
#pragma unroll
    for (int L = 1; L < N; ++L)
      for (int k = 0; k < f.k[L]; ++k) {
        const int r = table[f.start[L] + k];
        if (r < 0) continue;
        const uint4* row = f.base[L] + (size_t)r * row_stride + shard_off;
        uint4* dst = stage + (size_t)(f.start[L] - f.k[0] + k) * kPass + threadIdx.x;
#pragma unroll
        for (int u = 0; u < U; ++u) copy16_async(dst + u * kThreads, row + j[u]);
      }
    uint4 acc[U];
    filter_words<U, kFilter, kRanges>(prog, leaves, off, ok, acc);
    if constexpr (N > 1) copies_wait();
    walk<0, N, U>(acc, f, table, row_stride, off, stage, 0, counts, lane);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_combos; c += kThreads) {
    unsigned long long sum = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_counts[w * n_combos + c];
    if (sum) atomicAdd(out + c, sum);
  }
}

template <int N>
int launch(int filter, bool ranges, dim3 grid, size_t smem, const TreeProg& prog,
           const Leaves& leaves, const Fields& f, const int* idx, int n_idx,
           int n_combos, const int* mask, int w4, unsigned long long* out,
           cudaStream_t st) {
  auto kernel = filter == 0   ? groupn_tree_kernel<N, 0, false>
                : filter == 1 ? (ranges ? groupn_tree_kernel<N, 1, true>
                                        : groupn_tree_kernel<N, 1, false>)
                              : (ranges ? groupn_tree_kernel<N, 2, true>
                                        : groupn_tree_kernel<N, 2, false>);
  // Past the default 48 KiB each variant is allowed more once, as needed.
  static size_t allowed[5] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  const int variant = filter == 0 ? 0 : 2 * filter - 1 + (ranges ? 1 : 0);
  if (smem > allowed[variant]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[variant] = smem;
  }
  kernel<<<grid, kThreads, smem, st>>>(prog, leaves, f, idx, n_idx, n_combos, mask,
                                       w4, out);
  return (int)cudaGetLastError();
}

template <int N>
void launch_reg(int filter, bool ranges, dim3 grid, const TreeProg& prog,
                const Leaves& leaves, const Fields& f, const int* idx, const int* mask,
                int w4, unsigned long long* out, cudaStream_t st) {
  auto kernel = filter == 0   ? groupn_tree_kernel_regs<N, 0, false>
                : filter == 1 ? (ranges ? groupn_tree_kernel_regs<N, 1, true>
                                        : groupn_tree_kernel_regs<N, 1, false>)
                              : (ranges ? groupn_tree_kernel_regs<N, 2, true>
                                        : groupn_tree_kernel_regs<N, 2, false>);
  kernel<<<grid, kThreads, 0, st>>>(prog, leaves, f, idx, mask, w4, out);
}

// The grid: about eight CTAs per SM, or one per tile of kThreads * u
// vectors where a shard has fewer.
dim3 grid_of(int w4, int u, int n_shards) {
  const int tiles = (w4 + kThreads * u - 1) / (kThreads * u);
  int per_shard = (n_sms() * 8 + n_shards - 1) / n_shards;
  if (per_shard > tiles) per_shard = tiles;
  if (per_shard < 1) per_shard = 1;
  return dim3(per_shard, n_shards);
}

}  // namespace

// leaf_ptrs, ranges, range_rows, ops: the filter tree as in
// count_tree_dense, or n_ops = 0 for no filter (every column).
// field_ptrs: host array of n_fields device pointers, each a group field's
// stack int32[R_i, S, W] (contiguous, the same S and W), in level order.
// field_k: host array of the K_i; field_stride: host array, field i's
// stride in the row-major output.  regs: 1 for the register form (K_0 <= 4,
// every later K_i <= 2, at most 4 fields), 0 for the walk (its stage must
// fit in shared memory: put the field with the most rows first).  idx:
// device int32[sum K_i], the listed stack rows of every field in the order
// given, each in [-1, R_i) (the caller checks the bounds).  mask: device
// int32[S].  out: device uint64[prod K_i], zeroed by the caller.  Returns
// the cudaError_t of the launch.
extern "C" int groupn_tree(const void* const* leaf_ptrs, int n_leaves,
                           const void* ranges, const int* range_rows, int n_ranges,
                           const int* ops, int n_ops, const void* const* field_ptrs,
                           const int* field_k, const int* field_stride, int regs,
                           int n_fields, const void* idx, const void* mask, int n_shards,
                           int words, void* out, void* stream) {
  TreeProg prog = {};
  Leaves leaves = {};
  const bool filter = n_ops > 0;
  if (filter && !pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops,
                           n_ops, &prog, &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  if (idx == nullptr || out == nullptr || words <= 0 || words % 4 != 0 || n_shards < 0 ||
      n_shards > 65535)
    return (int)cudaErrorInvalidValue;
  Fields f = {};
  int n_idx = 0, n_combos = 1;
  size_t smem = 0;
  const int u = regs ? reg_u(n_fields) : walk_u(n_fields);
  if (!pack_fields(field_ptrs, field_k, field_stride, regs, n_fields, u, &f, &n_idx, &n_combos,
                   &smem))
    return (int)cudaErrorInvalidValue;
  if (n_shards == 0) return (int)cudaSuccess;
  const int w4 = words / 4;
  const int kind = !filter ? 0 : is_chain(ops, n_ops) ? 1 : 2;
  const bool rg = filter && has_extra_leaves(ops, n_ops, n_ranges);
  const int* ix = (const int*)idx;
  const int* m = (const int*)mask;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = grid_of(w4, u, n_shards);
  if (regs) {
    switch (n_fields) {
      case 1: launch_reg<1>(kind, rg, grid, prog, leaves, f, ix, m, w4, o, st); break;
      case 2: launch_reg<2>(kind, rg, grid, prog, leaves, f, ix, m, w4, o, st); break;
      case 3: launch_reg<3>(kind, rg, grid, prog, leaves, f, ix, m, w4, o, st); break;
      default: launch_reg<4>(kind, rg, grid, prog, leaves, f, ix, m, w4, o, st); break;
    }
    return (int)cudaGetLastError();
  }
  switch (n_fields) {
    case 1: return launch<1>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
    case 2: return launch<2>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
    case 3: return launch<3>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
    case 4: return launch<4>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
    case 5: return launch<5>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
    case 6: return launch<6>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
    case 7: return launch<7>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
    default: return launch<8>(kind, rg, grid, smem, prog, leaves, f, ix, n_idx, n_combos, m, w4, o, st);
  }
}
