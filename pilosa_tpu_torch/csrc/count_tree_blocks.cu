// K2 count_tree_blocks: Count(tree) over only the marked 2 KiB occupancy
// blocks of each shard.
//
// Replaces the Pallas kernel pilosa_tpu/parallel/sparse.py:164
// _pallas_shard_count (entered by count_tree_blocks_pallas :233): for each
// shard it reads the listed blocks (512 words) of every leaf row, combines
// them through the tree, popcounts and sums.  The Pallas kernel needed
// host-built block lists (blk_idx int32[S, Kb] padded to power-of-two
// tiers, blk_n int32[S]) because the TPU's scalar prefetch brings indices
// ahead of its sequential grid.  Here the shard's own occupancy word is
// the list: bit b of blk_bits[s] means "read block b of shard s", with the
// requested-shard mask folded in as 0 words by the caller.
//
// Bound: device-memory bytes, n_leaves * (set bits) * 2 KiB read once, plus
// the S * 8 bytes of blk_bits and the result: 2 leaves * ~1918 blocks *
// 2 KiB = 7.9 MB for the sparse north-star Intersect over 960 shards, about
// 2.4 us at 3.35 TB/s.  At that size the kernel's own fixed costs (launch,
// one round trip per load, the final reduction) are of the same order, so
// the design keeps them few.
//
// Design.  A CTA of 512 threads takes four shards at a time, 128 threads
// each, so that thread p of a group reads 16-byte position p of every
// marked block of its shard (128 x 16 bytes = one 2 KiB block, neighbouring
// threads on neighbouring addresses); the grid holds up to 2048 threads per
// SM and strides over the shards past that.  The group reads its shard's
// word once (one broadcast load), takes up to four set bits with __ffsll
// and, for chain programs (eval_chain), has the loads of all of them and of
// every leaf in flight together: a shard of up to four marked blocks costs
// one round trip to memory, not one per block.  Other trees run the
// interpreter of tree_eval.cuh one block at a time.  Counts stay in
// registers across blocks and shards; each CTA reduces once and adds its
// sum and its arrival into one 64-bit scratch word (sum in the low 48 bits,
// arrivals in the high 16) with one atomic: the CTA that sees every other
// arrival holds the whole count, stores it and resets the word.  So the
// output needs no zeroing and the word is 0 again for the next launch; the
// wrapper keeps one word per device and stream, so the launches that share
// one run one after another.
#include "reduce.cuh"
#include "tree_eval.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockWords = 512;                // words per occupancy block
constexpr int kBlockVec = kBlockWords / 4;      // uint4 per block
constexpr int kGroups = kThreads / kBlockVec;   // shards per CTA at a time
constexpr int kInFlight = 4;                    // marked blocks read together
constexpr int kSumBits = 48;                    // of the scratch word; arrivals above
constexpr unsigned long long kArrival = 1ull << kSumBits;
constexpr int kCtasPerSm = 2048 / kThreads;  // the SM's thread limit

__device__ __forceinline__ unsigned long long block_sum64(unsigned long long v) {
  __shared__ unsigned long long warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  unsigned long long t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
  return t;  // the same in every thread
}

// Take up to U set bits off *bits (at least one is set) and count the
// chain program over those blocks at `pos` (the thread's position in the
// shard's words), with the loads of all U blocks and every leaf in flight
// together.  Slots past the last set bit repeat the first block's address
// and are not counted.
template <int U, bool kRanges>
__device__ __forceinline__ unsigned int chain_blocks(const TreeProg& prog,
                                                     const Leaves& leaves,
                                                     size_t pos,
                                                     unsigned long long* bits) {
  size_t off[U];
  off[0] = pos + (size_t)(__ffsll((long long)*bits) - 1) * kBlockVec;
  *bits &= *bits - 1;
  int n = 1;
#pragma unroll
  for (int u = 1; u < U; ++u) {
    if (*bits) {
      off[u] = pos + (size_t)(__ffsll((long long)*bits) - 1) * kBlockVec;
      *bits &= *bits - 1;
      n = u + 1;
    } else {
      off[u] = off[0];
    }
  }
  uint4 acc[U];
  eval_chain<U, kRanges>(prog, leaves, off, acc);
  unsigned int count = 0;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < n) count += popc4(acc[u]);
  return count;
}

template <bool kChain, bool kRanges>
__global__ void __launch_bounds__(kThreads)
    count_tree_blocks_kernel(TreeProg prog, Leaves leaves,
                             const unsigned long long* __restrict__ blk_bits,
                             unsigned long long valid, int n_shards, int w4,
                             unsigned long long* __restrict__ word,
                             unsigned long long* __restrict__ out) {
  const int group = threadIdx.x / kBlockVec;  // the shard slot of the thread
  const int vec = threadIdx.x % kBlockVec;    // its 16-byte position in a block
  unsigned int count = 0;
  for (int s = blockIdx.x * kGroups + group; s < n_shards; s += gridDim.x * kGroups) {
    unsigned long long bits = blk_bits[s] & valid;
    const size_t pos = (size_t)s * (size_t)w4 + vec;
    while (bits) {  // uniform in the group: its threads hold the same word
      if (kChain && __popcll(bits) <= 2) {
        count += chain_blocks<2, kRanges>(prog, leaves, pos, &bits);
      } else if (kChain) {
        count += chain_blocks<kInFlight, kRanges>(prog, leaves, pos, &bits);
      } else {
        const int b = __ffsll((long long)bits) - 1;
        bits &= bits - 1;
        count += popc4(eval_tree<kRanges>(prog, leaves, pos + (size_t)b * kBlockVec));
      }
    }
  }

  // One reduction per CTA, then one atomic that adds the CTA's sum and
  // counts its arrival; the last to arrive stores the count.
  const unsigned long long mine = block_sum64(count);
  if (threadIdx.x == 0) {
    const unsigned long long old = atomicAdd(word, kArrival | mine);
    if ((old >> kSumBits) == gridDim.x - 1u) {
      *out = (old + mine) & (kArrival - 1);
      *word = 0ull;  // every CTA has arrived: ready for the next launch
    }
  }
}

}  // namespace

// leaf_ptrs: host array of n_leaves device pointers, each the [S, W] words
// of one leaf row.  ranges, range_rows, n_ranges: the range leaves, as in
// count_tree_dense.  ops: host array of n_ops postfix opcodes.  blk_bits:
// device uint64[S], bit b of word s marks block b of shard s (0 for an
// unrequested shard).  scratch: device uint64[1], zeroed once when
// allocated and left at 0 by every launch; launches that share it must run
// one after another (one stream).  out: device uint64[1], written by the
// kernel.  Returns the cudaError_t of the launch.
extern "C" int count_tree_blocks(const void* const* leaf_ptrs, int n_leaves,
                                 const void* ranges, const int* range_rows,
                                 int n_ranges, const int* ops, int n_ops,
                                 const void* blk_bits, int n_shards, int words,
                                 void* scratch, void* out, void* stream) {
  TreeProg prog;
  Leaves leaves;
  if (!pack_args(leaf_ptrs, n_leaves, ranges, range_rows, n_ranges, ops, n_ops, &prog,
                 &leaves, n_shards))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = words / kBlockWords;
  // The count must fit the scratch word's 48 sum bits: at most one per bit.
  if (words <= 0 || words % kBlockWords != 0 || n_blocks > 64 || n_shards < 0 ||
      (unsigned long long)n_shards * (unsigned long long)words * 32ull >= kArrival ||
      (blk_bits == nullptr && n_shards > 0) || scratch == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned long long valid = n_blocks == 64 ? ~0ull : (1ull << n_blocks) - 1;
  // kGroups shards per CTA, at most kCtasPerSm CTAs per SM (and fewer than
  // 2^16, the arrival field); at least one CTA, which stores 0 for no shards.
  int ctas = (n_shards + kGroups - 1) / kGroups;
  if (ctas > kCtasPerSm * n_sms()) ctas = kCtasPerSm * n_sms();
  if (ctas > 65535) ctas = 65535;
  if (ctas < 1) ctas = 1;
  const unsigned long long* bits = (const unsigned long long*)blk_bits;
  const bool extra = has_extra_leaves(ops, n_ops, n_ranges);
  auto kernel = is_chain(ops, n_ops)
                    ? (extra ? count_tree_blocks_kernel<true, true>
                             : count_tree_blocks_kernel<true, false>)
                    : (extra ? count_tree_blocks_kernel<false, true>
                             : count_tree_blocks_kernel<false, false>);
  kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      prog, leaves, bits, valid, n_shards, words / 4, (unsigned long long*)scratch,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
