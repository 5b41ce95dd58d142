// Shared by count_tree_blocks.cu (K2), score_rows.cu (K3),
// and_popcount_rows.cu (P2) and the launchers that size grids by the
// card's SM count (K1P, K5, K6P, F1P): the SM count, and the reduction
// of a CTA's per-thread counts that K3 and P2 finish across a
// thread-block cluster.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// Host side: the current device's SM count, read once (132, an H100 SXM,
// if the query fails).
static inline int n_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// Sum each of the N per-thread counts `acc` over the CTA (warp shuffles,
// then one sum per count over the warps in shared memory) and, when the CTA
// is rank `rank` of a cluster of `n_ranks` CTAs (Hopper thread-block
// clusters; 1 = no cluster), over the cluster: rank 0 adds the other ranks'
// sums through distributed shared memory, in rank order, so the sum is the
// same every run.  Returns, in threads 0..N-1 of rank 0, the finished sum of
// count threadIdx.x; other threads get an unspecified value.  Every thread
// of every CTA of the cluster must call it: its second cluster barrier keeps
// each CTA's shared memory alive until rank 0 has read it.
template <int N, int kThreads>
__device__ __forceinline__ unsigned int cluster_sum(
    const unsigned int (&acc)[N], int rank, int n_ranks) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned int part[N][kWarps];
  __shared__ unsigned int red[N];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    unsigned int x = acc[u];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) part[u][warp] = x;
  }
  __syncthreads();
  unsigned int x = 0u;
  if (t < N) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += part[t][w];
  }
  if (n_ranks == 1) return x;
  if (t < N) red[t] = x;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  if (rank == 0 && t < N)
    for (int r = 1; r < n_ranks; ++r) x += cluster.map_shared_rank(red, r)[t];
  cluster.sync();
  return x;
}
