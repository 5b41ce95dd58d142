// P2 and_popcount_rows: out[k] = popcount(matrix[rows[k]] & row).
//
// Replaces the Pallas kernel scripts/pallas_vs_xla.py:56
// matrix_and_popcount_pallas (counts[r] = popcount(matrix[r] & row) over
// every row of a uint32[R, W] matrix, in blocks of rows).  Its function is
// the candidate scoring of Fragment.top (fragment.go top :1089): one
// shard's device matrix against the src row's segment, K candidate rows.
//
// Bound: device-memory bytes at large K (each listed row 128 KiB read once,
// plus the src row: 8192 rows are 1.07 GB, about 0.32 ms at 3.35 TB/s); the
// AND, popcount and add are three integer instructions per word.  At the
// size Fragment.top calls it with (K = 16 rows, 2.1 MB, 0.0007 ms of
// bytes), it is bound by how fast the card can start enough loads, so the
// design spreads even 16 rows over the whole card.
//
// Design.  The candidate rows are read by index straight from the
// fragment's matrix: rows 0..K-1 when no list is given, else a list that
// travels in the kernel's parameters (up to kMaxListed rows) or, above
// that, in device memory; no [K, W] gather is ever written.  A cluster of
// C CTAs (C in 1, 2, 4, 8; Hopper thread-block clusters) owns a group of G
// rows (G in 1..16).  Each CTA takes 1/C of the words; at each 16-byte
// position it reads the src row once and ANDs it into all G rows in
// registers, so the src is read once per group, not once per row.  The CTA
// reduces its G counts with warp shuffles and shared memory, then the
// cluster's rank 0 sums the C partial counts through distributed shared
// memory and stores the finished counts (cluster_sum, reduce.cuh, shared
// with K3): no atomics, no zeroed output, and a sum in a fixed order.  The
// launcher picks the largest G whose groups, times at most 8 CTAs each,
// fill the card: 16 rows become 16 clusters of 8 CTAs (128 CTAs on 132
// SMs), 8192 rows 512 single CTAs of 16 rows each.
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;   // the portable cluster size limit
constexpr int kMaxListed = 512;  // row indices carried in the parameters

struct RowList {
  int idx[kMaxListed];
};

__device__ __forceinline__ unsigned int popc_and4(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
}

// G rows per cluster, U positions per thread in flight together.
template <int G, int U>
__global__ void __launch_bounds__(kThreads)
    and_popcount_rows_kernel(const uint4* __restrict__ matrix,
                             const uint4* __restrict__ row, RowList listed,
                             int n_listed, const int* __restrict__ dev_rows,
                             int n_out, int w4, int n_chunks,
                             int* __restrict__ out) {
  const int chunk = blockIdx.x % n_chunks;  // the CTA's rank in its cluster
  const int k0 = (blockIdx.x / n_chunks) * G;
  const int n_here = min(G, n_out - k0);
  const uint4* rp[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int k = k0 + (u < n_here ? u : 0);
    const int r = dev_rows != nullptr ? dev_rows[k]
                  : n_listed > 0      ? listed.idx[k]
                                      : k;
    rp[u] = matrix + (size_t)r * (size_t)w4;
  }
  const int begin = (int)((long long)w4 * chunk / n_chunks);
  const int end = (int)((long long)w4 * (chunk + 1) / n_chunks);

  unsigned int acc[G];
#pragma unroll
  for (int u = 0; u < G; ++u) acc[u] = 0u;
  for (int i = begin + threadIdx.x; i < end; i += U * kThreads) {
    uint4 src[U];
    uint4 cand[U][G];
#pragma unroll
    for (int p = 0; p < U; ++p) {
      const int j = i + p * kThreads < end ? i + p * kThreads : i;
      src[p] = __ldg(row + j);
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (u < n_here) cand[p][u] = __ldg(rp[u] + j);
    }
#pragma unroll
    for (int p = 0; p < U; ++p) {
      if (i + p * kThreads >= end) continue;  // a clamped (repeated) position
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (u < n_here) acc[u] += popc_and4(cand[p][u], src[p]);
    }
  }

  // The G counts over the CTA, then over the cluster's C CTAs (reduce.cuh).
  const unsigned int sum = cluster_sum<G, kThreads>(acc, chunk, n_chunks);
  if (chunk == 0 && (int)threadIdx.x < n_here) out[k0 + threadIdx.x] = (int)sum;
}

template <int G, int U>
cudaError_t launch(int chunks, int groups, cudaStream_t stream,
                   const uint4* matrix, const uint4* row, const RowList& listed,
                   int n_listed, const int* dev_rows, int n_out, int w4,
                   int* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = chunks > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, and_popcount_rows_kernel<G, U>, matrix, row,
                            listed, n_listed, dev_rows, n_out, w4, chunks, out);
}

}  // namespace

// matrix: device int32[n_rows, words]; row: device int32[words].  The
// candidate rows are host_rows[0..n_out) (a host array, at most kMaxListed
// entries, copied into the launch's parameters), or dev_rows (device
// int32[n_out]), or, when both are null, rows 0..n_out-1; the caller has
// checked each index against n_rows.  out: device int32[n_out], every entry
// written by the kernel.  Returns the cudaError_t of the launch.
extern "C" int and_popcount_rows(const void* matrix, int n_rows,
                                 const void* row, const int* host_rows,
                                 const void* dev_rows, int n_out, int words,
                                 void* out, void* stream) {
  if (matrix == nullptr || row == nullptr || out == nullptr || words <= 0 ||
      words % 4 != 0 || n_out < 0 || n_rows < 0 ||
      (host_rows != nullptr && (dev_rows != nullptr || n_out > kMaxListed)) ||
      (host_rows == nullptr && dev_rows == nullptr && n_out > n_rows))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  RowList listed;
  const int n_listed = host_rows != nullptr ? n_out : 0;
  for (int k = 0; k < n_listed; ++k) listed.idx[k] = host_rows[k];
  const int w4 = words / 4;
  // The largest group whose clusters can fill the card, else single rows
  // in clusters of 8; never fewer than kThreads positions per CTA.
  int max_chunks = 1;
  while (max_chunks < kMaxCluster && w4 / (2 * max_chunks) >= kThreads) max_chunks *= 2;
  int g = 1, chunks = max_chunks;
  bool found = false;
  for (int cand = 16; cand >= 1 && !found; cand /= 2) {
    const int groups = (n_out + cand - 1) / cand;
    for (int c = 1; c <= max_chunks; c *= 2) {
      if ((long long)groups * c >= n_sms()) {
        g = cand;
        chunks = c;
        found = true;
        break;
      }
    }
  }
  const int groups = (n_out + g - 1) / g;
  if ((long long)groups * chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint4* m = (const uint4*)matrix;
  const uint4* r = (const uint4*)row;
  const int* dr = (const int*)dev_rows;
  int* o = (int*)out;
  cudaError_t err;
  switch (g) {
    case 16: err = launch<16, 1>(chunks, groups, st, m, r, listed, n_listed, dr, n_out, w4, o); break;
    case 8: err = launch<8, 1>(chunks, groups, st, m, r, listed, n_listed, dr, n_out, w4, o); break;
    case 4: err = launch<4, 1>(chunks, groups, st, m, r, listed, n_listed, dr, n_out, w4, o); break;
    case 2: err = launch<2, 2>(chunks, groups, st, m, r, listed, n_listed, dr, n_out, w4, o); break;
    default: err = launch<1, 4>(chunks, groups, st, m, r, listed, n_listed, dr, n_out, w4, o); break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
