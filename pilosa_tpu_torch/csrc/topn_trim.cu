// K4 topn_trim: the top n_out of TopN's per-candidate totals, in the order
// jax.lax.top_k gives: value descending, and on equal values the lower
// candidate index first.
//
// Replaces the device trim of pilosa_tpu/parallel/kernels.py:346
// topn_full_tree (jax.lax.top_k(totals, n_out) at :382).  The engine orders
// candidates id-descending, so lower index first on ties reproduces the
// reference's (-count, -id) pair order; a library top-k does not promise
// that tie order.
//
// Design: one block ranks by counting.  The totals (K <= 4096, 32 KiB) are
// staged in shared memory; each thread takes candidates i and counts the j
// that come before them (totals[j] > totals[i], or equal with j < i).  The
// ranks are a permutation of 0..K-1, so candidate i lands at rank(i) when
// that is below n_out, with no sort and no second pass.  All threads read
// the same totals[j] at once (a shared-memory broadcast).
//
// Bound: the inputs are K * 8 bytes and the outputs n_out * 8, a few
// kilobytes; the K * K comparisons (16.8 M at K = 4096, 256 at the main
// path's K = 16) are far below the card's integer rate, so the kernel is
// launch-bound.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCands = 4096;

__global__ void __launch_bounds__(kMaxThreads)
    topn_trim_kernel(const long long* __restrict__ totals, int n, int n_out,
                     int* __restrict__ vals, int* __restrict__ idx) {
  __shared__ long long sv[kMaxCands];
  for (int i = threadIdx.x; i < n; i += blockDim.x) sv[i] = totals[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long v = sv[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const long long w = sv[j];
      rank += (w > v) || (w == v && j < i);
    }
    if (rank < n_out) {
      vals[rank] = (int)v;
      idx[rank] = i;
    }
  }
}

}  // namespace

// totals: device int64[n] (n <= 4096); vals, idx: device int32[n_out]
// (1 <= n_out <= n).  Returns the cudaError_t of the launch.
extern "C" int topn_trim(const void* totals, int n, int n_out, void* vals,
                         void* idx, void* stream) {
  if (n < 1 || n > kMaxCands || n_out < 1 || n_out > n)
    return (int)cudaErrorInvalidValue;
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  topn_trim_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)totals, n, n_out, (int*)vals, (int*)idx);
  return (int)cudaGetLastError();
}
