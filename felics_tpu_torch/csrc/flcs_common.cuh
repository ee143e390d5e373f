// Shared device helpers of the FLCS kernels (flcs_kscan.cu, flcs_decode.cu):
// the k choice and the row minimum of a k-table row held in registers, each
// as a tree of log2(N) compare levels instead of a chain of N - 1.
#pragma once

#include <cstdint>

namespace flcs {

// Index of the smallest of v[0..K) (K <= N, N a power of two), ties to the
// LARGEST index, as the reference's get_k. Entries at K and past it never
// win: a right subtree that starts at or past K is skipped, so every
// subtree's survivor is a real entry.
template <int N>
__device__ __forceinline__ int argmin_last(const int32_t (&v)[N], int K) {
  int32_t val[N];
  int idx[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    val[j] = v[j];
    idx[j] = j;
  }
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < N; j += 2 * w) {
      if (j + w < K && val[j + w] <= val[j]) {
        val[j] = val[j + w];
        idx[j] = idx[j + w];
      }
    }
  }
  return idx[0];
}

// Smallest of v[0..K), K <= N.
template <int N>
__device__ __forceinline__ int32_t min_of(const int32_t (&v)[N], int K) {
  int32_t val[N];
#pragma unroll
  for (int j = 0; j < N; ++j) val[j] = v[j];
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < N; j += 2 * w) {
      if (j + w < K && val[j + w] < val[j]) val[j] = val[j + w];
    }
  }
  return val[0];
}

}  // namespace flcs
