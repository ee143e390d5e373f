// Shared device helpers of the FLCT tile codec kernels (flct_encode.cu,
// flct_decode.cu): context buckets, k-table rows in registers, k selection
// and phase-in parameters.
//
// All bit arithmetic is unsigned. The k-table is
// uint32 with wrap-around adds (defined behaviour in C++); a valid stream
// never comes near 2^31 there (gray16 at tile 32x32 peaks near 1.3e8).
#pragma once

#include <cstdint>

namespace flct {

// Context buckets of the k-table: nb <= 6 (config.QCTX_CAP + 1). The k
// count K is a template constant of each kernel: 6 (8-bit) or 15 (16-bit).
constexpr int kMaxBuckets = 6;

// Context bucket min(bit_length(ctx), nb - 1).
__device__ __forceinline__ int bucket_of(uint32_t ctx, int nb) {
  const int bl = 32 - __clz(static_cast<int>(ctx));
  return bl < nb - 1 ? bl : nb - 1;
}

// A k-table row of K entries, `stride` uint32 apart, into registers and
// back.
template <int K>
__device__ __forceinline__ void load_row(const uint32_t* p, int stride, uint32_t (&r)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] = p[k * stride];
}

template <int K>
__device__ __forceinline__ void store_row(uint32_t* p, int stride, const uint32_t (&r)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) p[k * stride] = r[k];
}

// Index of the smallest cost in the row; ties go to the LARGEST k. A tree
// of ceil(log2 K) compare levels: each subtree keeps its last minimum, and
// the right one wins a tie.
template <int K>
__device__ __forceinline__ int k_select(const uint32_t (&r)[K]) {
  uint32_t val[K];
  int idx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    val[k] = r[k];
    idx[k] = k;
  }
#pragma unroll
  for (int w = 1; w < K; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < K; j += 2 * w) {
      if (val[j + w] <= val[j]) {
        val[j] = val[j + w];
        idx[j] = idx[j + w];
      }
    }
  }
  return idx[0];
}

// Out-of-range update: every k column grows by the Rice length of v at k.
template <int K>
__device__ __forceinline__ void k_update(uint32_t (&r)[K], uint32_t v) {
#pragma unroll
  for (int k = 0; k < K; ++k) r[k] += (v >> k) + 1 + k;
}

// Phase-in code over n = ctx + 1 symbols: m = floor(log2 n); the first
// right_p values take m bits, the rest m + 1. n reaches 2^32 only for a
// context of 2^32 - 1.
struct PhaseIn {
  uint64_t n, left_p, right_p;
  int m;
  __device__ __forceinline__ explicit PhaseIn(uint32_t ctx) {
    n = static_cast<uint64_t>(ctx) + 1;
    m = ctx == 0xFFFFFFFFu ? 32 : 31 - __clz(static_cast<int>(ctx + 1));
    left_p = n - (1ull << m);
    right_p = (1ull << (m + 1)) - n;
  }
};

}  // namespace flct
