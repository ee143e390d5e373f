// Shared device helpers of the FLCT tile codec kernels (flct_encode.cu,
// flct_decode.cu): neighbour rows, k selection, phase-in parameters and
// bounded shifts.
//
// Every shift here is guarded so that a count of 32 or more gives 0 instead
// of undefined behaviour, and all bit arithmetic is unsigned. The k-table is
// uint32 with wrap-around adds (defined behaviour in C++); a valid stream
// never comes near 2^31 there (gray16 at tile 32x32 peaks near 1.3e8).
#pragma once

#include <cstdint>

namespace flct {

// Largest table the kernels hold per thread: nb = 6 context buckets
// (config.QCTX_CAP + 1) times K = 15 k values (16-bit depth).
constexpr int kMaxBuckets = 6;
constexpr int kMaxK = 15;

__device__ __forceinline__ uint32_t shl32(uint32_t v, int s) {
  return s < 32 ? (v << s) : 0u;
}

__device__ __forceinline__ uint32_t shr32(uint32_t v, int s) {
  return s < 32 ? (v >> s) : 0u;
}

__device__ __forceinline__ int bit_length64(uint64_t x) {
  return x ? 64 - __clzll(static_cast<long long>(x)) : 0;
}

// The two causal neighbours of pixel j >= 2 of a th x tw plane, as in
// felics_tpu/core/context.py::neighbour_indices (tw >= 2 always holds:
// tiles are at least 2x2).
__device__ __forceinline__ void neighbours(int j, int tw, int* a, int* b) {
  const int x = j % tw, y = j / tw;
  if (x > 0 && y > 0) {
    *a = j - 1;
    *b = j - tw;
  } else if (y == 0) {
    *a = j - 1;
    *b = j - 2;
  } else if (y >= 2) {
    *a = j - tw;
    *b = j - 2 * tw;
  } else {
    *a = j - tw;
    *b = j - tw + 1;
  }
}

// Context bucket min(bit_length(ctx), nb - 1).
__device__ __forceinline__ int bucket_of(uint64_t ctx, int nb) {
  const int bl = bit_length64(ctx);
  return bl < nb - 1 ? bl : nb - 1;
}

// Index of the smallest cost in the row; ties go to the LARGEST k.
__device__ __forceinline__ int k_select(const uint32_t* row, int K) {
  uint32_t best = row[0];
  int kb = 0;
  for (int k = 1; k < K; ++k) {
    if (row[k] <= best) {
      best = row[k];
      kb = k;
    }
  }
  return kb;
}

// Out-of-range update: every k column of the bucket's row grows by the
// Rice length of v at that k.
__device__ __forceinline__ void k_update(uint32_t* row, int K, uint64_t v) {
  for (int k = 0; k < K; ++k) {
    row[k] += static_cast<uint32_t>((v >> k) + 1 + k);
  }
}

// Phase-in code over n = ctx + 1 symbols: m = floor(log2 n); the first
// right_p values take m bits, the rest m + 1.
struct PhaseIn {
  uint64_t n, left_p, right_p;
  int m;
  __device__ __forceinline__ explicit PhaseIn(uint64_t ctx) {
    n = ctx + 1;
    m = bit_length64(n) - 1;
    left_p = n - (1ull << m);
    right_p = (1ull << (m + 1)) - n;
  }
};

}  // namespace flct
