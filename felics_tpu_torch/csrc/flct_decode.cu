// FLCT tile decoder, one CUDA thread per tile (lane = tile, as on the TPU).
//
// Replaces felics_tpu/ops/pallas_codec.py::_decode_kernel_body (launched by
// _decode_tiles_pallas, public wrapper decode_tiles): the inverse of
// flct_encode.cu on each tile's word row, which is zero past its byte
// length. Per plane it reads the raw preamble (sign-extended for Co/Cg),
// resets the k-table from the prior, then per pixel reads the marker and
// either the phase-in value or the unary run plus k remainder bits, and
// updates the table exactly as the encoder does.
//
// Corrupt input stays inside the tile's row and terminates: the context is
// clipped to max_context before use, every read past 32*W bits gives zero
// bits, the unary run stops at bit 32*W, the Rice value is formed in 64
// bits, and a decoded value outside int32 is saturated (the caller's range
// check then rejects the image). Neighbours are read back from this
// thread's own output row; the neighbour rows of _meta_arrays are
// recomputed from (th, tw).
//
// Layout: words (n, W) uint32 rows; prior as in flct_encode.cu;
// out (n, C*t) int32.
//
// What bounds it on an H100: as for the encoder, one serial chain of C*t
// dependent steps per thread and only n_tiles threads, so the card is
// mostly idle and the time is the latency of the longest chain; word reads
// and the output row are strided by a tile between neighbouring threads.
// Occupancy, shared-memory tables and coalesced layouts are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "flct_common.cuh"

namespace {

struct BitReader {
  const uint32_t* row;
  long long W;

  __device__ __forceinline__ uint32_t word(long long i) const {
    return i < W ? __ldg(row + i) : 0u;
  }

  // The 32 bits starting at bit `pos` (zeros past the row).
  __device__ __forceinline__ uint32_t peek32(long long pos) const {
    const long long wi = pos >> 5;
    const int off = static_cast<int>(pos & 31);
    return flct::shl32(word(wi), off) | flct::shr32(word(wi + 1), 32 - off);
  }

  // n <= 32 bits at `pos`, as an unsigned value.
  __device__ __forceinline__ uint32_t get(long long pos, int n) const {
    return flct::shr32(peek32(pos), 32 - n);
  }
};

__global__ void flct_decode_kernel(const int32_t* __restrict__ words,
                                   const int32_t* __restrict__ prior,
                                   long long prior_stride,
                                   int32_t* __restrict__ out, int n, int C,
                                   int th, int tw, int depth, int nb, int K,
                                   int max_context, long long W) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n) return;
  const int t = th * tw;
  const int32_t* pr = prior + static_cast<long long>(tile) * prior_stride;
  const BitReader br{reinterpret_cast<const uint32_t*>(words) + tile * W, W};
  const long long limit = W * 32;
  int32_t* dst = out + static_cast<long long>(tile) * C * t;
  long long pos = 0;
  uint32_t table[flct::kMaxBuckets * flct::kMaxK];

  for (int c = 0; c < C; ++c) {
    int32_t* plane = dst + c * t;
    const int pw = depth + (c > 0 ? 1 : 0);  // <= 17
    for (int j = 0; j < 2; ++j) {
      const uint32_t raw = br.get(pos, pw);
      pos += pw;
      long long v = raw;
      if (c > 0 && (raw >> (pw - 1)) != 0u) v -= (1ll << pw);
      plane[j] = static_cast<int32_t>(v);
    }
    for (int i = 0; i < nb * K; ++i) {
      table[i] = static_cast<uint32_t>(pr[c * nb * K + i]);
    }

    for (int j = 2; j < t; ++j) {
      int ia, ib;
      flct::neighbours(j, tw, &ia, &ib);
      const long long va = plane[ia], vb = plane[ib];
      const long long h = va > vb ? va : vb;
      const long long l = va < vb ? va : vb;
      const long long d = h - l;
      const uint64_t ctx = static_cast<uint64_t>(d < max_context ? d : max_context);
      long long value;
      if (br.get(pos, 1) != 0u) {
        const flct::PhaseIn pi(ctx);
        const uint64_t first = br.get(pos + 1, pi.m);
        uint64_t number;
        if (first < pi.right_p) {
          number = first;
          pos += 1 + pi.m;
        } else {
          number = (first - pi.right_p) * 2 + pi.right_p + br.get(pos + 1 + pi.m, 1);
          pos += 2 + pi.m;
        }
        uint64_t xs = number + pi.left_p;
        if (xs >= pi.n) xs -= pi.n;
        value = l + static_cast<long long>(xs);
      } else {
        const bool above = br.get(pos + 1, 1) != 0u;
        uint32_t* row = table + flct::bucket_of(ctx, nb) * K;
        const int k = flct::k_select(row, K);
        uint64_t q = 0;
        long long p = pos + 2;
        while (p < limit) {  // unary run, word by word, never past 32*W
          const uint32_t inv = ~br.peek32(p);
          const int ones = inv != 0u ? __clz(static_cast<int>(inv)) : 32;
          q += ones;
          p += ones;
          if (ones < 32) {
            p += 1;  // the terminating zero
            break;
          }
        }
        const uint64_t encoded = (q << k) + br.get(p, k);
        pos = p + k;
        flct::k_update(row, K, encoded);
        value = above ? static_cast<long long>(encoded) + h + 1
                      : l - static_cast<long long>(encoded) - 1;
      }
      if (value > INT32_MAX) value = INT32_MAX;
      if (value < INT32_MIN) value = INT32_MIN;
      plane[j] = static_cast<int32_t>(value);
    }
  }
}

}  // namespace

extern "C" {

// Launches the decoder on `stream`; returns cudaGetLastError() (0 = ok).
int flct_decode(const void* words, const void* prior, long long prior_stride,
                void* out, int n, int C, int th, int tw, int depth, int nb,
                int K, int max_context, long long W, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  flct_decode_kernel<<<blocks, kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(prior),
      prior_stride, static_cast<int32_t*>(out), n, C, th, tw, depth, nb, K,
      max_context, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
