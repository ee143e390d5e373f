// FLCT tile encoder, one CUDA thread per tile (lane = tile, as on the TPU).
//
// Replaces felics_tpu/ops/pallas_codec.py::_encode_kernel_body (launched by
// _encode_tiles_pallas, public wrapper encode_tiles). It writes the same
// stream, bit for bit: per channel plane a raw two-pixel preamble (depth
// bits for plane 0, depth+1 bits of two's complement for Co/Cg, masked),
// the plane's k-table reset from the prior, then for every pixel j >= 2
// either '1' + phase-in(p - L over H - L + 1) or '00'/'01' + Rice_k, with k
// the cheapest column of the context bucket's row (ties to the largest k)
// and the row updated after every out-of-range pixel.
//
// Layout: tiles (n, C*t) int32; prior int32 (C, nb, K) per tile, at a stride
// of prior_stride elements between tiles (0 = one prior shared by all);
// words (n, W) uint32 MSB-first rows, zero past the last bit (the wrapper
// hands in a zeroed buffer); bits (n,) int64, exact even where the stream
// is longer than 32*W bits (words past W are dropped, so the caller can
// relaunch at the exact width). The neighbour rows of _meta_arrays are
// recomputed here from (th, tw) instead of being passed in.
//
// What bounds it on an H100: each thread is one serial chain of C*t
// dependent steps, and there are only n_tiles threads (12 x 512^2 gray8 at
// tile 32 gives 3072 threads, 24 blocks of 128 on 132 SMs), so the card is
// mostly idle and the time is the latency of the longest chain. Pixel
// reads are strided by a whole tile row between neighbouring threads, and
// the k-table lives in per-thread local memory. Occupancy (more lanes per
// tile or more tiles per launch), shared-memory tables and coalesced
// layouts are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "flct_common.cuh"

namespace {

// MSB-first bit writer over one tile's word row. put() takes at most 32
// bits; the 64-bit accumulator never holds more than 31 bits between calls.
struct BitWriter {
  uint32_t* row;
  long long W;
  long long wi;
  uint64_t acc;
  int nbits;

  __device__ __forceinline__ void put(uint32_t val, int len) {
    acc = (acc << len) | val;
    nbits += len;
    if (nbits >= 32) {
      nbits -= 32;
      if (wi < W) row[wi] = static_cast<uint32_t>(acc >> nbits);
      ++wi;
      acc &= (1ull << nbits) - 1ull;
    }
  }

  __device__ __forceinline__ void flush() {
    if (nbits > 0 && wi < W) {
      row[wi] = static_cast<uint32_t>(acc << (32 - nbits));
    }
  }
};

__global__ void flct_encode_kernel(const int32_t* __restrict__ tiles,
                                   const int32_t* __restrict__ prior,
                                   long long prior_stride,
                                   int32_t* __restrict__ words,
                                   long long* __restrict__ bits, int n, int C,
                                   int th, int tw, int depth, int nb, int K,
                                   long long W) {
  const int tile = blockIdx.x * blockDim.x + threadIdx.x;
  if (tile >= n) return;
  const int t = th * tw;
  const int32_t* px = tiles + static_cast<long long>(tile) * C * t;
  const int32_t* pr = prior + static_cast<long long>(tile) * prior_stride;
  BitWriter bw{reinterpret_cast<uint32_t*>(words) + tile * W, W, 0, 0ull, 0};
  uint32_t table[flct::kMaxBuckets * flct::kMaxK];

  for (int c = 0; c < C; ++c) {
    const int32_t* plane = px + c * t;
    const int pw = depth + (c > 0 ? 1 : 0);  // <= 17
    const uint32_t mask = (1u << pw) - 1u;
    bw.put(static_cast<uint32_t>(plane[0]) & mask, pw);
    bw.put(static_cast<uint32_t>(plane[1]) & mask, pw);
    for (int i = 0; i < nb * K; ++i) {
      table[i] = static_cast<uint32_t>(pr[c * nb * K + i]);
    }

    for (int j = 2; j < t; ++j) {
      int ia, ib;
      flct::neighbours(j, tw, &ia, &ib);
      const long long p = plane[j], va = plane[ia], vb = plane[ib];
      const long long h = va > vb ? va : vb;
      const long long l = va < vb ? va : vb;
      const uint64_t ctx = static_cast<uint64_t>(h - l);
      if (p >= l && p <= h) {
        bw.put(1u, 1);
        const flct::PhaseIn pi(ctx);
        const uint64_t x = static_cast<uint64_t>(p - l) + pi.n - pi.left_p;
        const uint64_t r = x >= pi.n ? x - pi.n : x;
        if (r < pi.right_p) {
          bw.put(static_cast<uint32_t>(r), pi.m);
        } else {
          const uint64_t off = r - pi.right_p;
          bw.put(static_cast<uint32_t>((off >> 1) + pi.right_p), pi.m);
          bw.put(static_cast<uint32_t>(off & 1ull), 1);
        }
      } else {
        const bool below = p < l;
        const uint64_t v = static_cast<uint64_t>(below ? l - p - 1 : p - h - 1);
        uint32_t* row = table + flct::bucket_of(ctx, nb) * K;
        const int k = flct::k_select(row, K);
        bw.put(below ? 0u : 1u, 2);
        uint64_t q = v >> k;
        while (q >= 32) {  // the rare Rice symbol longer than a word
          bw.put(0xFFFFFFFFu, 32);
          q -= 32;
        }
        // q ones and the terminating zero (q <= 31, so q + 1 <= 32 bits).
        bw.put(static_cast<uint32_t>(((1ull << q) - 1ull) << 1), static_cast<int>(q) + 1);
        bw.put(static_cast<uint32_t>(v & ((1ull << k) - 1ull)), k);
        flct::k_update(row, K, v);
      }
    }
  }
  bw.flush();
  bits[tile] = bw.wi * 32 + bw.nbits;
}

}  // namespace

extern "C" {

// Launches the encoder on `stream`; returns cudaGetLastError() (0 = ok).
int flct_encode(const void* tiles, const void* prior, long long prior_stride,
                void* words, void* bits, int n, int C, int th, int tw,
                int depth, int nb, int K, long long W, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  flct_encode_kernel<<<blocks, kThreads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tiles), static_cast<const int32_t*>(prior),
      prior_stride, static_cast<int32_t*>(words), static_cast<long long*>(bits),
      n, C, th, tw, depth, nb, K, W);
  return static_cast<int>(cudaGetLastError());
}

const char* flct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
