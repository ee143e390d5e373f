// FLCT tile encoder (kernel K1): one warp per (tile, plane) domain, the C
// planes of a tile in one block, each lane on a contiguous run of the plane.
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
// relaunch at the exact width).
//
// What bounds it on an H100, and the design. The TPU kernel walked each
// tile-plane in one lane; on 132 SMs that leaves the card idle (3072
// threads for gray8 12 x 512^2 at tile 32). But nothing in the encoder is
// serial: FLCT has no count scaling, so the k-table just before pixel i is
// the prior plus an exclusive prefix sum of the Rice-length rows
// (v >> k) + 1 + k of the earlier out-of-range pixels of the same bucket
// (felics_tpu/ops/kscan_tiled.py). Context, bucket, range and residual
// depend on the input pixels only, code lengths on k, bit offsets on the
// lengths. So each lane of the plane's warp takes ceil(t / 32) pixels:
// - pass 1: the lane sums the Rice-length rows of its run's out-of-range
//   pixels per (bucket, k) into its row of shared memory, and the lengths
//   of its raw and in-range codes, which do not depend on k;
// - an exclusive scan of those rows over the lanes, plus the prior, gives
//   each lane the table the serial walk has at its run's first pixel
//   (uint32 wrap-around adds are associative, so bit for bit);
// - pass 2: the lane walks its run from that table for each out-of-range
//   pixel's k and code length; a warp scan of the lanes' lengths, and a
//   sum over the block's planes, give each lane's first bit. The walk
//   leaves the next lane's start table behind, so 33 table rows serve the
//   warp;
// - pass 3: the lane walks its run again from its start table and writes
//   its bits. Words wholly inside the run are stored; the run's first and
//   last words may be shared with a neighbouring run and are ORed into the
//   zeroed buffer with atomicOr. Words at or past W are dropped.
// The pixels reach the lanes through a shared-memory stage, 16 steps of
// every lane at a time, loaded coalesced: a lane's run and the row above
// it are 32 different cache lines at each step, which the L1 left beside
// the warps' shared memory cannot hold. Shared memory is 33 table rows and
// the stage, 9,236 bytes a plane at K = 6, whatever the tile size. The
// chain of a lane is about 3 t / 32 steps.
#include <cuda_runtime.h>

#include <cstdint>

#include "flct_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kChunk = 16;               // steps of every lane staged at a time
constexpr int kStageStride = kChunk + 1;  // odd: lanes' staged steps in distinct banks
constexpr int kStageInts = 2 * kLanes * kStageStride;  // a warp's pixels and pixels above

// Shared memory of one plane's warp: 33 table rows and the stage.
template <int K>
__host__ __device__ constexpr int warp_smem_ints() {
  return (kLanes + 1) * (flct::kMaxBuckets * K + 1) + kStageInts;
}

struct Params {
  const int32_t* tiles;
  const int32_t* prior;
  long long prior_stride;
  uint32_t* words;
  long long* bits;
  int C, th, tw, depth, nb;
  long long W;
};

// MSB-first writer of one lane's run of bits, from bit `start` of the row.
// The run's first word (when it does not start on a word) and its last
// partial word may hold another run's bits: they are ORed in.
struct RunWriter {
  uint32_t* row;
  long long W;
  long long wi;   // word being filled
  uint64_t acc;   // its bits so far, nbits of them (< 32 between calls)
  int nbits;
  bool shared;    // the word being filled began before this run

  __device__ __forceinline__ void init(uint32_t* r, long long w, unsigned long long start) {
    row = r;
    W = w;
    wi = static_cast<long long>(start >> 5);
    nbits = static_cast<int>(start & 31);
    acc = 0;
    shared = nbits != 0;
  }

  // len <= 32 bits of val (val < 2^len).
  __device__ __forceinline__ void put(uint32_t val, int len) {
    acc = (acc << len) | val;
    nbits += len;
    if (nbits >= 32) {
      nbits -= 32;
      const uint32_t w = static_cast<uint32_t>(acc >> nbits);
      if (wi < W) {
        if (shared) {
          atomicOr(row + wi, w);
        } else {
          row[wi] = w;
        }
      }
      shared = false;
      ++wi;
      acc &= (1ull << nbits) - 1ull;
    }
  }

  __device__ __forceinline__ void flush() {
    if (nbits > 0 && wi < W) {
      atomicOr(row + wi, static_cast<uint32_t>(acc << (32 - nbits)));
    }
  }
};

// Walks lane `lane`'s run of `run` pixels of a plane (t pixels, tw wide),
// calling pass.raw(p) for pixels j < 2 and pass.coded(p, va, vb) for the
// others, with the neighbour rules of
// felics_tpu/core/context.py::neighbour_indices. The warp stages kChunk
// steps of every lane at a time in `stage` (its pixels, and the pixels a
// row above them), loaded coalesced, half a warp to a lane's run; the left
// neighbours are carried in registers. Every lane of the warp calls it.
template <class Pass>
__device__ __forceinline__ void walk(const int32_t* __restrict__ plane, int t, int tw, int run,
                                     int lane, int32_t* stage, Pass& pass) {
  int32_t* above = stage + kLanes * kStageStride;
  const int j0 = min(lane * run, t), j1 = min(j0 + run, t);
  int x = j0 % tw, y = j0 / tw;
  int32_t prev = j0 >= 1 && j0 < t ? __ldg(plane + j0 - 1) : 0;
  int32_t prev2 = j0 >= 2 && j0 < t ? __ldg(plane + j0 - 2) : 0;
  const int half = lane / kChunk, col = lane % kChunk;
  for (int s0 = 0; s0 < run; s0 += kChunk) {
    __syncwarp();
#pragma unroll 4
    for (int L = half; L < kLanes; L += kLanes / kChunk) {
      const int j = L * run + s0 + col;
      const bool in = s0 + col < run && j < t;
      stage[L * kStageStride + col] = in ? __ldg(plane + j) : 0;
      above[L * kStageStride + col] = in && j >= tw ? __ldg(plane + j - tw) : 0;
    }
    __syncwarp();
    const int steps = min(kChunk, j1 - j0 - s0);
    for (int s = 0; s < steps; ++s) {
      const int j = j0 + s0 + s;
      const int32_t p = stage[lane * kStageStride + s];
      if (j < 2) {
        pass.raw(p);
      } else {
        int32_t va = prev, vb = prev2;  // row 0: left, left-left
        if (y > 0 && x > 0) {
          vb = above[lane * kStageStride + s];
        } else if (y > 0) {  // first column: above, and above-above or above-right
          va = above[lane * kStageStride + s];
          vb = __ldg(plane + (y >= 2 ? j - 2 * tw : j - tw + 1));
        }
        pass.coded(p, va, vb);
      }
      prev2 = prev;
      prev = p;
      if (++x == tw) {
        x = 0;
        ++y;
      }
    }
  }
}

// A coded pixel: its context h - l, range, residual v (out of range) and
// offset p - l (in range), in 32 bits: any int32 planes give differences
// below 2^32.
struct Coded {
  uint32_t ctx, v, off;
  bool in_range, below;

  __device__ __forceinline__ Coded(int32_t p, int32_t va, int32_t vb) {
    const int32_t h = va > vb ? va : vb;
    const int32_t l = va < vb ? va : vb;
    const uint32_t uh = static_cast<uint32_t>(h), ul = static_cast<uint32_t>(l);
    const uint32_t up = static_cast<uint32_t>(p);
    ctx = uh - ul;
    in_range = p >= l && p <= h;
    below = p < l;
    v = below ? ul - up - 1u : up - uh - 1u;
    off = up - ul;
  }

  // Phase-in remainder r of an in-range pixel.
  __device__ __forceinline__ uint64_t phase_r(const flct::PhaseIn& pi) const {
    const uint64_t x = off + pi.n - pi.left_p;
    return x >= pi.n ? x - pi.n : x;
  }
};

// Pass 1: the Rice-length sums of the run's out-of-range pixels, per
// (bucket, k), into the lane's row of shared memory; and the bits of the
// codes that do not depend on k (raw pixels, in-range pixels).
template <int K>
struct SumPass {
  uint32_t* table;
  int nb, pw;
  unsigned long long bits;

  __device__ __forceinline__ void raw(int32_t) { bits += pw; }

  __device__ __forceinline__ void coded(int32_t p, int32_t va, int32_t vb) {
    const Coded px(p, va, vb);
    if (px.in_range) {
      const flct::PhaseIn pi(px.ctx);
      bits += 1 + pi.m + (px.phase_r(pi) >= pi.right_p ? 1 : 0);
      return;
    }
    uint32_t* row = table + flct::bucket_of(px.ctx, nb) * K;
    uint32_t r[K];
    flct::load_row(row, 1, r);
    flct::k_update(r, px.v);
    flct::store_row(row, 1, r);
  }
};

// Pass 2: the bits of the run's out-of-range codes, walking the table from
// the run's start.
template <int K>
struct LengthPass {
  uint32_t* table;
  int nb;
  unsigned long long bits;

  __device__ __forceinline__ void raw(int32_t) {}

  __device__ __forceinline__ void coded(int32_t p, int32_t va, int32_t vb) {
    const Coded px(p, va, vb);
    if (px.in_range) return;
    uint32_t* row = table + flct::bucket_of(px.ctx, nb) * K;
    uint32_t r[K];
    flct::load_row(row, 1, r);
    const int k = flct::k_select(r);
    bits += 3ull + k + (px.v >> k);
    flct::k_update(r, px.v);
    flct::store_row(row, 1, r);
  }
};

// Pass 3: the run's bits, walking the table from the run's start again.
template <int K>
struct WritePass {
  uint32_t* table;
  int nb, pw;
  RunWriter bw;

  __device__ __forceinline__ void raw(int32_t p) {
    bw.put(static_cast<uint32_t>(p) & ((1u << pw) - 1u), pw);
  }

  __device__ __forceinline__ void coded(int32_t p, int32_t va, int32_t vb) {
    const Coded px(p, va, vb);
    if (px.in_range) {
      bw.put(1u, 1);
      const flct::PhaseIn pi(px.ctx);
      const uint64_t r = px.phase_r(pi);
      if (r < pi.right_p) {
        bw.put(static_cast<uint32_t>(r), pi.m);
      } else {
        const uint64_t off = r - pi.right_p;
        bw.put(static_cast<uint32_t>((off >> 1) + pi.right_p), pi.m);
        bw.put(static_cast<uint32_t>(off & 1ull), 1);
      }
      return;
    }
    uint32_t* row = table + flct::bucket_of(px.ctx, nb) * K;
    uint32_t r[K];
    flct::load_row(row, 1, r);
    const int k = flct::k_select(r);
    bw.put(px.below ? 0u : 1u, 2);
    uint32_t q = px.v >> k;
    while (q >= 32) {  // the rare Rice symbol longer than a word
      bw.put(0xFFFFFFFFu, 32);
      q -= 32;
    }
    // q ones and the terminating zero (q <= 31, so q + 1 <= 32 bits).
    bw.put(static_cast<uint32_t>(((1ull << q) - 1ull) << 1), static_cast<int>(q) + 1);
    bw.put(px.v & ((1u << k) - 1u), k);
    flct::k_update(r, px.v);
    flct::store_row(row, 1, r);
  }
};

template <int K>
__global__ void __launch_bounds__(3 * kLanes) flct_encode_kernel(const Params P) {
  constexpr int STR = flct::kMaxBuckets * K + 1;  // odd: lanes' rows in distinct banks
  extern __shared__ uint32_t smem[];
  __shared__ unsigned long long plane_bits[3];

  const int c = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int tile = blockIdx.x;
  const int t = P.th * P.tw;
  const int nbk = P.nb * K;
  const int32_t* plane = P.tiles + (static_cast<long long>(tile) * P.C + c) * t;
  const int32_t* pr = P.prior + tile * P.prior_stride + c * nbk;
  // Table slots 0..32 of STR entries, then the stage. After the scan slot
  // L + 1 holds the table at lane L's first pixel and slot 0 the prior;
  // pass 2 takes lane L's slot from its start to lane L + 1's start, so
  // pass 3 finds lane L's start in slot L.
  uint32_t* slots = smem + c * warp_smem_ints<K>();
  int32_t* stage = reinterpret_cast<int32_t*>(slots + (kLanes + 1) * STR);
  const int run = (t + kLanes - 1) / kLanes;
  const int pw = P.depth + (c > 0 ? 1 : 0);  // <= 17

  // Pass 1: each lane's sums in its slot L + 1.
  uint32_t* after = slots + (lane + 1) * STR;
  for (int e = 0; e < nbk; ++e) after[e] = 0;
  SumPass<K> p1{after, P.nb, pw, 0ull};
  walk(plane, t, P.tw, run, lane, stage, p1);
  __syncwarp();

  // Exclusive scan over the lanes, entry by entry, from the prior.
  for (int e = lane; e < nbk; e += kLanes) {
    uint32_t carry = static_cast<uint32_t>(pr[e]);
    slots[e] = carry;
    for (int L = 1; L <= kLanes; ++L) {
      const uint32_t sum = slots[L * STR + e];
      slots[L * STR + e] = carry;
      carry += sum;
    }
  }
  __syncwarp();

  // Pass 2, then the lanes' and the planes' offsets.
  LengthPass<K> p2{after, P.nb, p1.bits};
  walk(plane, t, P.tw, run, lane, stage, p2);
  const unsigned long long len = p2.bits;
  unsigned long long incl = len;
#pragma unroll
  for (int d = 1; d < kLanes; d *= 2) {
    const unsigned long long up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == kLanes - 1) plane_bits[c] = incl;
  __syncthreads();
  unsigned long long start = incl - len;
  for (int cc = 0; cc < c; ++cc) start += plane_bits[cc];
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int cc = 0; cc < P.C; ++cc) total += plane_bits[cc];
    P.bits[tile] = static_cast<long long>(total);
  }

  // Pass 3, on slot L.
  WritePass<K> p3{slots + lane * STR, P.nb, pw, {}};
  p3.bw.init(P.words + tile * P.W, P.W, start);
  walk(plane, t, P.tw, run, lane, stage, p3);
  p3.bw.flush();
}

template <int K>
cudaError_t launch(const Params& p, int n, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.C) * warp_smem_ints<K>() * 4;
  auto kernel = flct_encode_kernel<K>;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<n, p.C * kLanes, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream`, one block of 32 * C threads per tile; returns
// cudaGetLastError() (0 = ok). C is 1 or 3, K 6 or 15, nb <= 6, tiles at
// least 2x2.
int flct_encode(const void* tiles, const void* prior, long long prior_stride,
                void* words, void* bits, int n, int C, int th, int tw,
                int depth, int nb, int K, long long W, void* stream) {
  if (!(C == 1 || C == 3) || nb > flct::kMaxBuckets || th < 2 || tw < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const int32_t*>(tiles), static_cast<const int32_t*>(prior),
                 prior_stride, static_cast<uint32_t*>(words), static_cast<long long*>(bits),
                 C, th, tw, depth, nb, W};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (K == 6) {
    e = launch<6>(p, n, s);
  } else if (K == 15) {
    e = launch<15>(p, n, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* flct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
