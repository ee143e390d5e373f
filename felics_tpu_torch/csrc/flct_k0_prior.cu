// FLCT k0/prior pass (kernel K5): the per-image best Rice k of every
// (plane, context bucket), and each tile's k-table seed made from it.
//
// Replaces no Pallas kernel: it replaces the XLA one-hot reduction of
// felics_tpu/parallel/tiling.py:285 (compute_k0_prior_jax), whose plain
// PyTorch counterpart is parallel/tiling.py::k0_prior_ref. Its output
// equals that one bit for bit:
// - every coded pixel (index >= 2 of its plane) has two causal neighbours
//   (felics_tpu/core/context.py::neighbour_indices, as K1 walks them),
//   L = min, H = max, ctx = H - L, bucket q = min(bit_length(ctx), nb - 1);
// - a pixel below L has the residual L - p - 1, one above H p - H - 1, and
//   adds (res >> k) + k + 1 to its image's (plane, q, k) sum for every
//   k < K; in-range pixels add nothing;
// - the sums are exact 64-bit integers (a 16-bit image passes 2^31), so
//   the atomics that gather them give one result in any order;
// - k0 is the largest k whose sum is the least (an empty bucket: K - 1),
//   and a tile's prior is weight * |k - k0| of its image's k0.
//
// Layout: tiles (nt, C, t) int32; owners (nt,) int64 image of each tile,
// or null when every image has per_image tiles; totals (n_img, C, nb, K)
// uint64, zeroed by the caller; prior (nt, C, nb, K) int32; k0 (n_img, C,
// nb) int32.
//
// What bounds it on an H100, and the design. The pass reads each int32
// pixel once and writes a few kilobytes, so its bound is the tiles' bytes
// at 3.35 TB/s (12.6 MB, 3.8 us, for 12 gray8 512^2 images). The PyTorch
// chain it replaces materialised (nt, C, t, K) int64 Rice lengths and moved
// ~2.2 GB a call to scatter-add them. Here no per-pixel value reaches
// device memory:
// - flct_k0_sums_kernel: a block takes a chunk of one (tile, plane) pair's
//   pixels in warp steps of 4 x 32 pixels, each 32 neighbouring pixels a
//   coalesced load (the neighbours lie on the same or the previous row,
//   which L1 and L2 hold). The pass is bound by its instructions, not by
//   the bytes: for each bucket present in a step, a lane sums (res >> k)
//   of its 4 pixels, and one __reduce_add_sync per k sums the lanes in 32
//   bits (exact: a step whose residuals reach 2^25 sums 16-bit halves);
//   the lane that owns the (bucket, k) entry adds it to a 64-bit register.
//   The block folds its warps' entries in shared memory and adds each
//   nonzero one to its image's total with one 64-bit atomicAdd;
// - flct_k0_prior_kernel: a thread a (tile, plane, bucket) row picks k0
//   from its image's K totals and writes the row's prior; the first
//   n_img * C * nb threads also write k0.
// The geometry follows the shape, with one algorithm: up to 256 threads a
// block, and a pair's pixels cut into chunks until about kTargetBlocks
// blocks are in flight (gray8 t64: 768 pairs of 4,096 pixels in 2 chunks;
// rgb8 t32: 6,144 pairs of 1,024 in 1; t256: 48 pairs of 65,536 in 22).
// K (6 or 15) is a template constant.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "flct_common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / kLanes;
constexpr long long kTargetBlocks = 1024;  // ~8 blocks of 256 threads an SM
constexpr int kPickThreads = 256;
constexpr int kPerLane = 4;              // pixels of a lane in a warp step
constexpr uint32_t kNarrow = 1u << 25;  // residuals below it: 32 * kPerLane fit 32 bits

struct SumParams {
  const int32_t* tiles;
  const long long* owners;
  long long per_image;
  unsigned long long* totals;
  int C, th, tw, nb, chunk, chunks;
};

struct PriorParams {
  const unsigned long long* totals;
  const long long* owners;
  long long per_image, nt, n_img;
  int32_t* prior;
  int32_t* k0;
  int C, nb, weight;
};

__device__ __forceinline__ long long image_of(const long long* owners, long long per_image,
                                              long long tile) {
  return owners ? owners[tile] : tile / per_image;
}

// The warp's sum of the lanes' sums of w[r] >> k, exact: kept in 32 bits,
// or, when a lane's w may reach kNarrow, as 16-bit halves summed apart.
template <bool Wide>
__device__ __forceinline__ unsigned long long warp_sum(const uint32_t (&w)[kPerLane], int k) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const uint32_t x = w[r] >> k;
    lo += Wide ? x & 0xFFFFu : x;
    hi += Wide ? x >> 16 : 0u;
  }
  if (!Wide) return __reduce_add_sync(kFull, lo);
  return (static_cast<unsigned long long>(__reduce_add_sync(kFull, hi)) << 16) +
         __reduce_add_sync(kFull, lo);
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads) flct_k0_sums_kernel(const SumParams P) {
  constexpr int E = flct::kMaxBuckets * K;  // (bucket, k) entries, bucket-major
  constexpr int PER_LANE = (E + kLanes - 1) / kLanes;
  constexpr int kStep = kLanes * kPerLane;  // pixels of a warp step
  __shared__ unsigned long long part[kMaxWarps][E];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const long long pair = blockIdx.x / P.chunks;
  const int tw = P.tw, t = P.th * P.tw;
  const int j0 = static_cast<int>(blockIdx.x % P.chunks) * P.chunk;
  const int j1 = min(j0 + P.chunk, t);
  const int32_t* plane = P.tiles + pair * t;

  // Entry e lives in lane e % 32, register e / 32.
  unsigned long long acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0;

  for (int base = j0 + warp * kStep; base < j1; base += warps * kStep) {
    // Pixel r of the lane: base + 32 r + lane. Out of range: its residual
    // v and bucket q; in range, or not coded: q = -1.
    uint32_t v[kPerLane];
    int q[kPerLane];
    bool big = false;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int j = base + r * kLanes + lane;
      v[r] = 0;
      q[r] = -1;
      if (j >= 2 && j < j1) {
        const int x = j % tw, y = j / tw;
        int a = j - 1, b = j - tw;  // left, above
        if (y == 0) {
          b = j - 2;  // top row: left, left-left
        } else if (x == 0) {  // first column: above, and above-above or above-right
          a = j - tw;
          b = y >= 2 ? j - 2 * tw : j - tw + 1;
        }
        const int32_t p = __ldg(plane + j), va = __ldg(plane + a), vb = __ldg(plane + b);
        const int32_t h = max(va, vb), l = min(va, vb);
        const uint32_t up = static_cast<uint32_t>(p);
        const uint32_t uh = static_cast<uint32_t>(h), ul = static_cast<uint32_t>(l);
        if (p < l || p > h) {
          v[r] = p < l ? ul - up - 1u : up - uh - 1u;
          q[r] = flct::bucket_of(uh - ul, P.nb);
          big = big || v[r] >= kNarrow;
        }
      }
    }
    const bool wide = __any_sync(kFull, big);
#pragma unroll
    for (int bq = 0; bq < flct::kMaxBuckets; ++bq) {
      uint32_t w[kPerLane];
      uint32_t cnt = 0;
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        w[r] = q[r] == bq ? v[r] : 0u;
        cnt += q[r] == bq ? 1u : 0u;
      }
      if (!__any_sync(kFull, cnt != 0)) continue;
      const unsigned long long n = __reduce_add_sync(kFull, cnt);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned long long s =
            (wide ? warp_sum<true>(w, k) : warp_sum<false>(w, k)) + n * (k + 1);
        const int e = bq * K + k;
        if (lane == e % kLanes) acc[e / kLanes] += s;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = i * kLanes + lane;
    if (e < E) part[warp][e] = acc[i];
  }
  __syncthreads();
  const int nbk = P.nb * K;
  const long long img = image_of(P.owners, P.per_image, pair / P.C);
  unsigned long long* tot = P.totals + (img * P.C + pair % P.C) * nbk;
  for (int e = threadIdx.x; e < nbk; e += blockDim.x) {
    unsigned long long s = 0;
    for (int w = 0; w < warps; ++w) s += part[w][e];
    if (s != 0) atomicAdd(tot + e, s);
  }
}

// The largest k whose total is the least.
template <int K>
__device__ __forceinline__ int least_k(const unsigned long long* tot) {
  int best = 0;
  unsigned long long least = tot[0];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (tot[k] <= least) {
      least = tot[k];
      best = k;
    }
  }
  return best;
}

template <int K>
__global__ void __launch_bounds__(kPickThreads) flct_k0_prior_kernel(const PriorParams P) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rows = static_cast<long long>(P.C) * P.nb;  // rows of an image or tile
  if (i < P.n_img * rows) P.k0[i] = least_k<K>(P.totals + i * K);
  if (i < P.nt * rows) {
    const long long img = image_of(P.owners, P.per_image, i / rows);
    const int k0 = least_k<K>(P.totals + (img * rows + i % rows) * K);
    int32_t* row = P.prior + i * K;
#pragma unroll
    for (int k = 0; k < K; ++k) row[k] = P.weight * (k > k0 ? k - k0 : k0 - k);
  }
}

template <int K>
cudaError_t launch(SumParams s, PriorParams p, cudaStream_t stream) {
  const int t = s.th * s.tw;
  const long long pairs = p.nt * s.C;
  if (pairs > 0) {
    const int step = kLanes * kPerLane;  // pixels of a warp step
    const int threads = std::min(kMaxThreads, (t + step - 1) / step * kLanes);
    const int block_step = threads * kPerLane;
    long long chunks = (kTargetBlocks + pairs - 1) / pairs;
    chunks = std::max(1LL, std::min(chunks, static_cast<long long>((t + block_step - 1) / block_step)));
    const long long per = (t + chunks - 1) / chunks;
    s.chunk = static_cast<int>((per + block_step - 1) / block_step * block_step);
    s.chunks = (t + s.chunk - 1) / s.chunk;
    flct_k0_sums_kernel<K><<<static_cast<unsigned>(pairs * s.chunks), threads, 0, stream>>>(s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long long rows = std::max(p.nt, p.n_img) * p.C * p.nb;
  if (rows > 0) {
    const unsigned blocks = static_cast<unsigned>((rows + kPickThreads - 1) / kPickThreads);
    flct_k0_prior_kernel<K><<<blocks, kPickThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5 on `stream`: flct_k0_sums_kernel when there are tiles, then
// flct_k0_prior_kernel when there are tiles or images; returns
// cudaGetLastError() (0 = ok). C is 1 or 3, K 6 or 15, nb <= 6, tiles at
// least 2x2; `owners` may be null, and then per_image > 0 when nt > 0.
int flct_k0_prior(const void* tiles, const void* owners, long long per_image, void* totals,
                  void* prior, void* k0, long long nt, long long n_img, int C, int th, int tw,
                  int nb, int K, int weight, void* stream) {
  if (!(C == 1 || C == 3) || nb < 1 || nb > flct::kMaxBuckets || th < 2 || tw < 2 ||
      (owners == nullptr && nt > 0 && per_image < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* own = static_cast<const long long*>(owners);
  unsigned long long* tot = static_cast<unsigned long long*>(totals);
  const SumParams s{static_cast<const int32_t*>(tiles), own, per_image, tot, C, th, tw, nb, 0, 1};
  const PriorParams p{tot, own, per_image, nt, n_img, static_cast<int32_t*>(prior),
                      static_cast<int32_t*>(k0), C, nb, weight};
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (K == 6) {
    e = launch<6>(s, p, st);
  } else if (K == 15) {
    e = launch<15>(s, p, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
