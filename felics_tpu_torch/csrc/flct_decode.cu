// FLCT tile decoder (kernel K2): one thread per tile, a few tiles a
// block, with nothing on a thread's serial chain read from device memory
// but the next word of its stream.
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
// bits (hi:lo), and a decoded value outside int32 is saturated (the
// caller's range check then rejects the image).
//
// Layout: words (n, W) uint32 rows; prior as in flct_encode.cu; out
// (n, C*t) int32; rings (blocks, (tw + 1) * (tpb + 1)) int32 scratch, used
// only when the rings do not fit in shared memory.
//
// What bounds it on an H100: a tile's planes are one stream, and a pixel's
// bits start where the previous code ended and its context needs the
// values just decoded, so each tile is one chain of C * t dependent steps.
// The design keeps a step short, as flcs_decode.cu does for FLCS:
// - neighbours: the left one, the one two to the left (row 0) and the first
//   column's two rows above are registers; the row above is a ring of
//   tw + 1 values in shared memory, read one pixel ahead of its use (in
//   global scratch when the block's rings do not fit);
// - the nb x K k-table in shared memory, entry e of the block's tpb tiles
//   side by side, so any mix of rows across the warp is free of bank
//   conflicts; K is a template constant, so the k choice (a compare tree)
//   and the update unroll;
// - bits: three words in registers, the third fetched when the first is
//   used up, and a funnel shift reads 32 bits at any offset; positions are
//   32-bit, or 64-bit in a second instantiation that the wrapper takes only
//   for rows too long for 32 (ops/tile_codec.py decode_wide_positions);
// - the step computes the in-range and the out-of-range value and picks
//   one, so that only the unary run's loop diverges between tiles;
// - output: at the end of each row the block copies its tiles' rows from
//   the rings to the planes, coalesced; nothing on the chain reads it back.
// What is left is issue and latency: a warp issues every instruction of a
// step once for all its tiles, and one warp alone on a scheduler waits on
// each dependence. The wrapper picks the tiles a block (tpb, 1..32) that
// gives ~3 blocks an SM (ops/tile_codec.py decode_tiles_per_block).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "flct_common.cuh"

namespace {

constexpr int kMaxTiles = 32;            // tiles (threads) per block: one warp at most
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

struct Params {
  const uint32_t* words;
  long long W;
  const int32_t* prior;
  long long prior_stride;
  int32_t* out;
  int32_t* rings;
  int n, C, th, tw, depth, nb, max_context;
};

// MSB-first reader of one row: the current word, the next and the one after,
// with zeros past the row; a funnel shift reads 32 bits at any offset.
// Positions are Pos: int where 32 * W plus a step's reads stays below 2^31
// (the fast path), long long above that.
template <typename Pos>
struct BitReader {
  const uint32_t* row;
  Pos W, next;   // next: index of the word after w2
  uint32_t w0, w1, w2;
  int s;         // bits of w0 consumed, 0..31
  Pos base;      // stream position of w0's first bit

  __device__ __forceinline__ uint32_t word(Pos i) const {
    return i < W ? __ldg(row + i) : 0u;
  }

  __device__ __forceinline__ void init(const uint32_t* r, Pos w) {
    row = r;
    W = w;
    w0 = word(0);
    w1 = word(1);
    w2 = word(2);
    next = 3;
    s = 0;
    base = 0;
  }

  __device__ __forceinline__ uint32_t peek32() const { return __funnelshift_l(w1, w0, s); }

  // The next n bits, 0 < n <= 32.
  __device__ __forceinline__ uint32_t peek(int n) const { return peek32() >> (32 - n); }

  // n <= 32: crosses at most one word.
  __device__ __forceinline__ void skip(int n) {
    s += n;
    if (s >= 32) {
      s -= 32;
      base += 32;
      w0 = w1;
      w1 = w2;
      w2 = word(next);
      ++next;
    }
  }

  __device__ __forceinline__ Pos pos() const { return base + s; }
};

// The unary run's count: 32 bits beside 32-bit positions; beside 64-bit
// ones a corrupt run can pass 2^32 ones, and the count keeps them all so
// that the value saturates as the plain version's does.
template <typename Pos>
using RunCount = typename std::conditional<sizeof(Pos) == 8, uint64_t, uint32_t>::type;

template <int K, typename Pos>
struct Tile {
  BitReader<Pos> br;
  uint32_t* table;  // entry e at table[e * tpb]
  int tpb;          // tiles a block
  int nb, max_context;
  Pos limit;

  // One pixel from its two neighbours' values. Branch-free but for the
  // unary run: the in-range and the out-of-range decodings are both worked
  // out and the marker bit picks one, so the tiles of a warp stay together.
  __device__ __forceinline__ int32_t step(int32_t va, int32_t vb) {
    const int32_t h = va > vb ? va : vb;
    const int32_t l = va < vb ? va : vb;
    const uint32_t d = static_cast<uint32_t>(h) - static_cast<uint32_t>(l);  // exact: h >= l
    const int ctx = d < static_cast<uint32_t>(max_context) ? static_cast<int>(d) : max_context;
    const uint32_t head = br.peek32();
    const bool in = head >> 31;

    // In range: phase-in over nn = ctx + 1. The marker, then m + 1 bits
    // fm2 (m + 2 <= 19 in all): the first m are the short code; a long
    // code is all m + 1, less right_p. Context 0 is one symbol: fm2 < 2,
    // so the code is the marker alone and the value l. The value is at
    // most l + ctx <= h, so int32 holds it.
    const int nn = ctx + 1;
    const int m = 31 - __clz(nn);
    const int p2m = 1 << m;
    const int left_p = nn - p2m;
    const int right_p = p2m - left_p;
    const int fm2 = static_cast<int>(head >> (30 - m)) - 2 * p2m;
    const int first_m = fm2 >> 1;
    const bool longer = first_m >= right_p;
    const int r = (longer ? fm2 - right_p : first_m) + left_p;
    const int32_t in_value =
        static_cast<int32_t>(static_cast<uint32_t>(l) + static_cast<uint32_t>(r >= nn ? r - nn : r));

    // Out of range: sign bit, unary run (never past 32*W), k remainder
    // bits. The Rice value (q << k) + rem is hi:lo, 64 bits or more, as a
    // corrupt run can be 32 * W ones long; any bit above lo saturates it.
    uint32_t* trow = table + flct::bucket_of(static_cast<uint32_t>(ctx), nb) * K * tpb;
    uint32_t row[K];
    flct::load_row(trow, tpb, row);
    const int k = flct::k_select(row);
    br.skip(in ? (longer ? m + 2 : m + 1) : 2);
    RunCount<Pos> q = 0;
    if (!in) {
      while (br.pos() < limit) {
        const uint32_t inv = ~br.peek32();
        if (inv != 0u) {
          const int lead = __clz(static_cast<int>(inv));
          q += lead;
          br.skip(lead + 1);
          break;
        }
        q += 32;
        br.skip(32);
      }
    }
    const uint32_t rem = k > 0 && !in ? br.peek(k) : 0u;
    br.skip(in ? 0 : k);
    const uint32_t lo = static_cast<uint32_t>(q << k) | rem;
    // Bits 32.. of the Rice value: q >> (32 - k), or q >> 32 when k = 0
    // (always 0 for a 32-bit count).
    const RunCount<Pos> hi_all = k > 0 ? q >> (32 - k) : (q >> 16) >> 16;
    const uint32_t hi = static_cast<uint32_t>(hi_all);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      row[j] += in ? 0u : __funnelshift_r(lo, hi, j) + 1u + j;
    }
    flct::store_row(trow, tpb, row);
    // h + 1 + e, or l - 1 - e, saturated to int32.
    const bool above = (head >> 30) & 1u;
    const uint32_t room = above ? 0x7FFFFFFFu - static_cast<uint32_t>(h)
                                : static_cast<uint32_t>(l) ^ 0x80000000u;
    const int32_t out_value =
        hi_all != 0u || lo >= room
            ? (above ? INT32_MAX : INT32_MIN)
            : static_cast<int32_t>(above ? static_cast<uint32_t>(h) + 1u + lo
                                         : static_cast<uint32_t>(l) - 1u - lo);
    return in ? in_value : out_value;
  }
};

// Row y of the block's tiles, from their rings (entry x of tile i at
// ring[x * (tpb + 1) + i]) to their planes, coalesced.
__device__ __forceinline__ void store_row(const int32_t* ring, const Params& p, int tile0, int c,
                                          int y) {
  __syncwarp();
  const int lane = threadIdx.x, tpb = blockDim.x;
  const long long t = static_cast<long long>(p.th) * p.tw;
  for (int i = 0; i < tpb && tile0 + i < p.n; ++i) {
    int32_t* dst = p.out + (static_cast<long long>(tile0 + i) * p.C + c) * t +
                   static_cast<long long>(y) * p.tw;
    for (int x = lane; x < p.tw; x += tpb) dst[x] = ring[x * (tpb + 1) + i];
  }
  __syncwarp();
}

template <int K, bool kRingShared, typename Pos>
__global__ void __launch_bounds__(kMaxTiles) flct_decode_kernel(const Params p) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x, tpb = blockDim.x;
  const int rs = tpb + 1;  // ring stride: a column's entries in distinct banks
  const int tile0 = blockIdx.x * tpb;
  // A thread past the last tile decodes the last tile again and stores
  // nothing, so that every thread takes part in the row copies.
  const int tile = min(tile0 + lane, p.n - 1);
  const int nbk = p.nb * K;
  int32_t* ring_all = kRingShared
                          ? reinterpret_cast<int32_t*>(smem + flct::kMaxBuckets * K * tpb)
                          : p.rings + static_cast<long long>(blockIdx.x) * (p.tw + 1) * rs;
  int32_t* ring = ring_all + lane;  // entry x at ring[x * rs]

  Tile<K, Pos> s;
  s.br.init(p.words + tile * p.W, static_cast<Pos>(p.W));
  s.table = smem + lane;
  s.tpb = tpb;
  s.nb = p.nb;
  s.max_context = p.max_context;
  s.limit = static_cast<Pos>(p.W * 32);
  const int32_t* pr = p.prior + tile * p.prior_stride;
  const int tw = p.tw;

  for (int c = 0; c < p.C; ++c) {
    const int pw = p.depth + (c > 0 ? 1 : 0);  // <= 17
    int32_t v01[2];
    for (int j = 0; j < 2; ++j) {
      const uint32_t raw = s.br.peek(pw);
      s.br.skip(pw);
      long long v = raw;
      if (c > 0 && (raw >> (pw - 1)) != 0u) v -= (1ll << pw);
      v01[j] = static_cast<int32_t>(v);
    }
    for (int e = 0; e < nbk; ++e) {
      s.table[e * tpb] = static_cast<uint32_t>(__ldg(pr + c * nbk + e));
    }

    // Row 0: (left, left-left).
    ring[0] = v01[0];
    ring[rs] = v01[1];
    int32_t p2 = v01[0], p1 = v01[1];
    for (int x = 2; x < tw; ++x) {
      const int32_t v = s.step(p1, p2);
      ring[x * rs] = v;
      p2 = p1;
      p1 = v;
    }
    store_row(ring_all, p, tile0, c, 0);

    // Rows 1..: x = 0 takes (above, above-right) on row 1 and (above,
    // above-above) below it; x > 0 takes (left, above).
    int32_t up2 = 0;  // the first column two rows up
    for (int y = 1; y < p.th; ++y) {
      const int32_t up = ring[0];
      int32_t above = ring[rs];
      int32_t v = s.step(up, y == 1 ? above : up2);
      up2 = up;
      ring[0] = v;
      for (int x = 1; x < tw; ++x) {
        const int32_t above_next = ring[(x + 1) * rs];  // entry tw is padding
        v = s.step(v, above);
        ring[x * rs] = v;
        above = above_next;
      }
      store_row(ring_all, p, tile0, c, y);
    }
  }
}

template <int K, bool kRingShared, typename Pos>
cudaError_t launch(const Params& p, int tpb, size_t smem, cudaStream_t stream) {
  auto kernel = flct_decode_kernel<K, kRingShared, Pos>;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.n + tpb - 1) / tpb;
  kernel<<<blocks, tpb, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Pos>
cudaError_t launch_for(const Params& p, int K, int tpb, int ring_shared, size_t smem,
                       cudaStream_t s) {
  if (K == 6) {
    return ring_shared ? launch<6, true, Pos>(p, tpb, smem, s)
                       : launch<6, false, Pos>(p, tpb, smem, s);
  }
  return ring_shared ? launch<15, true, Pos>(p, tpb, smem, s)
                     : launch<15, false, Pos>(p, tpb, smem, s);
}

}  // namespace

extern "C" {

// Launches K2 on `stream`, one block of `tpb` threads (1..32) per `tpb`
// tiles; returns cudaGetLastError() (0 = ok). C is 1 or 3, K 6 or 15,
// nb <= 6, tiles at least 2x2. `wide_positions` 0 takes the int-position
// instantiation, which needs 32 * W plus 20 bits a pixel step (the most a
// step reads past the words) below 2^31; 1 takes the long long one, for
// any row. `rings` ((n + tpb - 1) / tpb, (tw + 1) * (tpb + 1)) int32 is
// read only when `ring_shared` is 0.
int flct_decode(const void* words, const void* prior, long long prior_stride,
                void* out, int n, int C, int th, int tw, int depth, int nb,
                int K, int max_context, long long W, int tpb, int ring_shared,
                int wide_positions, void* rings, void* stream) {
  if (!(C == 1 || C == 3) || nb > flct::kMaxBuckets || th < 2 || tw < 2 ||
      !(K == 6 || K == 15) || tpb < 1 || tpb > kMaxTiles ||
      (!wide_positions && W * 32 + 20LL * C * th * tw + 64 > INT32_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const uint32_t*>(words), W, static_cast<const int32_t*>(prior),
                 prior_stride, static_cast<int32_t*>(out), static_cast<int32_t*>(rings),
                 n, C, th, tw, depth, nb, max_context};
  // The k-table, plus the rings when they are shared (ops/tile_codec.py
  // decode_smem_bytes decides with the same sum).
  const size_t smem =
      (flct::kMaxBuckets * K * tpb + (ring_shared ? (tw + 1ULL) * (tpb + 1) : 0ULL)) * 4;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = wide_positions
                            ? launch_for<long long>(p, K, tpb, ring_shared, smem, s)
                            : launch_for<int>(p, K, tpb, ring_shared, smem, s);
  return static_cast<int>(e);
}

}  // extern "C"
