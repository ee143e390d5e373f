// FLCT tile decoder (kernel K2): one thread per tile, a few tiles a
// block, with nothing on a thread's serial chain read from device memory
// but the next words of its stream.
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
// At the serve stream's chunk (192 gray8 tiles of 64x64, one tile a block)
// each chain has a warp to itself, and a step costs what that warp issues
// in order: its instructions, each dependent one's latency, and every wait
// on a load or a taken branch. Measured there (H100, 1980 MHz): ~430
// cycles a step (0.22 us) in the previous design, whose clock64() stamps
// put 180 on bit reads and skips, 100 on the k lookup (row load and
// compare tree), 80 on the unary run's loop; ~265 (0.13 us) in this one,
// whose in-range path is ~60 instructions and out-of-range path ~130
// (1 in 18,000-87,000 steps of photographic images takes the slow path).
// The step keeps its instructions and waits few:
// - one window, one advance: the 32 bits at the position (`head`, kept
//   across steps) hold the whole code whenever it is at most 32 bits long.
//   The marker bit, the phase-in bits, the unary run (one clz past the two
//   marker bits) and the k remainder bits are read from it at once, and
//   the code's length moves the position once: a roll of four words by
//   selects, with one predicated load whose word the window needs only a
//   whole word (32 bits of codes) later;
// - each bucket's k already chosen: the k of every bucket sits in one
//   register (a nibble each), so a step's k is a rotate by its bucket, and
//   only an out-of-range code reads its bucket's row of the k-table
//   (shared memory), adds its Rice lengths and chooses that bucket's k
//   again with the compare tree;
// - the marker picks one of two paths, so a step works out only its own
//   code: the phase-in value (a few selects over three candidates), or the
//   Rice value, the table update and the saturation checks;
// - the slow path, a run that does not fit the window (a code longer than
//   32 bits, or a corrupt run), walks it 32 bits at a time, with the same
//   saturation and never past bit 32*W; `slow_steps`, when given, counts
//   such steps;
// - neighbours: the left one, the one two to the left (row 0) and the first
//   column's two rows above are registers; the row above is a ring of
//   tw + 1 values in shared memory, read a pixel ahead of its use, two
//   pixels a loop turn so that no load is waited on (in global scratch when
//   the block's rings do not fit);
// - the nb x K k-table in shared memory, entry e of the block's tpb tiles
//   side by side, so any mix of rows across the warp is free of bank
//   conflicts; K is a template constant, so the update and the compare
//   tree unroll. Positions are 32-bit, or 64-bit in a second instantiation
//   that the wrapper takes only for rows too long for 32
//   (ops/tile_codec.py decode_wide_positions);
// - output: at the end of each row the block copies its tiles' rows from
//   the rings to the planes, coalesced; nothing on the chain reads it back.
// With several tiles a block, the tiles of a warp that take the other path
// wait for it; the wrapper picks the tiles a block (tpb, 1..32) that gives
// ~3 blocks an SM (ops/tile_codec.py decode_tiles_per_block).
//
// Debug build: nvcc -DFLCT_DECODE_CLOCKS adds clock64() stamps between a
// step's parts, summed over all threads and read with flct_decode_clocks.
// The shipped build never defines it.
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
  unsigned long long* slow_steps;  // null, or a count the slow-path steps are added to
  int n, C, th, tw, depth, nb, max_context;
};

#ifdef FLCT_DECODE_CLOCKS
// A step's parts: context, k lookup, bit reads and the advance, slow run,
// value, table update, (per row) the row copy-out, and the ring and loop
// between steps; the last slot counts steps.
constexpr int kParts = 8;
__device__ unsigned long long flct_decode_clock_sums[kParts + 1];

struct Clocks {
  unsigned long long acc[kParts] = {}, last = 0, steps = 0;
  uint32_t sink = 0;
  // Cycles since the last stamp go to `part`; the stamp waits for `dep`.
  __device__ __forceinline__ void stamp(int part, uint32_t dep) {
    unsigned long long now;
    asm volatile("add.u32 %1, %1, %2;\n\tmov.u64 %0, %%clock64;"
                 : "=l"(now), "+r"(sink) : "r"(dep) : "memory");
    acc[part] += now - last;
    last = now;
  }
  __device__ __forceinline__ void flush() {
    for (int i = 0; i < kParts; ++i) atomicAdd(&flct_decode_clock_sums[i], acc[i]);
    atomicAdd(&flct_decode_clock_sums[kParts], steps + (sink == 0x9E3779B9u));
  }
};
#define K2_STAMP(clk, part, dep) (clk).stamp(part, static_cast<uint32_t>(dep))
#else
#define K2_STAMP(clk, part, dep)
#endif

// MSB-first reader of one row: four words, with zeros past the row, and the
// 32 bits at the position (`head`) kept ready. Positions are Pos: int where
// 32 * W plus a step's reads stays below 2^31 (the fast path), long long
// above that.
template <typename Pos>
struct BitReader {
  const uint32_t* row;
  Pos W, next;  // next: index of the word after w3
  uint32_t w0, w1, w2, w3;
  uint32_t head;  // bits s.. of w0:w1
  int s;          // bits of w0 consumed, 0..31

  __device__ __forceinline__ uint32_t word(Pos i) const {
    return i < W ? __ldg(row + i) : 0u;
  }

  __device__ __forceinline__ void init(const uint32_t* r, Pos w) {
    row = r;
    W = w;
    w0 = word(0);
    w1 = word(1);
    w2 = word(2);
    w3 = word(3);
    next = 4;
    s = 0;
    head = w0;
  }

  // The next n bits, 0 < n <= 32.
  __device__ __forceinline__ uint32_t peek(int n) const { return head >> (32 - n); }

  // n <= 32: the window moves at most one word, by selects and one
  // predicated load (a branch here would cost more than the selects).
  __device__ __forceinline__ void advance(int n) {
    const int t = s + n;
    const bool roll = t >= 32;
    const uint32_t stay = __funnelshift_l(w1, w0, t);  // shift t & 31
    const uint32_t moved = __funnelshift_l(w2, w1, t);
    head = roll ? moved : stay;
    w0 = roll ? w1 : w0;
    w1 = roll ? w2 : w1;
    w2 = roll ? w3 : w2;
    w3 = roll ? 0u : w3;
    const int fetch = roll && next < W;
    asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t@p ld.global.nc.u32 %0, [%1];\n\t}"
        : "+r"(w3)
        : "l"(row + next), "r"(fetch));
    next += roll;
    s = t & 31;
  }

  __device__ __forceinline__ Pos pos() const { return ((next - 4) << 5) + s; }
};

// The unary run's count on the slow path: 32 bits beside 32-bit positions;
// beside 64-bit ones a corrupt run can pass 2^32 ones, and the count keeps
// them all so that the value saturates as the plain version's does.
template <typename Pos>
using RunCount = typename std::conditional<sizeof(Pos) == 8, uint64_t, uint32_t>::type;

// Shift of bucket b's k in Tile::kbest: nibble (32 - b) mod 8, so that the
// clz of the clipped context rotates it to the bottom.
__device__ __forceinline__ int kbest_shift(int clz) { return (clz << 2) & 31; }

template <int K, typename Pos>
struct Tile {
  BitReader<Pos> br;
  uint32_t* table;  // entry e at table[e * tpb]
  int tpb;          // tiles a block
  uint32_t max_context;
  uint32_t dcap;    // 2^bcap - 1: the bucket is bit_length(min(d, dcap))
  uint32_t kbest;   // each bucket's k (a nibble, kbest_shift)
  uint32_t slow;    // slow-path steps
  Pos limit;
#ifdef FLCT_DECODE_CLOCKS
  Clocks clk;
#endif

  // Every bucket's k from its row of the table (the plane's prior).
  __device__ __forceinline__ void choose_all(int nb) {
    kbest = 0;
    for (int b = 0; b < nb; ++b) {
      uint32_t row[K];
      flct::load_row(table + b * K * tpb, tpb, row);
      kbest |= static_cast<uint32_t>(flct::k_select(row)) << kbest_shift(32 - b);
    }
  }

  // One pixel from its two neighbours' values.
  __device__ __forceinline__ int32_t step(int32_t va, int32_t vb) {
    K2_STAMP(clk, 7, va ^ vb);
    const int32_t h = va > vb ? va : vb;
    const int32_t l = va < vb ? va : vb;
    const uint32_t d = static_cast<uint32_t>(h) - static_cast<uint32_t>(l);  // exact: h >= l
    const uint32_t head = br.head;
    K2_STAMP(clk, 0, d);
    int32_t v;
    int len;
    if (head >> 31) {
      // In range: phase-in over nn = ctx + 1 symbols, m = 31 - cn. After
      // the marker, y = the next m + 1 bits. A short code is y's first m
      // bits, less than right_p = 2^(m+1) - nn, and the value is
      // l + left_p + y / 2 (left_p = nn - 2^m). A long code is all of y,
      // y - right_p, and the value l + left_p + y - right_p, less nn when
      // that passes h. Context 0 is one symbol: the marker alone, value l.
      // The value is at most h, so int32 holds it.
      const uint32_t nn = min(d, max_context) + 1;
      const int cn = __clz(static_cast<int>(nn));
      const uint32_t p2m = 0x80000000u >> cn;
      const uint32_t y = (head << 1) >> cn;
      K2_STAMP(clk, 2, y + p2m);
      const uint32_t a = static_cast<uint32_t>(l) + nn;
      const uint32_t t3 = 3 * p2m;
      const bool longer = y >= 4 * p2m - 2 * nn;  // y / 2 >= right_p
      const bool wrap = y >= t3 - nn;             // the long value passes h
      v = static_cast<int32_t>(longer ? (wrap ? a - t3 + y : a + nn - t3 + y)
                                      : a - p2m + (y >> 1));
      len = 32 - cn + longer;  // marker, m bits, one more if long
      K2_STAMP(clk, 4, v + len);
    } else {
      // Out of range: sign bit, q ones and a zero, k remainder bits. When
      // they fit the window (3 + q + k <= 32), lo = (q << k) | the k bits
      // after the zero.
      const int cb = __clz(static_cast<int>(min(d, dcap)));  // bucket 32 - cb
      uint32_t* trow = table + (32 - cb) * K * tpb;
      uint32_t row[K];
      flct::load_row(trow, tpb, row);
      const int k = static_cast<int>(__funnelshift_r(kbest, kbest, cb << 2) & 15u);
      K2_STAMP(clk, 1, k);
      const int q = __clz(static_cast<int>(~(head << 2)));  // 0..30
      len = 3 + q + k;
      uint32_t lo = __funnelshift_l(__funnelshift_lc(0u, head, 3 + q), static_cast<uint32_t>(q), k);
      uint32_t hi = 0;   // bits 32..63 of the Rice value (slow path only)
      bool big = false;  // the Rice value passes 64 bits (slow path only)
      K2_STAMP(clk, 2, len + lo);
      if (__builtin_expect(len > 32, 0)) {
        // Slow path: the run, 32 bits at a time, never past 32*W, then the
        // remainder. The Rice value (q << k) + rem is hi:lo, 64 bits or
        // more, as a corrupt run can be 32 * W ones long; any bit above lo
        // saturates it.
        ++slow;
        br.advance(2);
        RunCount<Pos> run = 0;
        while (br.pos() < limit) {
          const uint32_t inv = ~br.head;
          if (inv != 0u) {
            const int lead = __clz(static_cast<int>(inv));
            run += lead;
            br.advance(lead + 1);
            break;
          }
          run += 32;
          br.advance(32);
        }
        const uint32_t rem = k > 0 ? br.peek(k) : 0u;
        br.advance(k);
        lo = static_cast<uint32_t>(run << k) | rem;
        // run >> (32 - k), or run >> 32 when k = 0 (always 0 for a 32-bit count).
        const RunCount<Pos> hi_all = k > 0 ? run >> (32 - k) : (run >> 16) >> 16;
        hi = static_cast<uint32_t>(hi_all);
        big = hi_all != 0u;
        len = 0;
        K2_STAMP(clk, 3, lo);
      }
      // The bucket's row takes the Rice length at every k; the compare tree
      // chooses its k again.
#pragma unroll
      for (int j = 0; j < K; ++j) row[j] += __funnelshift_r(lo, hi, j) + 1u + j;
      flct::store_row(trow, tpb, row);
      const int sh = kbest_shift(cb);
      kbest = (kbest & ~(15u << sh)) | (static_cast<uint32_t>(flct::k_select(row)) << sh);
      K2_STAMP(clk, 5, kbest);
      // h + 1 + e, or l - 1 - e, saturated to int32.
      const bool above = (head >> 30) & 1u;
      const uint32_t room = above ? 0x7FFFFFFFu - static_cast<uint32_t>(h)
                                  : static_cast<uint32_t>(l) ^ 0x80000000u;
      v = big || lo >= room ? (above ? INT32_MAX : INT32_MIN)
                            : static_cast<int32_t>(above ? static_cast<uint32_t>(h) + 1u + lo
                                                         : static_cast<uint32_t>(l) - 1u - lo);
      K2_STAMP(clk, 4, v);
    }
    br.advance(len);
    K2_STAMP(clk, 2, br.head);
#ifdef FLCT_DECODE_CLOCKS
    ++clk.steps;
#endif
    return v;
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
  // The lane through an opaque move: the compiler would otherwise read
  // SR_TID again inside the step for the table's address, and wait on it.
  int lane;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(lane));
  const int tpb = blockDim.x;
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
  s.max_context = static_cast<uint32_t>(p.max_context);
  // The bucket min(bit_length(min(d, max_context)), nb - 1) is
  // bit_length(min(d, 2^bcap - 1)) with bcap = min(nb - 1, bit_length(max_context)).
  const int bcap = min(p.nb - 1, 32 - __clz(p.max_context));
  s.dcap = (1u << bcap) - 1u;
  s.slow = 0;
#ifdef FLCT_DECODE_CLOCKS
  s.clk.last = clock64();
#endif
  s.limit = static_cast<Pos>(p.W * 32);
  const int32_t* pr = p.prior + tile * p.prior_stride;
  const int tw = p.tw;

  for (int c = 0; c < p.C; ++c) {
    const int pw = p.depth + (c > 0 ? 1 : 0);  // <= 17
    int32_t v01[2];
    for (int j = 0; j < 2; ++j) {
      const uint32_t raw = s.br.peek(pw);
      s.br.advance(pw);
      long long v = raw;
      if (c > 0 && (raw >> (pw - 1)) != 0u) v -= (1ll << pw);
      v01[j] = static_cast<int32_t>(v);
    }
    for (int e = 0; e < nbk; ++e) {
      s.table[e * tpb] = static_cast<uint32_t>(__ldg(pr + c * nbk + e));
    }
    s.choose_all(p.nb);

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
    K2_STAMP(s.clk, 7, p1);
    store_row(ring_all, p, tile0, c, 0);
    K2_STAMP(s.clk, 6, 0);

    // Rows 1..: x = 0 takes (above, above-right) on row 1 and (above,
    // above-above) below it; x > 0 takes (left, above). The row above is
    // read a pixel ahead (entry tw is padding), two pixels a turn, so that
    // no value is moved out of a load still in flight.
    int32_t up2 = 0;  // the first column two rows up
    for (int y = 1; y < p.th; ++y) {
      const int32_t up = ring[0];
      int32_t above = ring[rs];
      int32_t v = s.step(up, y == 1 ? above : up2);
      up2 = up;
      ring[0] = v;
      int x = 1;
      for (; x + 1 < tw; x += 2) {
        const int32_t above1 = ring[(x + 1) * rs];
        v = s.step(v, above);
        ring[x * rs] = v;
        const int32_t above2 = ring[(x + 2) * rs];
        v = s.step(v, above1);
        ring[(x + 1) * rs] = v;
        above = above2;
      }
      if (x < tw) {
        v = s.step(v, above);
        ring[x * rs] = v;
      }
      K2_STAMP(s.clk, 7, v);
      store_row(ring_all, p, tile0, c, y);
      K2_STAMP(s.clk, 6, 0);
    }
  }
  if (p.slow_steps != nullptr && tile0 + lane < p.n) atomicAdd(p.slow_steps, s.slow);
#ifdef FLCT_DECODE_CLOCKS
  if (tile0 + lane < p.n) s.clk.flush();
#endif
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
// 1 <= nb <= 6, tiles at least 2x2. `wide_positions` 0 takes the
// int-position instantiation, which needs 32 * W plus 20 bits a pixel step
// (the most a step reads past the words) below 2^31; 1 takes the long long
// one, for any row. `rings` ((n + tpb - 1) / tpb, (tw + 1) * (tpb + 1))
// int32 is read only when `ring_shared` is 0. `slow_steps`, when not null,
// is one uint64 that the count of slow-path steps is added to.
int flct_decode(const void* words, const void* prior, long long prior_stride,
                void* out, int n, int C, int th, int tw, int depth, int nb,
                int K, int max_context, long long W, int tpb, int ring_shared,
                int wide_positions, void* rings, void* slow_steps, void* stream) {
  if (!(C == 1 || C == 3) || nb < 1 || nb > flct::kMaxBuckets || th < 2 || tw < 2 ||
      !(K == 6 || K == 15) || tpb < 1 || tpb > kMaxTiles || max_context < 0 ||
      (!wide_positions && W * 32 + 20LL * C * th * tw + 64 > INT32_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const uint32_t*>(words), W, static_cast<const int32_t*>(prior),
                 prior_stride, static_cast<int32_t*>(out), static_cast<int32_t*>(rings),
                 static_cast<unsigned long long*>(slow_steps),
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

#ifdef FLCT_DECODE_CLOCKS
// Copies the clock sums (kParts cycle sums, then the step count) to `host`
// and zeroes them when `reset` is set; returns a cudaError_t.
int flct_decode_clocks(unsigned long long* host, int reset) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, flct_decode_clock_sums, sizeof(flct_decode_clock_sums));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[kParts + 1] = {};
    e = cudaMemcpyToSymbol(flct_decode_clock_sums, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#endif

}  // extern "C"
