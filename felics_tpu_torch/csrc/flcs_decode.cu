// FLCS single-stream decoder (kernel K4): one block per image lane; its
// threads zero the k-table, then one thread walks the lane's pixels.
//
// Replaces the XLA lax.scan of felics_tpu/core/jax_codec.py::
// decode_channel_scan (:303-440), as _decode_images_scan (:492-510) runs it:
// each lane walks its C channels in sequence through one bit cursor. It is
// not a TPU Pallas kernel: on the TPU XLA compiles the scan (with a
// while_loop per step for the unary run) into one device loop.
//
// Per channel: the two raw 32-bit first pixels (bit-cast to int32), a
// (max_context + 1, K) k-table of zeros, then per pixel the marker bit and
// either the phase-in value over n = ctx + 1 or the second marker bit, the
// unary run and k remainder bits, with the table update, exactly as the
// reference's step.
//
// Every value follows the reference's int32 arithmetic, including
// wrap-around on corrupt streams: sums are formed in uint32 and cast, and
// >> on int32 is arithmetic. Words are read as the reference's gather reads
// them: an index past the buffer reads its last word. Such a read only
// happens once the cursor has reached the end of the words, and then the
// final position check or the overrun flag rejects the stream whatever was
// read. The context is clipped to [0, max_context]. The unary run stops at
// bit 32*W and raises the lane's overrun flag, counted only when the
// out-of-range branch was taken.
//
// What bounds it on an H100: nothing the card can spread. A lane is one
// chain of C * H * W dependent steps (a step's context needs the value
// decoded just before it, and its bits start where the last code ended),
// and the batch gives only a few lanes. So the design cuts the latency of
// one step, keeping every read on the chain out of device memory:
// - Neighbours. The left neighbour is the value decoded one step before,
//   held in a register. The row above is a ring of width + 1 int32 in
//   shared memory, read one pixel ahead of its use; the first column's two
//   rows above, and a single row's or column's two previous values, are
//   registers. A row too wide for shared memory keeps its ring in a
//   global scratch row of the same layout (the wrapper decides, the
//   kernel is the same).
// - The k-table. K is a template constant (6 or 15, the two shipped
//   configs), so the k choice, the update and the row minimum unroll with
//   no bounds tests; the choice and the minimum are compare trees. Rows
//   are padded to RS = 8 or 16 int32 and moved as int4 vectors. When the
//   table fits in 48 KB (8-bit: 511 x 8 x 4 = 16,352 bytes) it lives in
//   shared memory; the 16-bit one (131,071 x 16 x 4 = 8.4 MB) stays in
//   global scratch, where it fits the 50 MB L2. The whole block zeroes it
//   before each channel with int4 stores.
// - Bits. Three words sit in registers, the third fetched when the first
//   is used up, so no field read waits on a load whose address depends on
//   the decoded data; a funnel shift reads 32 bits at any offset. The
//   unary run counts ones with __clz.
// - In range, a context of 0 leaves one symbol and no bits (the value is
//   the low neighbour); otherwise the phase-in remainder (number + left)
//   % n is a compare and subtract: number < n and left < n always hold,
//   whatever the bits.
//
// Measured on an H100 (chip_smoke.py; PERF.md): ~0.1 us a pixel step on
// 8-bit synthetic images against 0.39 for one thread reading everything
// from device memory. What is left is the step's own chain of dependent
// integer instructions and branches, issued by one warp.
//
// Layout: words (G, W) uint32 big-endian rows; tables (G, table_stride)
// int32 scratch, table_stride = (max_context + 1) * RS, used unless the
// table is shared; rings (G, width + 1) int32 scratch, used unless the ring
// is shared; out (G, C, n) int32; end (G,) int64 bit positions; overrun
// (G,) int32 flags.
#include <cuda_runtime.h>

#include <cstdint>

#include "flcs_common.cuh"

namespace {

constexpr int kThreads = 256;            // per block: all zero, thread 0 walks
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// MSB-first reader of one lane's words: the current word, the next, and
// the one after fetched ahead; a funnel shift reads 32 bits at any offset.
struct BitReader {
  const uint32_t* wp;    // the word after w2; stops at the last word
  const uint32_t* last;  // the row's last word
  uint32_t w0, w1, w2;
  int s;                 // bits of w0 consumed, 0..31
  long long base;        // stream position of w0's first bit

  // A read past the words gives the last word again, as the reference's
  // clamped gather does.
  __device__ __forceinline__ void init(const uint32_t* row, long long W) {
    last = row + (W - 1);
    w0 = __ldg(row);
    w1 = __ldg(row + (W > 1 ? 1 : 0));
    w2 = __ldg(row + (W > 2 ? 2 : W - 1));
    wp = row + (W > 3 ? 3 : W - 1);
    s = 0;
    base = 0;
  }

  __device__ __forceinline__ uint32_t peek32() const {
    return __funnelshift_l(w1, w0, s);
  }

  // The next n bits, 0 < n <= 32.
  __device__ __forceinline__ uint32_t peek(int n) const {
    return peek32() >> (32 - n);
  }

  // n <= 32: crosses at most one word.
  __device__ __forceinline__ void skip(int n) {
    s += n;
    if (s >= 32) {
      s -= 32;
      base += 32;
      w0 = w1;
      w1 = w2;
      w2 = __ldg(wp);
      wp += wp < last ? 1 : 0;
    }
  }


  __device__ __forceinline__ long long pos() const { return base + s; }
};

struct Params {
  const uint32_t* words;
  long long W;
  int C, height, width, max_context, count_scaling;
  int32_t* tables;
  long long table_stride;
  int32_t* rings;
  int32_t* out;
  long long* end_bit;
  int32_t* overrun;
};

template <int K, int RS>
struct Lane {
  BitReader br;
  int32_t* table;
  int max_context, count_scaling;
  long long limit;
  bool ov;

  // One pixel from its two neighbours' values.
  __device__ __forceinline__ int32_t step(int32_t va, int32_t vb) {
    const int32_t h = va > vb ? va : vb;
    const int32_t l = va < vb ? va : vb;
    const int32_t d = sub32(h, l);  // wraps negative on corrupt planes
    const int ctx = d < 0 ? 0 : (d > max_context ? max_context : d);
    const uint32_t head = br.peek32();

    if (head >> 31) {  // in range: phase-in over nn = ctx + 1
      if (ctx == 0) {  // one symbol, no bits: the value is l
        br.skip(1);
        return l;
      }
      const int nn = ctx + 1;
      const int m = 31 - __clz(nn);
      const int p2m = 1 << m;
      const int left_p = nn - p2m;
      const int right_p = p2m - left_p;
      // The marker, then m + 1 bits fm2 (m + 2 <= 19 in all): the first m
      // are the short code; a long code is all m + 1, less right_p.
      const int fm2 = static_cast<int>(br.peek(m + 2)) - 2 * p2m;
      const int first_m = fm2 >> 1;
      const bool longer = first_m >= right_p;
      const int number = longer ? fm2 - right_p : first_m;
      br.skip(longer ? m + 2 : m + 1);
      const int r = number + left_p;
      return add32(r >= nn ? r - nn : r, l);
    }

    // Out of range: sign bit, unary run, k remainder bits.
    int32_t* trow = table + static_cast<long long>(ctx) * RS;
    int32_t row[RS];
#pragma unroll
    for (int v = 0; v < RS / 4; ++v) {
      const int4 t = reinterpret_cast<const int4*>(trow)[v];
      row[4 * v] = t.x;
      row[4 * v + 1] = t.y;
      row[4 * v + 2] = t.z;
      row[4 * v + 3] = t.w;
    }
    const int k = flcs::argmin_last(row, K);
    const bool above = (head >> 30) & 1u;
    br.skip(2);
    uint32_t q = 0;
    while (true) {
      const uint32_t inv = ~br.peek32();
      if (inv != 0u) {
        const int lead = __clz(static_cast<int>(inv));
        q += lead;
        br.skip(lead + 1);
        break;
      }
      // 32 ones: the run goes on, unless it has reached the end of words.
      q += 32;
      const bool at_end = br.pos() >= limit;
      br.skip(32);
      if (at_end) {
        ov = true;
        break;
      }
    }
    const uint32_t rem = k > 0 ? br.peek(k) : 0u;
    br.skip(k);
    const int32_t encoded = static_cast<int32_t>((q << k) + rem);
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      if (j < K) {
        row[j] = add32(row[j], static_cast<int32_t>(static_cast<uint32_t>(encoded >> j) +
                                                    1u + static_cast<uint32_t>(j)));
      }
    }
    if (count_scaling >= 0 && flcs::min_of(row, K) > count_scaling) {
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        if (j < K) row[j] >>= 1;
      }
    }
#pragma unroll
    for (int v = 0; v < RS / 4; ++v) {
      reinterpret_cast<int4*>(trow)[v] =
          make_int4(row[4 * v], row[4 * v + 1], row[4 * v + 2], row[4 * v + 3]);
    }
    return above ? add32(add32(encoded, h), 1) : sub32(sub32(l, encoded), 1);
  }
};

// One channel plane of n = height * width >= 2 pixels; `ring` holds
// width + 1 int32. Inlined, so the lane's state stays in registers.
template <int K, int RS>
__device__ __forceinline__ void decode_plane(Lane<K, RS>& s, int32_t* plane, int height, int width,
                             int32_t* ring) {
  const long long n = static_cast<long long>(height) * width;
  const int32_t v0 = static_cast<int32_t>(s.br.peek32());
  s.br.skip(32);
  const int32_t v1 = static_cast<int32_t>(s.br.peek32());
  s.br.skip(32);
  plane[0] = v0;
  plane[1] = v1;

  int32_t* dst = plane + 2;
  if (width == 1 || height == 1) {  // one row or column: neighbours i-1, i-2
    int32_t p2 = v0, p1 = v1;
    for (int32_t* const stop = plane + n; dst < stop; ++dst) {
      const int32_t v = s.step(p1, p2);
      *dst = v;
      p2 = p1;
      p1 = v;
    }
    return;
  }

  // Row 0: (left, left-left).
  ring[0] = v0;
  ring[1] = v1;
  int32_t p2 = v0, p1 = v1;
  for (int x = 2; x < width; ++x, ++dst) {
    const int32_t v = s.step(p1, p2);
    ring[x] = v;
    *dst = v;
    p2 = p1;
    p1 = v;
  }
  // Rows 1..: x = 0 takes (above, above-right) on row 1 and (above,
  // above-above) below it; x > 0 takes (left, above).
  int32_t up2 = 0;  // the first column two rows up
  for (int y = 1; y < height; ++y) {
    const int32_t up = ring[0];
    int32_t above = ring[1];
    int32_t v = s.step(up, y == 1 ? above : up2);
    up2 = up;
    ring[0] = v;
    *dst++ = v;
    const int32_t* src = ring + 2;  // ring[width] is padding
    for (int32_t* slot = ring + 1; slot < ring + width; ++slot, ++src, ++dst) {
      const int32_t above_next = *src;
      v = s.step(v, above);
      *slot = v;
      *dst = v;
      above = above_next;
    }
  }
}

template <int K, bool kTableShared, bool kRingShared>
__global__ void __launch_bounds__(kThreads) flcs_decode_kernel(const Params p) {
  constexpr int RS = (K + 3) & ~3;
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int lane = blockIdx.x;
  const long long n = static_cast<long long>(p.height) * p.width;
  const long long table_ints = (p.max_context + 1LL) * RS;
  int32_t* table = kTableShared ? smem : p.tables + lane * p.table_stride;
  int32_t* ring = kRingShared ? smem + (kTableShared ? table_ints : 0)
                              : p.rings + lane * (p.width + 1LL);

  Lane<K, RS> s;
  if (threadIdx.x == 0) {
    s.br.init(p.words + lane * p.W, p.W);
    s.table = table;
    s.max_context = p.max_context;
    s.count_scaling = p.count_scaling;
    s.limit = p.W * 32;
    s.ov = false;
  }
  for (int c = 0; c < p.C; ++c) {
    int4* t4 = reinterpret_cast<int4*>(table);
    for (long long i = threadIdx.x; i < table_ints / 4; i += kThreads) {
      t4[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      decode_plane(s, p.out + (static_cast<long long>(lane) * p.C + c) * n, p.height,
                   p.width, ring);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    p.end_bit[lane] = s.br.pos();
    p.overrun[lane] = s.ov ? 1 : 0;
  }
}

template <int K, bool kTableShared, bool kRingShared>
cudaError_t launch(const Params& p, int G, size_t smem, cudaStream_t stream) {
  auto kernel = flcs_decode_kernel<K, kTableShared, kRingShared>;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<G, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(const Params& p, int G, bool table_shared, bool ring_shared,
                     size_t smem, cudaStream_t stream) {
  if (table_shared) {
    return ring_shared ? launch<K, true, true>(p, G, smem, stream)
                       : launch<K, true, false>(p, G, smem, stream);
  }
  return ring_shared ? launch<K, false, true>(p, G, smem, stream)
                     : launch<K, false, false>(p, G, smem, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block may opt in to on the current device
// (bytes), or -1 on error.
int flcs_decode_smem_limit(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Launches K4 on `stream`, one block of 256 threads per lane; returns
// cudaGetLastError() (0 = ok). K is 6 with a row stride `rs` of 8, or 15
// with 16; `tables` is read only when `table_shared` is 0, `rings` only
// when `ring_shared` is 0.
int flcs_decode(const void* words, long long W, int G, int C, int height, int width,
                int K, int max_context, int count_scaling, int rs, int table_shared,
                void* tables, int ring_shared, void* rings, void* out, void* end_bit,
                void* overrun, void* stream) {
  if (!((K == 6 && rs == 8) || (K == 15 && rs == 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{static_cast<const uint32_t*>(words),
                 W,
                 C,
                 height,
                 width,
                 max_context,
                 count_scaling,
                 static_cast<int32_t*>(tables),
                 (max_context + 1LL) * rs,
                 static_cast<int32_t*>(rings),
                 static_cast<int32_t*>(out),
                 static_cast<long long*>(end_bit),
                 static_cast<int32_t*>(overrun)};
  const size_t smem = (table_shared ? (max_context + 1ULL) * rs * 4 : 0) +
                      (ring_shared ? (width + 1ULL) * 4 : 0);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = K == 6 ? dispatch<6>(p, G, table_shared, ring_shared, smem, s)
                               : dispatch<15>(p, G, table_shared, ring_shared, smem, s);
  return static_cast<int>(e);
}

}  // extern "C"
