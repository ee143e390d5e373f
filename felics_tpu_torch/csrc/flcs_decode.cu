// FLCS single-stream decoder (kernel K4), one CUDA thread per image lane.
//
// Replaces the XLA lax.scan of felics_tpu/core/jax_codec.py::
// decode_channel_scan (:303-440), as _decode_images_scan (:492-510) runs it:
// each lane walks its C channels in sequence through one bit cursor. It is
// not a TPU Pallas kernel: on the TPU XLA compiles the scan (with a
// while_loop per step for the unary run) into one device loop.
//
// Per channel: the two raw 32-bit first pixels (bit-cast to int32), a
// (max_context + 1, K) int32 k-table zeroed in the lane's global scratch,
// then per pixel the marker bit and either the phase-in value over
// n = ctx + 1 or the second marker bit, the unary run and k remainder bits,
// with the table update, exactly as the reference's step.
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
// Layout: words (G, W) uint32 big-endian rows; table scratch (G, stride)
// int32 with stride >= (max_context + 1) * K a multiple of 4 (16-byte
// aligned rows, zeroed with vector stores); out (G, C, n) int32; end (G,)
// int64 bit positions; overrun (G,) int32 flags.
//
// What bounds it on an H100: one thread's chain of C * H * W dependent
// pixel steps, each waiting on loads of its neighbours and table row from
// global memory. With one lane per image the card is nearly idle; each
// lane gets a block of its own so lanes never share a warp and diverge.
// Register-held rows and shared-memory tables are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "flct_common.cuh"

namespace {

struct Words {
  const uint32_t* row;
  long long W;

  // The reference's gather clamps an index past the buffer to its end.
  __device__ __forceinline__ uint32_t word(long long i) const {
    return __ldg(row + (i < W ? i : W - 1));
  }

  __device__ __forceinline__ uint32_t peek32(long long pos) const {
    const long long wi = pos >> 5;
    const int off = static_cast<int>(pos & 31);
    return flct::shl32(word(wi), off) | flct::shr32(word(wi + 1), 32 - off);
  }

  __device__ __forceinline__ uint32_t bit(long long pos) const {
    return peek32(pos) >> 31;
  }
};

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__global__ void flcs_decode_kernel(const uint32_t* __restrict__ words,
                                   long long W, int C, int height, int width,
                                   int K, int max_context, int count_scaling,
                                   int32_t* __restrict__ tables,
                                   long long stride,
                                   int32_t* __restrict__ out,
                                   long long* __restrict__ end_bit,
                                   int32_t* __restrict__ overrun) {
  const int lane = blockIdx.x;
  const long long n = static_cast<long long>(height) * width;
  const Words wr{words + lane * W, W};
  const long long limit = W * 32;
  int32_t* table = tables + lane * stride;
  long long pos = 0;
  bool ov = false;

  for (int c = 0; c < C; ++c) {
    int32_t* plane = out + (static_cast<long long>(lane) * C + c) * n;
    int4* t4 = reinterpret_cast<int4*>(table);
    for (long long i = 0; i < stride / 4; ++i) t4[i] = make_int4(0, 0, 0, 0);
    plane[0] = static_cast<int32_t>(wr.peek32(pos));
    plane[1] = static_cast<int32_t>(wr.peek32(pos + 32));
    pos += 64;

    for (long long i = 2; i < n; ++i) {
      int ia, ib;
      flct::neighbours(static_cast<int>(i), width, &ia, &ib);
      const int32_t va = plane[ia], vb = plane[ib];
      const int32_t h = va > vb ? va : vb;
      const int32_t l = va < vb ? va : vb;
      const int32_t d = sub32(h, l);  // wraps negative on corrupt planes
      const int ctx = d < 0 ? 0 : (d > max_context ? max_context : d);
      int32_t* row = table + static_cast<long long>(ctx) * K;
      int32_t value;

      if (wr.bit(pos) != 0u) {  // in range: phase-in over nn = ctx + 1
        const int nn = ctx + 1;
        const int m = 31 - __clz(nn);
        const int left_p = nn - (1 << m);
        const int right_p = (1 << (m + 1)) - nn;
        const int first_m =
            m > 0 ? static_cast<int>(wr.peek32(pos + 1) >> (32 - m)) : 0;
        int number, len;
        if (first_m < right_p) {
          number = first_m;
          len = m;
        } else {
          number = (first_m - right_p) * 2 + right_p +
                   static_cast<int>(wr.bit(pos + 1 + m));
          len = m + 1;
        }
        value = add32((number + left_p) % nn, l);
        pos += 1 + len;
      } else {  // out of range: sign bit, unary run, k remainder bits
        int k = 0;
        int32_t lo = row[0];
        for (int j = 1; j < K; ++j) {
          if (row[j] <= lo) {  // ties go to the largest k
            lo = row[j];
            k = j;
          }
        }
        const bool above = wr.bit(pos + 1) != 0u;
        uint32_t q = 0;
        long long p = pos + 2;
        while (true) {
          const uint32_t inv = ~wr.peek32(p);
          const int lead = inv != 0u ? __clz(static_cast<int>(inv)) : 32;
          const bool finished = lead < 32 || p >= limit;
          if (lead == 32 && finished) ov = true;
          q += lead;
          p += lead + (finished && lead < 32 ? 1 : 0);
          if (finished) break;
        }
        const uint32_t rem = k > 0 ? wr.peek32(p) >> (32 - k) : 0u;
        const int32_t encoded = static_cast<int32_t>((q << k) + rem);
        value = above ? add32(add32(encoded, h), 1) : sub32(sub32(l, encoded), 1);
        pos = p + k;
        int32_t mn = INT32_MAX;
        for (int j = 0; j < K; ++j) {
          const int32_t add = static_cast<int32_t>(
              static_cast<uint32_t>(encoded >> j) + 1u + static_cast<uint32_t>(j));
          row[j] = add32(row[j], add);
          mn = row[j] < mn ? row[j] : mn;
        }
        if (count_scaling >= 0 && mn > count_scaling) {
          for (int j = 0; j < K; ++j) row[j] >>= 1;
        }
      }
      plane[i] = value;
    }
  }
  end_bit[lane] = pos;
  overrun[lane] = ov ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches K4 on `stream`, one block of one thread per lane; returns
// cudaGetLastError() (0 = ok).
int flcs_decode(const void* words, long long W, int G, int C, int height,
                int width, int K, int max_context, int count_scaling,
                void* tables, long long stride, void* out, void* end_bit,
                void* overrun, void* stream) {
  flcs_decode_kernel<<<G, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), W, C, height, width, K,
      max_context, count_scaling, static_cast<int32_t*>(tables), stride,
      static_cast<int32_t*>(out), static_cast<long long*>(end_bit),
      static_cast<int32_t*>(overrun));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
