// FLCS adaptive-k scan (kernel K3), one CUDA thread per (lane, context
// segment).
//
// Replaces the XLA lax.scan step of felics_tpu/ops/kscan.py::kscan (the
// rank loop at :108-126, which advances every context's k-table by one
// update per step). It is not a TPU Pallas kernel: on the TPU the scan is
// compiled by XLA into one device loop, and in eager PyTorch it would be a
// Python loop of several launches per rank.
//
// Input: each lane's out-of-range pixels stable-sorted by context (raster
// order kept within a context), cut into segments of one context each. A
// thread walks its segment in order with the K-entry table (K <= 15) in
// registers: for each update it writes the k chosen BEFORE the update (the
// last index of the row's minimum) to k[lane, pixel], adds the Rice length
// row (v >> k) + 1 + k, and halves the row when its minimum exceeds
// count_scaling (strictly; -1 = never). Pixels that are not out of range
// keep the value the wrapper filled in (the largest k).
//
// Layout: residual (G, n) int32, raster order; order (G, n) int64, sorted
// slot -> raster pixel; seg (3, S) int32 rows lane, begin, end (sorted
// slots); k (G, n) int32.
//
// Table values stay far below 2^31 on any image (each update adds at most
// 2^17 + 15 and the halving holds the minimum near count_scaling), so plain
// int32 arithmetic is exact, as in the reference's int32 table.
//
// What bounds it on an H100: the longest segment's serial chain (argmin,
// add, min, halve over K registers per update), plus one dependent pair of
// loads (order, then residual) per update. Segments of a lane differ widely
// in length, so most threads finish early. Load prefetching and splitting
// the longest segments are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxK = 15;

__global__ void flcs_kscan_kernel(const int32_t* __restrict__ residual,
                                  const long long* __restrict__ order,
                                  const int32_t* __restrict__ seg,
                                  int32_t* __restrict__ k_out, int S,
                                  long long n, int K, int count_scaling) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const long long base = static_cast<long long>(seg[s]) * n;
  const int begin = seg[S + s], end = seg[2 * S + s];
  int32_t table[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) table[k] = 0;

  for (int pos = begin; pos < end; ++pos) {
    const long long pix = base + order[base + pos];
    const int32_t v = residual[pix];
    int best = 0;
    int32_t lo = table[0];
#pragma unroll
    for (int k = 1; k < kMaxK; ++k) {
      if (k < K && table[k] <= lo) {  // ties go to the largest k
        lo = table[k];
        best = k;
      }
    }
    k_out[pix] = best;
    int32_t mn = INT32_MAX;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        table[k] += (v >> k) + 1 + k;
        mn = table[k] < mn ? table[k] : mn;
      }
    }
    if (count_scaling >= 0 && mn > count_scaling) {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) table[k] >>= 1;
    }
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream`; returns cudaGetLastError() (0 = ok).
int flcs_kscan(const void* residual, const void* order, const void* seg,
               void* k_out, int S, long long n, int K, int count_scaling,
               void* stream) {
  constexpr int kThreads = 64;
  const int blocks = (S + kThreads - 1) / kThreads;
  flcs_kscan_kernel<<<blocks, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(residual),
      static_cast<const long long*>(order), static_cast<const int32_t*>(seg),
      static_cast<int32_t*>(k_out), S, n, K, count_scaling);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
