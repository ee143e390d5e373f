// FLCS adaptive-k scan (kernel K3), one CUDA thread per sorted slot; the
// thread at the first slot of a context segment walks the segment.
//
// Replaces the XLA lax.scan step of felics_tpu/ops/kscan.py::kscan (the
// rank loop at :108-126, which advances every context's k-table by one
// update per step). It is not a TPU Pallas kernel: on the TPU the scan is
// compiled by XLA into one device loop, and in eager PyTorch it would be a
// Python loop of several launches per rank.
//
// Input: each lane's out-of-range pixels stable-sorted by context (raster
// order kept within a context), their residuals gathered into that order,
// and each slot's rank within its context. A slot of rank 0 below the
// lane's out-of-range count starts a segment; its thread walks the slots
// after it until the next rank 0 or the count, with the K-entry table in
// registers: for each update it writes the k chosen BEFORE the
// update (the last index of the row's minimum) to k[lane, slot], adds the
// Rice length row (v >> k) + 1 + k, and halves the row when its minimum
// exceeds count_scaling (strictly; -1 = never). Every other thread returns
// at once, and slots that are not out of range keep the value the wrapper
// filled in (the largest k).
//
// Layout: residual (G, n) int32 and rank (G, n) int64, both in sorted
// order; num_oor (G,) int64; k (G, n) int32 in sorted order, scattered
// back to raster order by the wrapper.
//
// Table values stay far below 2^31 on any image (each update adds at most
// 2^17 + 15 and the halving holds the minimum near count_scaling), so plain
// int32 arithmetic is exact, as in the reference's int32 table.
//
// What bounds it on an H100: the longest segment's serial chain of table
// updates. Its loads are not on that chain: a segment's residuals and
// ranks are contiguous and independent of the table, so the thread loads
// them kPrefetch slots ahead, in registers, while it updates the table.
// K is a template constant (6 or 15, the two shipped configs), so the
// update unrolls with no bounds tests; the k choice and the row minimum
// are compare trees (flcs_common.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "flcs_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrefetch = 8;

template <int K>
__global__ void __launch_bounds__(kThreads)
    flcs_kscan_kernel(const int32_t* __restrict__ residual,
                      const long long* __restrict__ rank,
                      const long long* __restrict__ num_oor,
                      int32_t* __restrict__ k_out, long long total, long long n,
                      int count_scaling) {
  constexpr int KMAX = K <= 8 ? 8 : 16;
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= total) return;
  const long long lane = s / n;
  const long long begin = s - lane * n;
  const long long end = num_oor[lane];
  if (begin >= end || rank[s] != 0) return;
  const long long base = lane * n;

  int32_t table[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) table[k] = 0;

  int32_t v[kPrefetch];
  long long rk[kPrefetch];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const long long i = begin + j;
    v[j] = i < end ? residual[base + i] : 0;
    rk[j] = i < end ? rank[base + i] : 0;
  }
  for (long long pos = begin;; pos += kPrefetch) {
    int32_t vn[kPrefetch];
    long long rn[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const long long i = pos + kPrefetch + j;
      vn[j] = i < end ? residual[base + i] : 0;
      rn[j] = i < end ? rank[base + i] : 0;
    }
    bool done = false;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const long long i = pos + j;
      done = done || i >= end || (i != begin && rk[j] == 0);
      if (!done) {
        k_out[base + i] = flcs::argmin_last(table, K);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K) table[k] += (v[j] >> k) + 1 + k;
        }
        if (count_scaling >= 0 && flcs::min_of(table, K) > count_scaling) {
#pragma unroll
          for (int k = 0; k < KMAX; ++k) table[k] >>= 1;
        }
      }
    }
    if (done) return;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      v[j] = vn[j];
      rk[j] = rn[j];
    }
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream` over G * n > 0 slots, K = 6 or 15; returns
// cudaGetLastError() (0 = ok).
int flcs_kscan(const void* residual, const void* rank, const void* num_oor, void* k_out,
               int G, long long n, int K, int count_scaling, void* stream) {
  const long long total = static_cast<long long>(G) * n;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* res = static_cast<const int32_t*>(residual);
  const auto* rk = static_cast<const long long*>(rank);
  const auto* oor = static_cast<const long long*>(num_oor);
  auto* k = static_cast<int32_t*>(k_out);
  if (K == 6) {
    flcs_kscan_kernel<6><<<blocks, kThreads, 0, s>>>(res, rk, oor, k, total, n, count_scaling);
  } else if (K == 15) {
    flcs_kscan_kernel<15><<<blocks, kThreads, 0, s>>>(res, rk, oor, k, total, n, count_scaling);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
