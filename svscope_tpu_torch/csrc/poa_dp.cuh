// Shared by the two POA DP kernels, K1 (poa_align.cu) and K3
// (poa_pk_align.cu): the scoring constants, the direction codes and the
// block-wide max-scan that carries the in-row gap chain.
#pragma once

#include <cstdint>

namespace poa_dp {

constexpr int kMatch = 5;
constexpr int kMismatch = -4;
constexpr int kGap = -8;
constexpr int kNeg = -(1 << 29);
constexpr int kScanId = -(1 << 30);   // below every scanned value
constexpr int kMaxPreds = 8;
constexpr int kDirLeft = 16;          // 0-7 diag via slot p, 8-15 up via p

__device__ __forceinline__ int warp_incl_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, t);
  }
  return v;
}

// Block-wide inclusive max-scan over threadIdx.x order (blockDim.x is a
// multiple of 32).  Returns the thread's prefix max; *total gets the block
// max.  The caller syncs before the next call reuses warp_tot.
__device__ __forceinline__ int block_incl_max(int v, int* warp_tot,
                                              int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_incl_max(v, lane);
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? warp_tot[lane] : kScanId;
    t = warp_incl_max(t, lane);
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v = max(v, warp_tot[wid - 1]);
  *total = warp_tot[nw - 1];
  return v;
}

// Block-wide exclusive max-scan with one barrier, for a loop that scans
// once per iteration: `warp_tot` holds 2 x 32 ints and `parity` alternates
// between consecutive calls, so a call's writes never meet the previous
// call's reads (a barrier lies between them).  Every warp reduces the
// totals of the warps before it itself (redux.sync), so no second barrier
// is needed.  blockDim.x is a multiple of 32.  Returns the max over the
// threads before this one (kScanId for thread 0).
__device__ __forceinline__ int block_excl_max_1bar(int v, int* warp_tot,
                                                   int parity) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int* wt = warp_tot + 32 * parity;
  v = warp_incl_max(v, lane);
  int excl = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) excl = kScanId;
  if (lane == 31) wt[wid] = v;
  __syncthreads();
  const int pre = __reduce_max_sync(0xffffffffu,
                                    lane < wid ? wt[lane] : kScanId);
  return max(excl, pre);
}

}  // namespace poa_dp
