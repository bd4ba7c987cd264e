// Shared by the POA row pass (poa_row.cuh: K1 and K3) and the row probe
// (probe_row.cu): the scoring constants, the direction codes and the
// warp and block max-scans that carry the in-row gap chain.
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
