// K3 on Hopper: the alignment half of one round of the fused `pk` MSA build.
//
// Replaces svscope_tpu/ops/poa_fused_kernel.py::_align_tb_kernel (called by
// align_tb_call): K1's DP over the rank-space graph that
// ops/poa_fused.py::pk_round_prep re-ranks on the device every round, plus
// the traceback, checked against the plain torch version
// svscope_tpu_torch/ops/poa_fused_kernel.py::align_tb_reference.  It has no
// DP of its own: it instantiates K1's row pass (poa_row.cuh, where the
// recurrence, the design and what bounds it are described) on the pk
// layout, read as it is, in one launch a round:
//
//   * charsr, sinksr (B, N) int32: node chars and sink flags by rank;
//   * predsp (B, N, 8) int32: rank-space preds, empty slots holding slot 0's
//     rank (-1 for a rank with no preds), which the staging skips as it
//     skips K1's -1 slots;
//   * seqv (B, l_max+1) int32: column 0 is a pad (255), base j-1 of the read
//     is column j, so the kernel is handed seqv + 1 with stride l_max+1;
//   * lb, nn_eff (B,): read lengths and the ranks to align (0 for an empty
//     read or an empty graph, whose traceback is all left moves);
//   * an, asx (B, N-1+l_max): one entry shorter than K1's buffer (a path
//     has at most nn_eff + lb <= N-1+l_max entries); ke the last unwritten
//     index; no score.
//
// The TPU kernel's 16-ranks-per-128-lane pred packing and its per-window
// chain-row flags are TPU layout, which the port does not build: the row
// pass finds a chain row by its staged pred row being i-1.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_row.cuh"

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch
// (or of the shared-memory opt-in, or cudaErrorInvalidValue for a launch
// configuration the kernel does not take: threads as K1's launch_threads).
extern "C" int pk_align_launch(const void* charsr, const void* sinksr,
                               const void* predsp, const void* seqv,
                               const void* lb, const void* nn_eff, void* H,
                               void* D, void* an, void* asx, void* ke, int B,
                               int N, int l_max, int threads, void* stream) {
  const poa_row::RowArgs a{
      charsr, predsp, sinksr, nn_eff,
      static_cast<const int32_t*>(seqv) + 1, lb, H, D, an, asx, ke,
      nullptr, nullptr, B, N, l_max + 1, l_max, N - 1 + l_max, threads};
  return poa_row::launch<int32_t, int32_t, poa_dp::kNeg>(a, stream);
}
