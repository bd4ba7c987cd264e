// K1 on Hopper: batched POA graph-vs-read global alignment.
//
// Replaces svscope_tpu/ops/poa_pallas.py::_poa_kernel (the TPU kernel the
// localGraph engine runs for both POA steps of every chunk), checked
// against the plain torch version in
// svscope_tpu_torch/ops/poa_device.py::align_batch_reference.  The kernel
// is the row pass of poa_row.cuh (its recurrence, tie-breaks, design and
// what bounds it are described there), on K1's layout: uint8 chars, sinks
// and reads of stride L, -1 in an empty pred slot, an alignment buffer of
// N + l_max entries and the score.
//
// K1-int16 (poa_align16_launch) replaces the same TPU kernel's int16 variant
// (svscope_tpu/ops/poa_pallas.py:54-60, :329-331, int16_mode): the H plane
// in int16_t with the sentinel NEG16 = -20000; the arithmetic and the
// max-scan stay in int32 registers.  The caller gates N, l_max <= 1024:
// every legal H value is then >= -8 * (N + l_max) >= -16384 > NEG16, so the
// outputs equal the int32 kernel's except the score of a window with no
// valid sink, which is NEG16.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_row.cuh"

namespace {

using poa_row::RowArgs;

constexpr int kNeg16 = -20000;         // K1-int16's sentinel

RowArgs k1_args(const void* chars, const void* preds, const void* sinks,
                const void* n_nodes, const void* seqs, const void* seq_lens,
                void* H, void* D, void* an, void* asp, void* k_end,
                void* score, int B, int N, int L, int l_max, int threads,
                long long* split) {
  return RowArgs{chars, preds, sinks, n_nodes, seqs, seq_lens, H, D, an,
                 asp, k_end, score, split, B, N, L, l_max, N + l_max,
                 threads};
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError() of the
// launch (or of the shared-memory opt-in, or cudaErrorInvalidValue for a
// launch configuration the kernel does not take).  poa_align_launch: H
// int32, sentinel NEG; poa_align16_launch: H int16, sentinel NEG16 (the
// caller keeps N, l_max <= 1024).
extern "C" int poa_align_launch(const void* chars, const void* preds,
                                const void* sinks, const void* n_nodes,
                                const void* seqs, const void* seq_lens,
                                void* H, void* D, void* an, void* asp,
                                void* k_end, void* score, int B, int N,
                                int L, int l_max, int threads, void* stream) {
  return poa_row::launch<uint8_t, int32_t, poa_dp::kNeg>(
      k1_args(chars, preds, sinks, n_nodes, seqs, seq_lens, H, D, an, asp,
              k_end, score, B, N, L, l_max, threads, nullptr),
      stream);
}

extern "C" int poa_align16_launch(const void* chars, const void* preds,
                                  const void* sinks, const void* n_nodes,
                                  const void* seqs, const void* seq_lens,
                                  void* H, void* D, void* an, void* asp,
                                  void* k_end, void* score, int B, int N,
                                  int L, int l_max, int threads,
                                  void* stream) {
  return poa_row::launch<uint8_t, int16_t, kNeg16>(
      k1_args(chars, preds, sinks, n_nodes, seqs, seq_lens, H, D, an, asp,
              k_end, score, B, N, L, l_max, threads, nullptr),
      stream);
}

#ifdef POA_ALIGN_SPLIT
// K1 (int32) with the clock64() split written to `split` (B, kSplitParts).
extern "C" int poa_align_split_launch(const void* chars, const void* preds,
                                      const void* sinks, const void* n_nodes,
                                      const void* seqs, const void* seq_lens,
                                      void* H, void* D, void* an, void* asp,
                                      void* k_end, void* score, int B, int N,
                                      int L, int l_max, int threads,
                                      void* stream, void* split) {
  return poa_row::launch<uint8_t, int32_t, poa_dp::kNeg>(
      k1_args(chars, preds, sinks, n_nodes, seqs, seq_lens, H, D, an, asp,
              k_end, score, B, N, L, l_max, threads, (long long*)split),
      stream);
}
#endif
