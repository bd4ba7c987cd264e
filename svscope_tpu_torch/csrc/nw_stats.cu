// K2 on Hopper: batched global-alignment statistics (the MisScore kernel).
//
// Replaces svscope_tpu/ops/nw_pallas.py::_nw_kernel, the TPU kernel of the
// function that svscope_tpu/ops/nw_batch.py::nw_stats_batch computes.  For
// each padded pair (a, b) of true lengths (la, lb) it returns the
// (score, matches, align_len) of the one optimal global alignment (linear
// gap, scoring match / mismatch / gap passed as arguments) that the
// traceback preference diag > up > left picks, without a traceback: each
// cell copies (matches, align_len) from the predecessor it would trace back
// to.  The plain torch version is svscope_tpu_torch/ops/nw_kernel.py::
// nw_stats_reference.
//
// The cell rule.  H(0, j) = gap*j, M(0, j) = 0, A(0, j) = j; for i >= 1:
//   diag = H(i-1, j-1) + (a[i-1] == b[j-1] ? match : mismatch)  (j >= 1)
//   up   = H(i-1, j) + gap
//   left = H(i, j-1) + gap                                       (j >= 1)
//   H    = max(diag, up, left)
//   diag when H == diag, else up when H == up, else left; (M, A) is the
//   chosen predecessor's plus (a[i-1] == b[j-1], 1) for diag, (0, 1) else.
//   Column 0 has only up.
// Why it is the JAX row formulation.  JAX computes row i as
// base[j] = max(diag, up) (base[0] = up), H = cummax(base - gap*j) + gap*j,
// which unrolls to H[j] = max(base[j], H[j-1] + gap) = max(diag, up, left).
// Its flags diag_sel = (H == diag), up_sel = !diag_sel & (H == up) or
// j == 0, and the left-run head gather (M, A) = (M, A)[head] + (0, j-head)
// give every left cell its left neighbour's (M, A + 1), as here.  Cells
// with j > lb (diag masked) and rows i >= la (masked) never feed (la, lb):
// a cell depends only on cells with smaller or equal i and j.  So this
// kernel computes only 0 <= i <= la, 0 <= j <= lb and reads (la, lb).
// tests/test_torch_nw.py holds the plain version to JAX (the Pallas kernel
// in interpret mode and nw_stats_batch) and to the host DP; chip_smoke.py
// holds this kernel to the plain version at every bucket.
//
// Layout: one CTA per pair walks the anti-diagonals d = i + j = 0..la+lb.
// A diagonal's cells depend only on the two diagonals before it, so the
// threads stride over its cells (indexed by i) with no scan.  H, M and A
// of three diagonals ((la+1) ints each, ring slot d % 3) and both
// sequences live in dynamic shared memory: 9*(l_max+1)*4 + 2*l_max bytes,
// 155,684 at l_max = 4096.  One barrier per diagonal.  The TPU kernel's
// lane-rolling prefix scans (8 pairs per grid step, log2(L) roll-and-max
// steps per row) exist only for the TPU's vector layout and are not
// carried over.
//
// What bounds it: the la + lb dependent diagonals, each a barrier plus a
// few shared-memory reads and ~11 integer operations per cell.  Pairs fill
// the SMs; at l_max = 4096 the shared memory allows one CTA per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024)
nw_stats_kernel(const uint8_t* __restrict__ a,       // (B, l_max)
                const uint8_t* __restrict__ b,       // (B, l_max)
                const int32_t* __restrict__ la_in,   // (B,)
                const int32_t* __restrict__ lb_in,   // (B,)
                int32_t* __restrict__ score,         // (B,)
                int32_t* __restrict__ matches,       // (B,)
                int32_t* __restrict__ align_len,     // (B,)
                int l_max, int match, int mismatch, int gap) {
  extern __shared__ int32_t smem[];
  const int l1 = l_max + 1;
  int32_t* H = smem;            // [3][l1]
  int32_t* M = H + 3 * l1;      // [3][l1]
  int32_t* A = M + 3 * l1;      // [3][l1]
  uint8_t* sa = reinterpret_cast<uint8_t*>(A + 3 * l1);
  uint8_t* sb = sa + l_max;
  const int p = blockIdx.x;
  const int la = min(max(la_in[p], 0), l_max);
  const int lb = min(max(lb_in[p], 0), l_max);
  const uint8_t* ap = a + (size_t)p * l_max;
  const uint8_t* bp = b + (size_t)p * l_max;
  for (int k = threadIdx.x; k < la; k += blockDim.x) sa[k] = ap[k];
  for (int k = threadIdx.x; k < lb; k += blockDim.x) sb[k] = bp[k];
  __syncthreads();

  for (int d = 0; d <= la + lb; ++d) {
    const int c0 = (d % 3) * l1;          // diagonal d
    const int c1 = ((d + 2) % 3) * l1;    // diagonal d - 1
    const int c2 = ((d + 1) % 3) * l1;    // diagonal d - 2
    const int ilo = max(0, d - lb);
    const int ihi = min(la, d);
    for (int i = ilo + threadIdx.x; i <= ihi; i += blockDim.x) {
      const int j = d - i;
      int h, m, al;
      if (i == 0) {
        h = gap * j;
        m = 0;
        al = j;
      } else if (j == 0) {                  // column 0: up only
        h = H[c1 + i - 1] + gap;
        m = M[c1 + i - 1];
        al = A[c1 + i - 1] + 1;
      } else {
        const int eq = sa[i - 1] == sb[j - 1];
        const int diag = H[c2 + i - 1] + (eq ? match : mismatch);
        const int up = H[c1 + i - 1] + gap;       // (i-1, j) on d-1
        const int left = H[c1 + i] + gap;         // (i, j-1) on d-1
        h = max(diag, max(up, left));
        if (h == diag) {
          m = M[c2 + i - 1] + eq;
          al = A[c2 + i - 1] + 1;
        } else if (h == up) {
          m = M[c1 + i - 1];
          al = A[c1 + i - 1] + 1;
        } else {
          m = M[c1 + i];
          al = A[c1 + i] + 1;
        }
      }
      H[c0 + i] = h;
      M[c0 + i] = m;
      A[c0 + i] = al;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int c = ((la + lb) % 3) * l1 + la;
    score[p] = H[c];
    matches[p] = M[c];
    align_len[p] = A[c];
  }
}

// Dynamic shared memory of one CTA for pairs padded to l_max.  Past the
// per-block limit (232,448 bytes: l_max > 6,116) the opt-in below fails and
// the launch returns its error, which the wrapper raises.
int smem_bytes(int l_max) {
  return 9 * (l_max + 1) * (int)sizeof(int32_t) + 2 * l_max;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch
// (or of the shared-memory opt-in).
extern "C" int nw_stats_launch(const void* a, const void* b, const void* la,
                               const void* lb, void* score, void* matches,
                               void* align_len, int B, int l_max, int match,
                               int mismatch, int gap, int threads,
                               void* stream) {
  if (B <= 0) return 0;
  const int smem = smem_bytes(l_max);
  cudaError_t err = cudaFuncSetAttribute(
      nw_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  nw_stats_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (const int32_t*)la,
      (const int32_t*)lb, (int32_t*)score, (int32_t*)matches,
      (int32_t*)align_len, l_max, match, mismatch, gap);
  return (int)cudaGetLastError();
}
