// Row probe on Hopper: K1's row loop one part at a time.
//
// Replaces tools/probe/row_probe.py::run_padded (its Pallas kernel,
// make_kernel), the TPU probe that split K1's per-row cost.  Each variant
// computes that probe's last row hN from the same inputs (chars (B, nrows),
// seqs (B, l1), int32), and on the card does the work of that part of
// K1's first design (one thread a column, three barriers a row):
//
//   loop    the carried row (h + 1 per row, one column per thread, in a
//           register) and one block barrier per row;
//   store   + the row written to an H plane (B, nrows+1, l1) in device
//           memory, as K1 writes each row;
//   pfx     + that K1's block-wide inclusive max-scan (block_incl_max) of
//           h + 1, floored at NEG as the TPU scan's fill does;
//   chmask  + the per-row node char, a load of chars[b, r] (the TPU probe's
//           O(N) masked sum is a TPU layout idiom; K1 loads the char);
//   row     the full chain row: substitution, diag through the previous row
//           in shared memory, up, the gap-chain scan, the direction byte
//           written to a direction plane (B, nrows, l1) and the H row.
//
// One CTA per window, one thread per column (l1 <= 1024), as K1 runs its
// rows.  What bounds it: the serial chain of block barriers, one per row
// plus two in every scan; the bytes (inputs, hN) and the integer work are
// far below what the card moves and computes in that time.  The design
// keeps K1's layout on purpose: the probe exists to price each of K1's
// per-row parts as K1 pays them.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_dp.cuh"

namespace {

using namespace poa_dp;

enum Variant { kLoop = 0, kStore = 1, kPfx = 2, kChmask = 3, kRow = 4 };
constexpr int kLiveCols = 450;        // row 0: g*j up to column 450, NEG past

// Block-wide inclusive max-scan over threadIdx.x order (blockDim.x is a
// multiple of 32), the scan of K1's first design, with its two barriers.
// Returns the thread's prefix max; *total gets the block max.  The caller
// syncs before the next call reuses warp_tot.
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

template <int V>
__global__ void __launch_bounds__(1024)
row_probe_kernel(const int32_t* __restrict__ chars,   // (B, nrows)
                 const int32_t* __restrict__ seqs,    // (B, l1)
                 int32_t* __restrict__ H,             // (B, nrows+1, l1)
                 int8_t* __restrict__ D,              // (B, nrows, l1)
                 int32_t* __restrict__ out,           // (B, l1)
                 int nrows, int l1) {
  extern __shared__ int smem[];
  int* warp_tot = smem;                 // 32 scan partials
  int* prev = smem + 32;                // the previous row (row variant)
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool live = j < l1;
  const int32_t* chb = chars + (size_t)b * nrows;
  int32_t* Hb = H + (size_t)b * (nrows + 1) * l1;
  int8_t* Db = D + (size_t)b * nrows * l1;
  int h = j <= kLiveCols ? kGap * j : kNeg;
  const int seqj = live ? seqs[(size_t)b * l1 + j] : 0;
  if (V == kRow && live) prev[j] = h;
  __syncthreads();
  for (int i = 1; i <= nrows; ++i) {
    const int r = i - 1;
    if (V == kLoop || V == kStore) {
      h += 1;
    } else {
      int x;
      int diag = kNeg;
      int up = 0;
      if (V == kPfx) {
        x = h + 1;
      } else if (V == kChmask) {
        x = h + chb[r];
      } else {
        const int sub = seqj == chb[r] ? kMatch : kMismatch;
        if (j >= 1 && live) diag = prev[j - 1] + sub;
        up = h + kGap;
        x = (j == 0 ? up : max(diag, up)) - kGap * j;
      }
      int tot;
      const int s = max(block_incl_max(live ? x : kScanId, warp_tot, &tot),
                        kNeg);
      if (V == kRow) {
        h = s + kGap * j;
        if (live) {
          Db[(size_t)r * l1 + j] =
              (int8_t)(h == diag ? 0 : (h == up ? 8 : kDirLeft));
          prev[j] = h;
        }
      } else {
        h = s;
      }
    }
    if (V != kLoop && live) Hb[(size_t)i * l1 + j] = h;
    __syncthreads();
  }
  if (live) out[(size_t)b * l1 + j] = h;
}

template <int V>
int launch(const void* chars, const void* seqs, void* H, void* D, void* out,
           int B, int nrows, int l1, int threads, cudaStream_t s) {
  const size_t smem = (size_t)(32 + l1) * sizeof(int);
  row_probe_kernel<V><<<B, threads, smem, s>>>(
      (const int32_t*)chars, (const int32_t*)seqs, (int32_t*)H, (int8_t*)D,
      (int32_t*)out, nrows, l1);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  variant: 0 loop, 1 store, 2 pfx,
// 3 chmask, 4 row.  H is read by every variant but loop, D by row only
// (pass 0 otherwise).  threads: a multiple of 32, >= l1, <= 1024.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch (-1 for an unknown variant).
extern "C" int row_probe_launch(const void* chars, const void* seqs, void* H,
                                void* D, void* out, int B, int nrows, int l1,
                                int threads, int variant, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kLoop:
      return launch<kLoop>(chars, seqs, H, D, out, B, nrows, l1, threads, s);
    case kStore:
      return launch<kStore>(chars, seqs, H, D, out, B, nrows, l1, threads, s);
    case kPfx:
      return launch<kPfx>(chars, seqs, H, D, out, B, nrows, l1, threads, s);
    case kChmask:
      return launch<kChmask>(chars, seqs, H, D, out, B, nrows, l1, threads,
                             s);
    case kRow:
      return launch<kRow>(chars, seqs, H, D, out, B, nrows, l1, threads, s);
    default:
      return -1;
  }
}
