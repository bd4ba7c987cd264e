// Row probe on Hopper: K1's row loop one part at a time, each part paid as
// K1's row pass (csrc/poa_row.cuh) pays it.
//
// Replaces tools/probe/row_probe.py::run_padded (its Pallas kernel,
// make_kernel), the TPU probe that split K1's per-row cost.  Each variant
// computes that probe's last row hN from the same inputs (chars (B, nrows),
// seqs (B, l1), int32) and adds one part of K1's chain row (a row whose
// only pred row is the one before) to its parent:
//
//   loop    the carried tile (h + 1 per row, in registers) and one block
//           barrier a row;
//   store   + the row written to an H plane (B, nrows+1, l1) in device
//           memory, as K1 writes each row (row 0 too);
//   pfx     + the scan of h + 1: in-thread over the tile, then
//           poa_dp::block_excl_max_1bar, whose one barrier is now the row's
//           only barrier; floored at NEG as the TPU scan's fill does;
//   chmask  + the row's node char, from the window's chars staged in shared
//           memory once (as K1 stages s_ch), added before the scan;
//   row     the chain row of poa_row.cuh for pred row i-1: the diag from
//           the thread's previous tile and, at its first column, from
//           hleft (the exclusive scan's carry of row i-1), up, the
//           one-barrier scan, the direction byte to a direction plane
//           (B, nrows, l1), H to the plane and to a ring of rows in shared
//           memory.
//
// Layout, as K1's: one CTA per window; thread t owns TILES contiguous
// columns t*TILES ... and keeps their h values and read chars in
// registers; TILES, the thread count and the ring's depth are K1's for
// l_max = l1 - 1 and a graph of nrows ranks (ops/poa_align.launch_tiles,
// launch_threads, ring_rows), and the launch bound is K1's
// (poa_row::max_threads), so the probe follows K1's layout.  What bounds it: the row chain (a barrier a row and the scan's
// shuffles around it), a latency; the bytes (inputs, hN) and the integer
// work are far below what the card moves and computes in that time.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_dp.cuh"
#include "poa_row.cuh"

namespace {

using namespace poa_dp;

enum Variant { kLoop = 0, kStore = 1, kPfx = 2, kChmask = 3, kRow = 4 };
constexpr int kLiveCols = 450;        // row 0: g*j up to column 450, NEG past
using poa_row::max_threads;

__device__ __forceinline__ int row0(int j) {
  return j <= kLiveCols ? kGap * j : kNeg;
}

template <int V, int TILES>
__global__ void __launch_bounds__(max_threads(TILES))
row_probe_kernel(const int32_t* __restrict__ chars,   // (B, nrows)
                 const int32_t* __restrict__ seqs,    // (B, l1)
                 int32_t* __restrict__ H,             // (B, nrows+1, l1)
                 int8_t* __restrict__ D,              // (B, nrows, l1)
                 int32_t* __restrict__ out,           // (B, l1)
                 int nrows, int l1, int ring) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* s_ch = reinterpret_cast<int32_t*>(smem);   // (nrows,)
  int32_t* s_ring = s_ch + nrows;                     // (ring, l1)
  __shared__ int warp_tot[2 * 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int j0 = tid * TILES;
  const int32_t* chb = chars + (size_t)b * nrows;
  int32_t* Hb = H + (size_t)b * (nrows + 1) * l1;
  int8_t* Db = D + (size_t)b * nrows * l1;

  if (V == kChmask || V == kRow) {
    for (int r = tid; r < nrows; r += blockDim.x) s_ch[r] = chb[r];
  }
  int h[TILES], sq[TILES];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int j = j0 + t;
    h[t] = row0(j);
    sq[t] = V == kRow && j < l1 ? seqs[(size_t)b * l1 + j] : 0;
    if (V != kLoop && j < l1) Hb[j] = h[t];
    if (V == kRow && j < l1) s_ring[j] = h[t];
  }
  int hleft = row0(j0 - 1);   // H[i-1][j0-1], read only when j0 >= 1
  __syncthreads();

  for (int i = 1; i <= nrows; ++i) {
    const int r = i - 1;
    if (V == kLoop || V == kStore) {
#pragma unroll
      for (int t = 0; t < TILES; ++t) h[t] += 1;
    } else {
      const int ch = V == kPfx ? 1 : s_ch[r];
      int x[TILES], up[TILES], dg[TILES];
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int j = j0 + t;
        if (V == kRow) {
          up[t] = h[t] + kGap;
          dg[t] = (t == 0 ? hleft : h[t - 1])
              + (sq[t] == ch ? kMatch : kMismatch);
          x[t] = (j == 0 ? up[t] : max(dg[t], up[t])) - kGap * j;
        } else {
          x[t] = h[t] + ch;
        }
        if (j >= l1) x[t] = kScanId;
        if (t > 0) x[t] = max(x[t], x[t - 1]);
      }
      const int excl = block_excl_max_1bar(x[TILES - 1], warp_tot, r & 1);
      if (V == kRow) hleft = max(excl, kNeg) + kGap * (j0 - 1);
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int j = j0 + t;
        const int s = max(max(excl, x[t]), kNeg);
        if (V == kRow) {
          h[t] = s + kGap * j;
          if (j < l1) {
            Db[(size_t)r * l1 + j] = (int8_t)(
                j >= 1 && h[t] == dg[t] ? 0 : (h[t] == up[t] ? 8 : kDirLeft));
            s_ring[(i & (ring - 1)) * l1 + j] = h[t];
          }
        } else {
          h[t] = s;
        }
      }
    }
    if (V != kLoop) {
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        if (j0 + t < l1) Hb[(size_t)i * l1 + j0 + t] = h[t];
      }
    }
    // loop and store: the row's barrier (the scan holds it for the others)
    if (V == kLoop || V == kStore) __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    if (j0 + t < l1) out[(size_t)b * l1 + j0 + t] = h[t];
  }
}

struct Launch {
  const void *chars, *seqs;
  void *H, *D, *out;
  int B, nrows, l1, threads, ring;
};

template <int V, int TILES>
int launch_tiles(const Launch& a, cudaStream_t s) {
  size_t smem = 0;
  if (V == kChmask || V == kRow) smem = (size_t)a.nrows * sizeof(int32_t);
  if (V == kRow) smem += (size_t)a.ring * a.l1 * sizeof(int32_t);
  auto kernel = row_probe_kernel<V, TILES>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.B, a.threads, smem, s>>>(
      (const int32_t*)a.chars, (const int32_t*)a.seqs, (int32_t*)a.H,
      (int8_t*)a.D, (int32_t*)a.out, a.nrows, a.l1, a.ring);
  return (int)cudaGetLastError();
}

template <int V>
int launch(const Launch& a, int tiles, cudaStream_t s) {
  switch (tiles) {
    case 1: return launch_tiles<V, 1>(a, s);
    case 2: return launch_tiles<V, 2>(a, s);
    case 3: return launch_tiles<V, 3>(a, s);
    case 4: return launch_tiles<V, 4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  variant: 0 loop, 1 store, 2 pfx,
// 3 chmask, 4 row.  H is written by every variant but loop, D by row only
// (pass 0 otherwise).  tiles (1-4) columns a thread, threads whole warps
// with tiles * threads >= l1 >= 1 and threads <= max_threads(tiles), and
// ring (row: a power of two, the H rows kept in shared memory; ignored
// otherwise): K1's launch for l_max = l1 - 1 and nrows ranks.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch (-1 for an unknown variant;
// cudaErrorInvalidValue for a launch out of range, or the error of a
// shared-memory size the block cannot have).
extern "C" int row_probe_launch(const void* chars, const void* seqs, void* H,
                                void* D, void* out, int B, int nrows, int l1,
                                int tiles, int threads, int ring, int variant,
                                void* stream) {
  if (B <= 0) return 0;
  if (l1 < 1 || nrows < 0 || tiles < 1 || tiles > 4 || threads <= 0
      || threads % 32 || threads > max_threads(tiles)
      || (long long)tiles * threads < l1
      || (variant == kRow && (ring < 1 || (ring & (ring - 1))))) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch a{chars, seqs, H, D, out, B, nrows, l1, threads, ring};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kLoop: return launch<kLoop>(a, tiles, s);
    case kStore: return launch<kStore>(a, tiles, s);
    case kPfx: return launch<kPfx>(a, tiles, s);
    case kChmask: return launch<kChmask>(a, tiles, s);
    case kRow: return launch<kRow>(a, tiles, s);
    default: return -1;
  }
}
