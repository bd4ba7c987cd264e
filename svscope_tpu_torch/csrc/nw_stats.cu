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
// Layout: a warp per pair (a CTA of one warp; several CTAs share an SM),
// no block barrier.  The rows of `a` are cut into bands of 32 x R rows; in
// a band lane l holds rows 32R*band + l*R + 1 ... + R, their chars and
// their H and (M, A) at its current column in registers, and the warp
// sweeps the columns of `b` as a wavefront: at step s lane l computes
// column j = s - l, top to bottom, with the row above its first row at
// column j taken from lane l-1 (which computed it at step s-1) by
// __shfl_up_sync, together with b[j-1].  Lane 0 takes the band's top
// boundary row from row 0's closed form (band 0) or from the previous
// band's bottom row, which lane 31 wrote to a scratch buffer in device
// memory, (H, M << 16 | A) per column, served by L2; lane 0's boundary
// values and b chars are loaded 32 columns ahead, one column a lane, and
// handed to lane 0 by a shuffle.  A band costs lb + 32 steps; the R rows
// of a lane share each step's shuffles.  max(diag, up, left) is the DPX
// __vimax3_s32; the choice of (M, A) stays the two compares in
// diag > up > left order.  H is int32; M and A share one int32 as
// M << 16 | A (a diag adds 1 << 16 | 1, up and left add 1), exact while
// A <= la + lb < 65536: the kernel takes l_max <= 32767 (kMaxLen), and the
// wrapper raises past it.
//
// Launch configuration (ops/nw_kernel.py::launch_config): R = 4, 8, 16
// rows a lane by l_max (a band of 128, 256 or 512 rows: the 128-512
// buckets in one band); the scratch buffer only where a pair can have two
// bands; and, from the 1024 bucket on, the pairs taken longest first
// (`order`, la * lb descending): those buckets run several waves of warps,
// and a long pair started last would hold the card alone.  No shared
// memory: an SM holds as many pairs as its registers allow.
//
// What bounds it: the cells' integer operations (~12 a cell) once a few
// warps share each SM sub-partition; for a short bucket, one pair's
// lb + 32 dependent steps, each R rows long.

#include <cstdint>
#include <cuda_runtime.h>

// A named namespace, not an anonymous one: a profiler's trace names a
// kernel by its demangled name, which would begin "(anonymous
// namespace)::" and so read as no name where the name is cut at its first
// parenthesis.
namespace nw_stats {

constexpr unsigned kFull = 0xffffffffu;
// (M, A) of a cell packed in one int: M << 16 | A.  Exact while
// A <= la + lb < 65536, so l_max is at most kMaxLen (the wrapper's gate).
constexpr int kMatchOne = 1 << 16;
constexpr int kMaxLen = 32767;

template <int R>
__global__ void __launch_bounds__(32)
nw_stats_kernel(const uint8_t* __restrict__ a,       // (B, l_max)
                const uint8_t* __restrict__ b,       // (B, l_max)
                const int32_t* __restrict__ la_in,   // (B,)
                const int32_t* __restrict__ lb_in,   // (B,)
                int32_t* __restrict__ score,         // (B,)
                int32_t* __restrict__ matches,       // (B,)
                int32_t* __restrict__ align_len,     // (B,)
                int2* __restrict__ bnd,              // (B, l_max+1) or null
                const int32_t* __restrict__ order,   // (B,) or null
                int l_max, int match, int mismatch, int gap) {
  constexpr int kBand = 32 * R;
  const int lane = threadIdx.x;
  const int p = order != nullptr ? order[blockIdx.x] : blockIdx.x;
  const int la = min(max(la_in[p], 0), l_max);
  const int lb = min(max(lb_in[p], 0), l_max);
  const uint8_t* ap = a + (size_t)p * l_max;
  const uint8_t* bp = b + (size_t)p * l_max;
  int2* bd = bnd + (size_t)p * (l_max + 1);
  const int nbands = (la + kBand - 1) / kBand;
  // the cell (la, lb): row 0's when la == 0, else lane lr's row rr of the
  // last band
  int rh = gap * lb, rma = lb;
  const int lr = la > 0 ? ((la - 1) % kBand) / R : 0;
  const int rr = la > 0 ? (la - 1) % R : 0;

  for (int band = 0; band < nbands; ++band) {
    const int top = band * kBand;          // the boundary row
    const bool last = band == nbands - 1;
    const int i0 = top + lane * R + 1;     // this lane's first row
    int ca[R], h[R], ma[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ca[r] = i0 + r <= la ? (int)ap[i0 + r - 1] : -1;
      h[r] = 0;
      ma[r] = 0;
    }
    // lane 0's inputs 32 columns ahead: column c = chunk start + lane
    auto fetch = [&](int c, int2& v, int& ch) {
      v = band > 0 && c <= lb ? bd[c] : make_int2(0, 0);
      ch = c >= 1 && c <= lb ? (int)bp[c - 1] : 0;
    };
    int2 nxt_v, cur_v;
    int nxt_c, cur_c;
    fetch(lane, nxt_v, nxt_c);
    int ph = 0, pma = 0;                   // row above, column j - 1
    int oh = 0, oma = 0, oc = 0;           // last row and b char, column j
    for (int s = 0; s <= lb + 31; ++s) {
      if ((s & 31) == 0) {
        cur_v = nxt_v;
        cur_c = nxt_c;
        fetch(s + 32 + lane, nxt_v, nxt_c);
      }
      const int j = s - lane;
      int th = __shfl_up_sync(kFull, oh, 1);
      int tma = __shfl_up_sync(kFull, oma, 1);
      int tc = __shfl_up_sync(kFull, oc, 1);
      const int src = s & 31;
      const int bh = __shfl_sync(kFull, cur_v.x, src);
      const int bma = __shfl_sync(kFull, cur_v.y, src);
      const int bc = __shfl_sync(kFull, cur_c, src);
      if (lane == 0) {
        th = band > 0 ? bh : gap * s;
        tma = band > 0 ? bma : s;
        tc = bc;
      }
      if (j == 0) {                        // column 0: up only
#pragma unroll
        for (int r = 0; r < R; ++r) {
          h[r] = gap * (i0 + r);
          ma[r] = i0 + r;
        }
      } else if (j > 0 && j <= lb) {
        int dh = ph, dma = pma;            // diag source of the first row
        int uh = th, uma = tma;            // up source of the first row
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool eq = ca[r] == tc;
          const int diag = dh + (eq ? match : mismatch);
          const int up = uh + gap;
          const int hv = __vimax3_s32(diag, up, h[r] + gap);
          const int from = hv == diag ? dma + (eq ? kMatchOne : 0)
                                      : (hv == up ? uma : ma[r]);
          dh = h[r];
          dma = ma[r];
          h[r] = hv;
          ma[r] = from + 1;
          uh = hv;
          uma = from + 1;
        }
      }
      ph = th;
      pma = tma;
      oh = h[R - 1];
      oma = ma[R - 1];
      oc = tc;
      if (j >= 0 && j <= lb) {
        if (!last && lane == 31) bd[j] = make_int2(oh, oma);
        if (last && lane == lr && j == lb) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r == rr) {
              rh = h[r];
              rma = ma[r];
            }
          }
        }
      }
    }
    __syncwarp();                          // the boundary row, lane 31 -> 0
  }
  if (nbands > 0) {
    rh = __shfl_sync(kFull, rh, lr);
    rma = __shfl_sync(kFull, rma, lr);
  }
  if (lane == 0) {
    score[p] = rh;
    matches[p] = rma >> 16;
    align_len[p] = rma & 0xffff;
  }
}

template <int R>
int launch_rows(const void* a, const void* b, const void* la, const void* lb,
                void* score, void* matches, void* align_len, void* scratch,
                const void* order, int B, int l_max, int match, int mismatch,
                int gap, cudaStream_t stream) {
  nw_stats_kernel<R><<<B, 32, 0, stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (const int32_t*)la,
      (const int32_t*)lb, (int32_t*)score, (int32_t*)matches,
      (int32_t*)align_len, (int2*)scratch, (const int32_t*)order, l_max,
      match, mismatch, gap);
  return (int)cudaGetLastError();
}

}  // namespace nw_stats

using namespace nw_stats;

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue for what the kernel does not take: l_max past
// kMaxLen, rows a lane other than 4, 8 or 16, or no scratch buffer of
// (B, l_max+1) int2 where l_max > 32 * rows.  `order` (B,) int32, a
// permutation of the pairs to take in that order, or null.
extern "C" int nw_stats_launch(const void* a, const void* b, const void* la,
                               const void* lb, void* score, void* matches,
                               void* align_len, void* scratch,
                               const void* order, int B, int l_max,
                               int match, int mismatch, int gap, int rows,
                               void* stream) {
  if (B <= 0) return 0;
  if (l_max > kMaxLen || (l_max > 32 * rows && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 4:
      return launch_rows<4>(a, b, la, lb, score, matches, align_len, scratch,
                            order, B, l_max, match, mismatch, gap, s);
    case 8:
      return launch_rows<8>(a, b, la, lb, score, matches, align_len, scratch,
                            order, B, l_max, match, mismatch, gap, s);
    case 16:
      return launch_rows<16>(a, b, la, lb, score, matches, align_len,
                             scratch, order, B, l_max, match, mismatch, gap,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
