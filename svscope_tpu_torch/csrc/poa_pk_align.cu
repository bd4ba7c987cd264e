// K3 on Hopper: the alignment half of one round of the fused `pk` MSA build.
//
// Replaces svscope_tpu/ops/poa_fused_kernel.py::_align_tb_kernel (called by
// align_tb_call).  It is K1's DP (poa_align.cu) over the rank-space graph
// that ops/poa_fused.py::pk_round_prep re-ranks on the device every round,
// plus the traceback.  Same scoring and tie-breaks as the TPU kernel, and
// checked against the plain torch version
// svscope_tpu_torch/ops/poa_fused_kernel.py::align_tb_reference:
//
//   * H row 0 is the virtual start row (g*j for j <= lb, NEG past it); row
//     r+1 is rank r.  Rows run up to the window's nn_eff (0 for an empty
//     read or an empty graph).
//   * The pred table is (N, 8) per window with empty slots holding slot 0's
//     rank (-1 for a rank with no preds, which reads the start row).  A
//     rank's predecessor row is the max over its slots' rows.  A chain row
//     (chainw: its only pred is rank r-1, or rank 0 without preds) takes
//     the previous row from shared memory and reads no pred slot.
//   * Directions: 0-7 diag via slot p, 8-15 up via slot p, 16 left; the
//     lowest slot wins and diag wins over up.
//   * Best sink at column lb, strict > in rank order from (NEG, rank 0).
//   * Traceback from (brank+1, lb) — (0, lb) when nn_eff is 0 — written
//     right to left from out_len-1, out_len = N-1+l_max (not K1's N+l_max):
//     an = rank or -1 (gap), as = seq position or -1, pad -2; ke = the
//     last unwritten index.  Row 0 (iv == 0) reads as a left move.
//
// Layout: one CTA per window, threads stride over the l_max+1 columns.  The
// H plane ((N+1) x (l_max+1) int32) and the direction plane (N x (l_max+1)
// int8) live in device memory: at the heavy bucket (N=3073, l_max=512)
// they are 7.9 MB per window.  Shared memory holds the previous row, the
// predecessor max row and the read.  The TPU kernel's 16-ranks-per-128-lane
// pred packing and its 8-window chain flag are TPU layout and are gone.
//
// What bounds it: as K1, the serial row loop's latency (a few block
// barriers per row; branch rows read their pred rows from L2) and the
// single-thread traceback of <= N-1+l_max dependent reads.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_dp.cuh"

namespace {

using namespace poa_dp;

__global__ void __launch_bounds__(1024)
pk_align_kernel(const int32_t* __restrict__ charsr,    // (B, N)
                const int32_t* __restrict__ sinksr,    // (B, N) 0/1
                const int32_t* __restrict__ predsp,    // (B, N, 8)
                const int32_t* __restrict__ chainw,    // (B, N) 0/1
                const int32_t* __restrict__ seqv,      // (B, l1), col 0 = 255
                const int32_t* __restrict__ lb_all,    // (B,)
                const int32_t* __restrict__ nn_all,    // (B,)
                int32_t* __restrict__ H,               // (B, N+1, l1)
                int8_t* __restrict__ D,                // (B, N, l1)
                int32_t* __restrict__ an,              // (B, out_len)
                int32_t* __restrict__ asx,             // (B, out_len)
                int32_t* __restrict__ ke,              // (B,)
                int N, int l_max) {
  extern __shared__ int smem[];
  const int l1 = l_max + 1;
  int* prev = smem;              // row i-1, then row i once computed
  int* mp = smem + l1;           // predecessor max row
  int* seq = smem + 2 * l1;      // seqv row: column j holds base j-1
  int* warp_tot = smem + 3 * l1; // 32 scan partials
  __shared__ int s_rows[kMaxPreds];
  __shared__ int s_slot[kMaxPreds];
  __shared__ int s_np;
  __shared__ int s_best[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int nn = nn_all[b];
  const int lb = lb_all[b];
  const int32_t* chb = charsr + (size_t)b * N;
  const int32_t* skb = sinksr + (size_t)b * N;
  const int32_t* cwb = chainw + (size_t)b * N;
  const int32_t* pb = predsp + (size_t)b * N * kMaxPreds;
  const int32_t* sqb = seqv + (size_t)b * l1;
  int32_t* Hb = H + (size_t)b * (N + 1) * l1;
  int8_t* Db = D + (size_t)b * N * l1;

  for (int j = tid; j < l1; j += T) {
    const int v = j <= lb ? kGap * j : kNeg;
    prev[j] = v;
    Hb[j] = v;
    seq[j] = sqb[j];
  }
  __syncthreads();
  // best sink: only the thread owning column lb ever updates these
  int bval = kNeg;
  int brank = 0;

  for (int r = 0; r < nn; ++r) {
    const int i = r + 1;
    if (tid == 0) {
      if (cwb[r]) {
        s_rows[0] = i - 1;
        s_slot[0] = 0;
        s_np = 1;
      } else {
        // distinct predecessor rows in slot order; slots equal to slot 0
        // are its padding copies (slot 0 wins their ties), so skip them
        const int s0 = pb[r * kMaxPreds];
        int np = 0;
        s_rows[np] = max(s0, -1) + 1;
        s_slot[np] = 0;
        ++np;
        for (int p = 1; p < kMaxPreds; ++p) {
          const int q = pb[r * kMaxPreds + p];
          if (q >= 0 && q != s0) {
            s_rows[np] = q + 1;
            s_slot[np] = p;
            ++np;
          }
        }
        s_np = np;
      }
    }
    __syncthreads();
    const int np = s_np;
    const int ch = chb[r];

    // predecessor max row (row i-1 comes from shared memory)
    for (int j = tid; j < l1; j += T) {
      int m = kScanId;
      for (int s = 0; s < np; ++s) {
        const int row = s_rows[s];
        const int v = row == i - 1 ? prev[j] : Hb[(size_t)row * l1 + j];
        m = max(m, v);
      }
      mp[j] = m;
    }
    __syncthreads();

    // row values + in-row gap chain, one tile of T columns at a time
    int carry = kScanId;
    for (int t0 = 0; t0 < l1; t0 += T) {
      const int j = t0 + tid;
      int x = kScanId;
      if (j < l1) {
        const int up = mp[j] + kGap;
        int base = up;
        if (j > 0) {
          const int diag = j <= lb
              ? mp[j - 1] + (seq[j] == ch ? kMatch : kMismatch) : kNeg;
          base = max(diag, up);
        }
        if (j > lb) base = kNeg;
        x = base - kGap * j;
      }
      int tot;
      int s = block_incl_max(x, warp_tot, &tot);
      s = max(s, carry);
      carry = max(carry, tot);
      if (j < l1) {
        const int h = s + kGap * j;
        prev[j] = h;
        Hb[(size_t)i * l1 + j] = h;
      }
      __syncthreads();
    }

    // directions against the finished row, and the best-sink update
    for (int j = tid; j < l1; j += T) {
      const int h = prev[j];
      const bool jv = j >= 1 && j <= lb;
      const int sub = jv ? (seq[j] == ch ? kMatch : kMismatch) : 0;
      int dd = -1;
      int du = -1;
      if (np == 1) {
        if (jv && h == mp[j - 1] + sub) {
          dd = 0;
        } else if (h == mp[j] + kGap) {
          du = 0;
        }
      } else {
        for (int s = 0; s < np; ++s) {
          const int32_t* Hr = Hb + (size_t)s_rows[s] * l1;
          if (dd < 0 && jv && h == Hr[j - 1] + sub) dd = s_slot[s];
          if (du < 0 && h == Hr[j] + kGap) du = s_slot[s];
        }
      }
      const int code = dd >= 0 ? dd : (du >= 0 ? 8 + du : kDirLeft);
      Db[(size_t)r * l1 + j] = (int8_t)code;
      if (j == lb && skb[r] > 0 && h > bval) {
        bval = h;
        brank = r;
      }
    }
    __syncthreads();
  }

  const int out_len = N - 1 + l_max;
  int32_t* anb = an + (size_t)b * out_len;
  int32_t* asb = asx + (size_t)b * out_len;
  for (int k = tid; k < out_len; k += T) {
    anb[k] = -2;
    asb[k] = -2;
  }
  if (tid == lb % T) {
    s_best[0] = bval;
    s_best[1] = brank;
  }
  __syncthreads();
  if (tid == 0) {
    int iv = nn > 0 ? s_best[1] + 1 : 0;
    int jv = lb;
    int kv = out_len - 1;
    while (jv > 0 && kv >= 0) {
      const int rr = max(iv - 1, 0);
      const int code = iv == 0 ? kDirLeft : (int)Db[(size_t)rr * l1 + jv];
      const bool left = code == kDirLeft;
      const bool up = code >= 8 && !left;
      const int p = left ? 0 : (code & 7);
      const int pr = pb[rr * kMaxPreds + p];
      anb[kv] = left ? -1 : iv - 1;
      asb[kv] = up ? -1 : jv - 1;
      if (!left) iv = pr + 1;
      if (!up) jv -= 1;
      kv -= 1;
    }
    ke[b] = kv;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int pk_align_launch(const void* charsr, const void* sinksr,
                               const void* predsp, const void* chainw,
                               const void* seqv, const void* lb,
                               const void* nn_eff, void* H, void* D,
                               void* an, void* asx, void* ke, int B, int N,
                               int l_max, int threads, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)(3 * (l_max + 1) + 32) * sizeof(int);
  pk_align_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)charsr, (const int32_t*)sinksr,
      (const int32_t*)predsp, (const int32_t*)chainw, (const int32_t*)seqv,
      (const int32_t*)lb, (const int32_t*)nn_eff, (int32_t*)H, (int8_t*)D,
      (int32_t*)an, (int32_t*)asx, (int32_t*)ke, N, l_max);
  return (int)cudaGetLastError();
}
