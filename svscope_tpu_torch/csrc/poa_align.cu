// K1 on Hopper: batched POA graph-vs-read global alignment.
//
// Replaces svscope_tpu/ops/poa_pallas.py::_poa_kernel (the TPU kernel the
// localGraph engine runs for both POA steps of every chunk).  Same
// recurrence, scoring and tie-breaks, checked against the plain torch
// version in svscope_tpu_torch/ops/poa_device.py::align_batch_reference:
//
//   * NW in topological-rank space, m=5 n=-4 g=-8.  H row 0 is the virtual
//     start row (g*j for j <= seq_len, NEG past it); row r+1 is node rank r.
//   * A rank's predecessor row is the max over its pred slots' rows.  Empty
//     slots count as copies of slot 0, a rank with no preds reads row 0.
//   * base[j] = max(mp[j-1] + sub, mp[j] + g) for 1 <= j <= seq_len,
//     mp[0] + g at j = 0, NEG past seq_len; the in-row gap chain
//     H[j] = max(base[j], H[j-1] + g) is a block-wide inclusive max-scan of
//     base[j] - g*j (warp shuffles plus one shared-memory pass), + g*j.
//   * Direction byte per cell: lowest diag slot (0-7), else lowest up slot
//     (8-15), else left (16).
//   * Best sink at column seq_len, strict > in rank order from (NEG, 0);
//     traceback from (brank+1, seq_len, out_len-1) until j == 0 or k < 0.
//
// Layout: one CTA per window; threads stride over the L+1 columns; rows run
// up to the window's own n_nodes.  The H plane ((N+1) x (L+1) int32) and
// the direction plane (N x (L+1) int8) live in device memory, not shared
// memory: at B=256, N=1024, L=512 they are ~538 MB and ~135 MB, at the
// largest bucket (B=256, N=L=2048) ~4.3 GB and ~1.1 GB.  Shared memory
// holds the previous row and the predecessor max row.
//
// What bounds it: the serial row loop's latency.  Each row is a handful of
// block barriers plus, for branch rows, predecessor-row reads that come
// from L2 (chain rows reuse the previous row kept in shared memory).  The
// traceback is one thread's dependent walk of <= N + L direction reads.
// The windows of a batch fill the SMs; nothing else is parallel.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_dp.cuh"

namespace {

using namespace poa_dp;

__global__ void __launch_bounds__(1024)
poa_align_kernel(const uint8_t* __restrict__ chars,     // (B, N)
                 const int32_t* __restrict__ preds,     // (B, N, 8), -1 empty
                 const uint8_t* __restrict__ sinks,     // (B, N) 0/1
                 const int32_t* __restrict__ n_nodes,   // (B,)
                 const uint8_t* __restrict__ seqs,      // (B, L)
                 const int32_t* __restrict__ seq_lens,  // (B,)
                 int32_t* __restrict__ H,               // (B, N+1, l1)
                 int8_t* __restrict__ D,                // (B, N, l1)
                 int32_t* __restrict__ an,              // (B, out_len)
                 int32_t* __restrict__ asp,             // (B, out_len)
                 int32_t* __restrict__ k_end,           // (B,)
                 int32_t* __restrict__ score,           // (B,)
                 int N, int L, int l_max) {
  extern __shared__ int smem[];
  const int l1 = l_max + 1;
  int* prev = smem;              // row i-1, then row i once computed
  int* mp = smem + l1;           // predecessor max row
  int* warp_tot = smem + 2 * l1; // 32 scan partials
  __shared__ int s_rows[kMaxPreds];
  __shared__ int s_slot[kMaxPreds];
  __shared__ int s_np;
  __shared__ int s_best[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int nn = n_nodes[b];
  const int lb = seq_lens[b];
  const uint8_t* seq = seqs + (size_t)b * L;
  const uint8_t* chb = chars + (size_t)b * N;
  const uint8_t* skb = sinks + (size_t)b * N;
  const int32_t* pb = preds + (size_t)b * N * kMaxPreds;
  int32_t* Hb = H + (size_t)b * (N + 1) * l1;
  int8_t* Db = D + (size_t)b * N * l1;

  for (int j = tid; j < l1; j += T) {
    const int v = j <= lb ? kGap * j : kNeg;
    prev[j] = v;
    Hb[j] = v;
  }
  // best sink: only the thread owning column lb ever updates these
  int bval = kNeg;
  int brank = 0;

  for (int r = 0; r < nn; ++r) {
    const int i = r + 1;
    if (tid == 0) {
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
              ? mp[j - 1] + (seq[j - 1] == ch ? kMatch : kMismatch) : kNeg;
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
      const int sub = jv ? (seq[j - 1] == ch ? kMatch : kMismatch) : 0;
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
      if (j == lb && skb[r] && h > bval) {
        bval = h;
        brank = r;
      }
    }
    __syncthreads();
  }

  const int out_len = N + l_max;
  int32_t* anb = an + (size_t)b * out_len;
  int32_t* asb = asp + (size_t)b * out_len;
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
    int iv = s_best[1] + 1;
    int jv = lb;
    int kv = out_len - 1;
    while (jv > 0 && kv >= 0) {
      const int rr = max(iv - 1, 0);
      const int code = (iv == 0 || rr >= nn) ? kDirLeft
                                             : (int)Db[(size_t)rr * l1 + jv];
      const bool left = code == kDirLeft;
      const bool up = code >= 8 && !left;
      const int p = left ? 0 : (code & 7);
      int pr = pb[rr * kMaxPreds + p];
      if (pr < 0) pr = pb[rr * kMaxPreds];
      anb[kv] = left ? -1 : iv - 1;
      asb[kv] = up ? -1 : jv - 1;
      if (!left) iv = pr + 1;
      if (!up) jv -= 1;
      kv -= 1;
    }
    k_end[b] = kv;
    score[b] = s_best[0];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int poa_align_launch(const void* chars, const void* preds,
                                const void* sinks, const void* n_nodes,
                                const void* seqs, const void* seq_lens,
                                void* H, void* D, void* an, void* asp,
                                void* k_end, void* score, int B, int N,
                                int L, int l_max, int threads, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = (size_t)(2 * (l_max + 1) + 32) * sizeof(int);
  poa_align_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int32_t*)preds, (const uint8_t*)sinks,
      (const int32_t*)n_nodes, (const uint8_t*)seqs,
      (const int32_t*)seq_lens, (int32_t*)H, (int8_t*)D, (int32_t*)an,
      (int32_t*)asp, (int32_t*)k_end, (int32_t*)score, N, L, l_max);
  return (int)cudaGetLastError();
}
