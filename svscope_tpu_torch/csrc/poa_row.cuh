// The POA row pass on Hopper, shared by K1 (poa_align.cu) and K3
// (poa_pk_align.cu): one read aligned to each window's graph in rank space,
// with traceback.  Same recurrence, scoring and tie-breaks as the TPU
// kernels, checked against the plain torch versions
// (ops/poa_device.py::align_batch_reference; K3's align_tb_reference is
// that function on K3's layout):
//
//   * NW in topological-rank space, m=5 n=-4 g=-8.  H row 0 is the virtual
//     start row (g*j for j <= seq_len); row r+1 is node rank r.
//   * A rank's predecessor row is the max over its pred slots' rows.  Empty
//     slots count as copies of slot 0, a rank with no preds reads row 0.
//   * base[j] = max(mp[j-1] + sub, mp[j] + g) for 1 <= j <= seq_len,
//     mp[0] + g at j = 0; the in-row gap chain H[j] = max(base[j], H[j-1] + g)
//     is a block-wide inclusive max-scan of base[j] - g*j, + g*j.
//   * Direction byte per cell: lowest diag slot (0-7), else lowest up slot
//     (8-15), else left (16).
//   * Best sink at column seq_len, strict > in rank order from (Neg, 0);
//     traceback from (brank+1, seq_len, out_len-1) until j == 0 or k < 0.
//
// What bounds it: one window's serial row chain, a latency, not a
// throughput (at B <= 132 a launch is one wave of one CTA per window).  So
// the design cuts what each row waits for (measured part by part with
// tools/k1_split.py, PERF.md section 5):
//
//   * The window's topology is staged in shared memory once, by all
//     threads: per rank its distinct pred rows in slot order with their
//     slots (uint16 row | slot << 13; slots equal to slot 0 are its padding
//     copies and are skipped, slot 0 winning their ties), the pred row of
//     each of its 8 slots (for the traceback), its node char and sink
//     flag: N x 35 bytes, 71,680 at N = 2048.
//   * Thread t owns TILES contiguous columns t*TILES ... and keeps their
//     read chars and the previous row's H values in registers.  A chain
//     row (pred row i-1) reads nothing: its own columns are in registers,
//     and column t*TILES - 1 of row i-1 is the exclusive prefix max the
//     thread got from row i-1's scan (+ g*j).  The last `ring` rows (16,
//     fewer where they do not fit) are also kept in a ring in shared
//     memory, so a pred row a few ranks back (a bubble's other branch) is
//     a shared-memory read; older pred rows come from the H plane in device
//     memory (L2).  Each thread reads its own columns, the left neighbour
//     column comes by a warp shuffle.
//   * One pass per row: while forming the pred max per column the thread
//     keeps the lowest slot reaching it.  A cell is diag only if h equals
//     max-over-slots(H[j-1]) + sub, and then the lowest slot reaching that
//     max is its slot; the same for up.  So the direction byte is written
//     with H, and no pred row is read twice.
//   * One block barrier per row: a thread's TILES columns are scanned in
//     registers, warps by shuffles, and each warp reduces the totals of the
//     warps before it itself (poa_dp::block_excl_max_1bar, the warp totals
//     double-buffered by row parity).
//   * Columns past seq_len are neither computed nor stored (no cell <=
//     seq_len depends on them).
//   * The traceback is one warp: it stages a 32 x 32 tile of the direction
//     plane (rows i-1 ... i-32, columns j-31 ... j) with 32 independent
//     loads, then lane 0 walks the tile from shared memory until the path
//     leaves it, taking a pred's row from the staged per-slot table.  Two
//     dependent device-memory reads per step become one per ~32 steps.
//
// The H plane ((N+1) x (l_max+1)) and the direction plane (N x (l_max+1)
// int8) stay in device memory: at N = 1024, l_max = 512 one window's int32
// plane is ~2 MB, more than an SM holds.  Launch configuration
// (ops/poa_align.py::launch_threads): TILES columns a thread, 1-4, and the
// fewest whole warps that cover l_max+1 columns.  A row costs each thread a
// fixed share (the entry loop, the scan, the barrier) plus a little per
// column, so about 300 threads (TILES = 2 at l_max = 512, 3 at 1024 and
// 2048) beat one thread a column.
//
// The kernel is templated on
//   * In, the input layout's element type: uint8_t for K1's (chars, sinks
//     and reads as bytes), int32_t for K3's (the same values as int32;
//     a char or base is taken mod 256, a sink is a value > 0, as the plain
//     versions convert them).  The pred table is (N, 8) int32 in both, read
//     as two 16-byte words a rank: K1's holds -1 in an empty slot, K3's a
//     copy of slot 0, and the staging treats both alike.  The read of
//     window b is seqs[b * seq_stride + j - 1] (K3 passes its seqv one
//     column on, past the pad column);
//   * HT and Neg, the H plane's storage type and sentinel (K1-int16: int16_t
//     and -20000; the arithmetic stays in int32 registers);
//   * TILES, the columns a thread owns.
// The alignment buffer is out_len wide (K1 N + l_max, K3 N - 1 + l_max);
// the score is written only where `score` is not null (K1).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_dp.cuh"

namespace poa_row {

using namespace poa_dp;

constexpr int kSlotShift = 13;         // staged entry: row | slot << 13
constexpr int kRowMask = (1 << kSlotShift) - 1;
constexpr int kTile = 32;              // traceback tile: 32 rows x 32 cols
constexpr int kRingMax = 16;           // recent H rows kept in shared memory
constexpr size_t kSmemMax = 232448;    // dynamic shared memory of a block

// clock64() split of a CTA's time (thread 0's clock), kept only in the
// build of poa_align.cu with -DPOA_ALIGN_SPLIT (tools/k1_split.py): cycles
// per part, in the order of k1_split.PARTS (part 1, the per-row pred setup,
// went into part 0, the prologue; part 4 holds the row's H, direction and
// sink).
constexpr int kSplitParts = 6;
#ifdef POA_ALIGN_SPLIT
#define SPLIT_BEGIN long long split_acc[kSplitParts] = {}; \
  long long split_t = clock64();
#define SPLIT(k) if (tid == 0) { const long long t_ = clock64(); \
  split_acc[k] += t_ - split_t; split_t = t_; }
#define SPLIT_END if (tid == 0) for (int k_ = 0; k_ < kSplitParts; ++k_) \
  split[(size_t)b * kSplitParts + k_] = split_acc[k_];
#else
#define SPLIT_BEGIN
#define SPLIT(k)
#define SPLIT_END
#endif

// Dynamic shared memory of a CTA: the ring of `ring` H rows, then per rank
// the staged entries and the per-slot pred rows (uint16 each), the entry
// count, the node char and the sink flag.
inline size_t smem_bytes(int N, int l_max, int ring, size_t h_bytes) {
  return (size_t)ring * (l_max + 1) * h_bytes
      + (size_t)N * (2 * kMaxPreds * sizeof(uint16_t) + 3);
}

// Threads a CTA may have with TILES columns a thread (the launch bound, so
// the registers a thread may use): 1 or 2 columns serve rows of up to 640
// columns on at most 320 threads (ops/poa_align.py::launch_tiles), 3 or 4
// the wider rows on up to 1024.
constexpr int max_threads(int tiles) { return tiles <= 2 ? 512 : 1024; }

template <typename In, typename HT, int Neg, int TILES>
__global__ void __launch_bounds__(max_threads(TILES))
poa_row_kernel(const In* __restrict__ chars,           // (B, N)
               const int32_t* __restrict__ preds,      // (B, N, 8)
               const In* __restrict__ sinks,           // (B, N)
               const int32_t* __restrict__ n_nodes,    // (B,)
               const In* __restrict__ seqs,            // (B, seq_stride)
               const int32_t* __restrict__ seq_lens,   // (B,)
               HT* __restrict__ H,                     // (B, N+1, l1)
               int8_t* __restrict__ D,                 // (B, N, l1)
               int32_t* __restrict__ an,               // (B, out_len)
               int32_t* __restrict__ asp,              // (B, out_len)
               int32_t* __restrict__ k_end,            // (B,)
               int32_t* __restrict__ score,            // (B,) or null
               long long* __restrict__ split,          // (B, kSplitParts)
               int N, int seq_stride, int l_max, int out_len, int ring) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int l1 = l_max + 1;
  HT* s_ring = reinterpret_cast<HT*>(smem);               // (ring, l1)
  uint16_t* s_ent =
      reinterpret_cast<uint16_t*>(s_ring + (size_t)ring * l1);  // (N, 8)
  uint16_t* s_prow = s_ent + (size_t)N * kMaxPreds;       // (N, 8)
  uint8_t* s_np = reinterpret_cast<uint8_t*>(s_prow + (size_t)N * kMaxPreds);
  uint8_t* s_ch = s_np + N;
  uint8_t* s_sk = s_ch + N;
  __shared__ int warp_tot[2 * 32];
  __shared__ int s_best[2];
  __shared__ int8_t tile[kTile][kTile];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  SPLIT_BEGIN
  const int nn = n_nodes[b];
  const int lb = seq_lens[b];
  const In* seq = seqs + (size_t)b * seq_stride;
  const In* chb = chars + (size_t)b * N;
  const In* skb = sinks + (size_t)b * N;
  const int32_t* pb = preds + (size_t)b * N * kMaxPreds;
  HT* Hb = H + (size_t)b * (N + 1) * l1;
  int8_t* Db = D + (size_t)b * N * l1;

  // stage the topology: distinct pred rows in slot order, chars, sinks
  for (int r = tid; r < nn; r += T) {
    const int4* q4 = reinterpret_cast<const int4*>(pb + (size_t)r * kMaxPreds);
    const int4 qa = q4[0];
    const int4 qb = q4[1];
    const int q[kMaxPreds] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    uint16_t* e = s_ent + r * kMaxPreds;
    uint16_t* pr = s_prow + r * kMaxPreds;
    int np = 0;
    e[np++] = (uint16_t)(max(q[0], -1) + 1);
#pragma unroll
    for (int p = 0; p < kMaxPreds; ++p) {
      if (p > 0 && q[p] >= 0 && q[p] != q[0]) {
        e[np++] = (uint16_t)((q[p] + 1) | (p << kSlotShift));
      }
      pr[p] = (uint16_t)(max(q[p] >= 0 ? q[p] : q[0], -1) + 1);
    }
    s_np[r] = (uint8_t)np;
    s_ch[r] = (uint8_t)chb[r];
    s_sk[r] = skb[r] > 0;
  }
  if (tid == 0) {
    s_best[0] = Neg;
    s_best[1] = 0;
  }

  // this thread's columns: read chars and row 0 in registers
  const int j0 = tid * TILES;
  int sq[TILES];
  int hrow[TILES];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
    const int j = j0 + t;
    sq[t] = (j >= 1 && j <= lb) ? (int)(uint8_t)seq[j - 1] : -1;
    hrow[t] = kGap * j;
    if (j <= lb) {
      Hb[j] = (HT)hrow[t];
      s_ring[j] = (HT)hrow[t];
    }
  }
  int hleft = kGap * (j0 - 1);   // H[i-1][j0-1], read only when j0 >= 1
  int bval = Neg;                // best sink: the owner of column lb only
  int brank = 0;
  __syncthreads();

  SPLIT(0)

  for (int r = 0; r < nn; ++r) {
    const int i = r + 1;
    const int np = s_np[r];
    const int ch = s_ch[r];
    const uint16_t* e = s_ent + r * kMaxPreds;
    // pred max over the staged rows, and its lowest slot, at the thread's
    // columns and at column j0 - 1
    int m[TILES], sl[TILES];
    int mL = kScanId;
    int slL = 0;
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      m[t] = kScanId;
      sl[t] = 0;
    }
    for (int k = 0; k < np; ++k) {
      const int ent = e[k];
      const int row = ent & kRowMask;
      const int slot = ent >> kSlotShift;
      int v[TILES];
      int vL;
      if (row == i - 1) {
        vL = hleft;
#pragma unroll
        for (int t = 0; t < TILES; ++t) v[t] = hrow[t];
      } else {
        // a recent row from the ring in shared memory, an older one from L2
        const HT* Hr = row > i - 1 - ring ? s_ring + (row & (ring - 1)) * l1
                                          : Hb + (size_t)row * l1;
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
          v[t] = j0 + t <= lb ? (int)Hr[j0 + t] : kScanId;
        }
        vL = __shfl_up_sync(0xffffffffu, v[TILES - 1], 1);
        if (lane == 0) {
          vL = j0 >= 1 && j0 - 1 <= lb ? (int)Hr[j0 - 1] : kScanId;
        }
      }
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        if (v[t] > m[t]) {
          m[t] = v[t];
          sl[t] = slot;
        }
      }
      if (vL > mL) {
        mL = vL;
        slL = slot;
      }
    }

    // row values before the gap chain, scanned within the thread
    int x[TILES], up[TILES], dg[TILES];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int j = j0 + t;
      up[t] = m[t] + kGap;
      dg[t] = kScanId;
      int base = up[t];
      if (j >= 1) {
        dg[t] = (t == 0 ? mL : m[t - 1]) + (sq[t] == ch ? kMatch : kMismatch);
        base = max(dg[t], up[t]);
      }
      x[t] = j <= lb ? base - kGap * j : kScanId;
      if (t > 0) x[t] = max(x[t], x[t - 1]);
    }
    SPLIT(2)
    const int excl = block_excl_max_1bar(x[TILES - 1], warp_tot, r & 1);
    SPLIT(3)
    hleft = (HT)(excl + kGap * (j0 - 1));

    // H, directions and the best sink, in the same pass
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int j = j0 + t;
      if (j <= lb) {
        const int h = (HT)(max(excl, x[t]) + kGap * j);
        int code = kDirLeft;
        if (j >= 1 && h == dg[t]) {
          code = t == 0 ? slL : sl[t - 1];
        } else if (h == up[t]) {
          code = 8 + sl[t];
        }
        Db[(size_t)r * l1 + j] = (int8_t)code;
        Hb[(size_t)i * l1 + j] = (HT)h;
        s_ring[(i & (ring - 1)) * l1 + j] = (HT)h;
        hrow[t] = h;
        if (j == lb && s_sk[r] && h > bval) {
          bval = h;
          brank = r;
        }
      }
    }
    SPLIT(4)
  }

  int32_t* anb = an + (size_t)b * out_len;
  int32_t* asb = asp + (size_t)b * out_len;
  for (int k = tid; k < out_len; k += T) {
    anb[k] = -2;
    asb[k] = -2;
  }
  if (lb <= l_max && tid == lb / TILES) {
    s_best[0] = bval;
    s_best[1] = brank;
  }
  __syncthreads();

  if (wid == 0) {
    int iv = s_best[1] + 1;
    int jv = lb;
    int kv = out_len - 1;
    while (jv > 0 && kv >= 0) {
      if (iv == 0 || iv - 1 >= nn) {
        // row 0 (or no graph): left moves to the end
        const int n = min(jv, kv + 1);
        for (int s = lane; s < n; s += 32) {
          anb[kv - s] = -1;
          asb[kv - s] = jv - 1 - s;
        }
        jv -= n;
        kv -= n;
        break;
      }
      const int r_hi = iv - 1;
      const int c_lo = jv - (kTile - 1);
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const int rr = r_hi - k;
        const int cc = c_lo + lane;
        tile[k][lane] = rr >= 0 && cc >= 0 ? Db[(size_t)rr * l1 + cc] : 0;
      }
      __syncwarp();
      if (lane == 0) {
        // preds are lower ranks, so the walk stays below nn
        while (jv > 0 && kv >= 0 && iv >= 1) {
          const int rr = iv - 1;
          const int k = r_hi - rr;
          const int c = jv - c_lo;
          if (k >= kTile || c < 0) break;
          const int code = tile[k][c];
          const bool left = code == kDirLeft;
          const bool up = code >= 8 && !left;
          anb[kv] = left ? -1 : iv - 1;
          asb[kv] = up ? -1 : jv - 1;
          if (!left) iv = s_prow[rr * kMaxPreds + (code & 7)];
          if (!up) jv -= 1;
          kv -= 1;
        }
      }
      iv = __shfl_sync(0xffffffffu, iv, 0);
      jv = __shfl_sync(0xffffffffu, jv, 0);
      kv = __shfl_sync(0xffffffffu, kv, 0);
      __syncwarp();
    }
    if (lane == 0) {
      k_end[b] = kv;
      if (score != nullptr) score[b] = s_best[0];
    }
  }
  SPLIT(5)
  SPLIT_END
}

// The kernel's arguments, as the entry points pass them.
struct RowArgs {
  const void* chars;
  const void* preds;
  const void* sinks;
  const void* n_nodes;
  const void* seqs;        // window b's read: seqs[b * seq_stride + j - 1]
  const void* seq_lens;
  void* H;
  void* D;
  void* an;
  void* asp;
  void* k_end;
  void* score;             // null: no score
  long long* split;        // null unless built with -DPOA_ALIGN_SPLIT
  int B, N, seq_stride, l_max, out_len, threads;
};

template <typename In, typename HT, int Neg, int TILES>
int launch_tiles(const RowArgs& a, cudaStream_t stream) {
  // the deepest ring (a power of two, at most kRingMax rows) that fits
  int ring = kRingMax;
  while (ring > 1 && smem_bytes(a.N, a.l_max, ring, sizeof(HT)) > kSmemMax) {
    ring >>= 1;
  }
  const size_t smem = smem_bytes(a.N, a.l_max, ring, sizeof(HT));
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = poa_row_kernel<In, HT, Neg, TILES>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<a.B, a.threads, smem, stream>>>(
      (const In*)a.chars, (const int32_t*)a.preds, (const In*)a.sinks,
      (const int32_t*)a.n_nodes, (const In*)a.seqs,
      (const int32_t*)a.seq_lens, (HT*)a.H, (int8_t*)a.D, (int32_t*)a.an,
      (int32_t*)a.asp, (int32_t*)a.k_end, (int32_t*)a.score, a.split, a.N,
      a.seq_stride, a.l_max, a.out_len, ring);
  return (int)cudaGetLastError();
}

// threads: whole warps, at most max_threads(TILES) for TILES =
// ceil((l_max+1) / threads) in 1-4; N at most kRowMask (the staged row
// field).  Else cudaErrorInvalidValue.
template <typename In, typename HT, int Neg>
int launch(const RowArgs& a, void* stream) {
  if (a.B <= 0) return 0;
  if (a.threads <= 0 || a.threads % 32 || a.N > kRowMask) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (a.l_max + 1 + a.threads - 1) / a.threads;
  if (a.threads > max_threads(tiles)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tiles) {
    case 1: return launch_tiles<In, HT, Neg, 1>(a, s);
    case 2: return launch_tiles<In, HT, Neg, 2>(a, s);
    case 3: return launch_tiles<In, HT, Neg, 3>(a, s);
    case 4: return launch_tiles<In, HT, Neg, 4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace poa_row
