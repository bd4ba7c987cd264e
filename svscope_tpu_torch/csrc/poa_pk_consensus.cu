// K7 on Hopper: the heaviest-bundle consensus walk that ends each fused
// `pk` MSA build, one launch a chunk, with no host sync.
//
// Replaces the on-device XLA loops of the JAX package's pk build:
// svscope_tpu/ops/poa_fused.py::_consensus_walk (its score lax.scan and the
// two lax.while_loop walks).  The plain torch version is
// svscope_tpu_torch/ops/poa_fused.py::consensus_walk_reference;
// tests/torch_glue_model.py transcribes this kernel's per-window loop.
// Outputs are equal bit for bit.
//
// One block per window, its working arrays in shared memory:
//   * score pass, in rank order: a node's score is its best in-edge's
//     weight plus the tail's score, the best in-edge the max of
//     (weight << 21) + tail score over its pred slots, the first such slot
//     on ties.  The ranks are dependent, so warp 0 walks them, a slot a
//     lane (8 lanes), while the other warps stage the next tile of ranks'
//     pred and weight rows in shared memory (two tiles in turn).  Each
//     rank's key is 32 bits where the window allows it (every weight of
//     its ranks in [0, 2^10) and the sum of their largest in-weights, which
//     bounds every score, below 2^21: JAX's own range, and what every
//     window of the bucket ladder holds, at most 512 reads), so the max is
//     one __reduce_max_sync and the score falls out of the max key; other
//     windows take 64-bit keys (three shuffles and a shuffle of the
//     winner's score).  The previous rank's score is forwarded in a
//     register when it is the tail, the next rank's tail score is loaded
//     before this rank's store, and the rows two ranks ahead are loaded
//     while this one resolves.  The pass runs to the window's last rank
//     that holds an active node (its node count, for an order from K6:
//     BIG keys sort by id, so the active unplaced nodes of a cyclic window
//     come before the inactive ones); ranks past it are no-ops;
//   * the start node: the first max-score node in rank order (block
//     reductions);
//   * per node the best out-edge: the max (weight << 21) + head score over
//     its out-edges (shared 64-bit atomic max over every pred slot), then
//     the smallest creation stamp among those (atomic min); stamps are
//     unique in a window (each new edge takes the next one), and a tie
//     would take the last slot, as the plain version's scatter on the CPU;
//   * the walks: back from the start over best in-edges, forward over best
//     out-edges, each by one thread, bounded by ncap steps (the JAX
//     package's cycle safety net); then every thread copies the buffers
//     out as int64, -1 where unwritten.
//
// What bounds it: the score pass, one dependent step a rank (a select, an
// add, the warp max, the score's shift-and-add, then the ballot and the
// shuffle of the winning slot): ~156 cycles a rank on the H100, 60-70 %
// of the launch (tools/glue_split.py); then the walks, one dependent load
// a step (15 us at either bucket), and the best out-edges over the active
// nodes' slots.  The bytes (a node's three pred rows, the order, two int64
// buffers) take a few microseconds at the bench bucket.
#include <cstdint>
#include <cuda_runtime.h>

// A named namespace, not an anonymous one: a profiler's trace names a
// kernel by its demangled name, which would begin "(anonymous
// namespace)::" and so read as no name where the name is cut at its first
// parenthesis.
namespace pk_consensus {

constexpr int kMaxPreds = 8;
constexpr int kBig = 1 << 30;
constexpr int kThreads = 512;
constexpr int kTile = 256;                  // ranks staged per tile
constexpr int kSmemMax = 232448;            // a block's shared memory (H100)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWeightBits = 21;
constexpr long long kWeightShift = 1ll << kWeightBits;
constexpr int kScoreMask = (1 << kWeightBits) - 1;
constexpr int kNarrowWeights = 1 << 10;     // 32-bit keys: weights below
constexpr int kNoSlot = -(1 << 30);         // a 32-bit key below any valid

struct WalkArgs {
  long long* split;      // (B, kSplitParts), -DPK_GLUE_SPLIT builds only
  const int32_t* pn;     // (B, ncap, 8) pred node ids, -1 empty
  const int32_t* pw;     // (B, ncap, 8) weights
  const int32_t* pt;     // (B, ncap, 8) creation stamps
  const int32_t* nn;     // (B,)
  const int64_t* order;  // (B, ncap) node ids by rank
  int64_t* back_buf;     // (B, ncap)
  int64_t* back_start;   // (B,)
  int64_t* fwd_buf;      // (B, ncap)
  int64_t* fwd_cnt;      // (B,)
  int B, ncap;
};

// clock64() cycles of thread 0 per part (setup and the score plan, the
// score pass, the start node, the best out-edges, the walks and the
// buffers' write), in a build with -DPK_GLUE_SPLIT (tools/glue_split.py);
// a part ends at the barrier that closes it.
constexpr int kSplitParts = 5;
#ifdef PK_GLUE_SPLIT
#define SPLIT_BEGIN long long split_acc[kSplitParts] = {}; \
  long long split_t = clock64();
#define SPLIT(k) if (tid == 0) { const long long t_ = clock64(); \
  split_acc[k] += t_ - split_t; split_t = t_; }
#define SPLIT_END if (tid == 0 && a.split) \
  for (int k_ = 0; k_ < kSplitParts; ++k_) \
  a.split[(size_t)w * kSplitParts + k_] = split_acc[k_];
#else
#define SPLIT_BEGIN
#define SPLIT(k)
#define SPLIT_END
#endif

// score and best out-key (int64), then order, best_in, stamp min, best
// out-edge (int32), then two staged tiles (pred and weight rows); the
// walks' buffers reuse the out-key array.
__host__ __device__ inline int walk_smem(int ncap) {
  return 16 * ncap + 16 * ncap + 2 * 2 * kTile * kMaxPreds * 4;
}

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

enum Op { kMax, kMin, kSum };

// Max, min or sum of v over the block, returned to every thread.
template <Op kOp>
__device__ long long block_reduce(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto op = [](long long x, long long y) {
    return kOp == kMax ? max(x, y) : kOp == kMin ? min(x, y) : x + y;
  };
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const long long id = kOp == kMax ? (long long)INT64_MIN
                       : kOp == kMin ? (long long)INT64_MAX : 0ll;
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : id;
#pragma unroll
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One rank of the score pass with 32-bit keys.  v, p (clamped to pc), w:
// this lane's slot of the rank; raw: score[pc] as loaded before the
// previous rank's store, (pv, ps) the previous rank's node and score.
__device__ inline int score_rank32(int v, int p, int pc, int w, bool vm,
                                   int raw, int pv, int ps,
                                   long long* s_score, int32_t* s_best_in) {
  const int sc = pc == pv ? ps : raw;
  const int key = (vm ? w << kWeightBits : kNoSlot) + sc;
  const int mx = __reduce_max_sync(kFull, key);
  const int m = max(mx, 0);
  const int score = (m >> kWeightBits) + (m & kScoreMask);
  const unsigned first = __ballot_sync(kFull, key == mx) & 0xffu;
  const int won = __shfl_sync(kFull, p, __ffs(first) - 1);
  s_best_in[v] = mx >= 0 ? won : -1;        // every lane: no branch, and
  s_score[v] = score;                       // its own later loads
  return score;
}

// The same with 64-bit keys, for any weights (the plain version's keys).
__device__ inline long long score_rank64(int v, int p, int pc, int w,
                                         bool vm, long long raw, int pv,
                                         long long ps, int lane,
                                         long long* s_score,
                                         int32_t* s_best_in) {
  const long long sc = pc == pv ? ps : raw;
  const long long key = vm ? (long long)w * kWeightShift + sc : -1;
  long long mx = key;
#pragma unroll
  for (int o = 1; o < kMaxPreds; o <<= 1)
    mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  const unsigned first = __ballot_sync(kFull, key == mx) & 0xffu;
  const unsigned has = __ballot_sync(kFull, vm) & 0xffu;
  const int f = __ffs(first) - 1;
  const long long won = __shfl_sync(kFull, (long long)w + sc, f);
  const long long score = has ? won : 0;
  if (lane == f) s_best_in[v] = has ? p : -1;
  s_score[v] = score;
  return score;
}

// The score pass over one staged tile (ranks t0 .. t0 + cnt - 1), by warp
// 0; (pv, ps) carry the previous rank across tiles.
template <bool kWide>
__device__ void score_tile(int t0, int cnt, int n, int nnw,
                           const int32_t* s_order, const int32_t* tpn,
                           const int32_t* tpw, long long* s_score,
                           int32_t* s_best_in, int& pv, long long& ps) {
  const int lane = threadIdx.x & 31;
  const int s = lane & (kMaxPreds - 1);
  const bool ln = lane < kMaxPreds;
  int v = s_order[t0];
  int p = tpn[s], w = tpw[s];
  int pc = clampi(p, 0, n - 1);
  long long raw = s_score[pc];
  int v1 = 0, p1 = -1, w1 = 0;
  if (cnt > 1) {
    v1 = s_order[t0 + 1];
    p1 = tpn[kMaxPreds + s];
    w1 = tpw[kMaxPreds + s];
  }
  for (int k = 0; k < cnt; ++k) {
    const bool vm = ln && p >= 0 && v < nnw;
    // the rows two ranks ahead, and the next rank's tail score, before
    // this rank's store (the forward covers a tail that is this rank)
    int v2 = 0, p2 = -1, w2 = 0;
    if (k + 2 < cnt) {
      v2 = s_order[t0 + k + 2];
      p2 = tpn[(k + 2) * kMaxPreds + s];
      w2 = tpw[(k + 2) * kMaxPreds + s];
    }
    const int pc1 = clampi(p1, 0, n - 1);
    const long long raw1 = s_score[pc1];
    if (kWide)
      ps = score_rank64(v, p, pc, w, vm, raw, pv, ps, lane, s_score,
                        s_best_in);
    else
      ps = score_rank32(v, p, pc, w, vm, (int)raw, pv, (int)ps, s_score,
                        s_best_in);
    pv = v;
    v = v1; p = p1; w = w1; pc = pc1; raw = raw1;
    v1 = v2; p1 = p2; w1 = w2;
  }
}

// Stage ranks t0 .. t0 + cnt - 1's pred and weight rows (16-byte copies),
// by threads [first, blockDim.x).
__device__ inline void stage_tile(int t0, int cnt, int first,
                                  const int32_t* s_order, const int32_t* pn,
                                  const int32_t* pw, int32_t* tpn,
                                  int32_t* tpw) {
  for (int k = threadIdx.x - first; k < 2 * cnt;
       k += blockDim.x - first) {
    const int r = k >> 1;
    const int4* src = reinterpret_cast<const int4*>(
        (k & 1 ? pw : pn) + (size_t)s_order[t0 + r] * kMaxPreds);
    int4* dst = reinterpret_cast<int4*>((k & 1 ? tpw : tpn) + r * kMaxPreds);
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

__global__ void __launch_bounds__(kThreads) pk_consensus_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long red[32];
  __shared__ int s_ends[2];
  const int n = a.ncap;
  const int w = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  long long* s_score = reinterpret_cast<long long*>(smem);
  long long* s_mx = s_score + n;
  int32_t* s_order = reinterpret_cast<int32_t*>(s_mx + n);
  int32_t* s_best_in = s_order + n;
  int32_t* s_tmn = s_best_in + n;
  int32_t* s_best_out = s_tmn + n;
  int32_t* s_tpn = s_best_out + n;               // 2 x (kTile, 8)
  int32_t* s_tpw = s_tpn + 2 * kTile * kMaxPreds;  // 2 x (kTile, 8)
  int32_t* s_back = reinterpret_cast<int32_t*>(s_mx);
  int32_t* s_fwd = s_back + n;

  const size_t row0 = (size_t)w * n;
  const int32_t* pn = a.pn + row0 * kMaxPreds;
  const int32_t* pw = a.pw + row0 * kMaxPreds;
  const int32_t* pt = a.pt + row0 * kMaxPreds;
  const int nnw = a.nn[w];
  const int nact = clampi(nnw, 0, n);            // active nodes: ids < nn
  SPLIT_BEGIN
  int batch = 0;                                 // the batch's largest nn
  for (int b = tid; b < a.B; b += T) batch = max(batch, a.nn[b]);
  batch = clampi((int)block_reduce<kMax>(batch, red), 0, n);
  for (int v = tid; v < n; v += T) {
    s_score[v] = 0;
    s_best_in[v] = -1;
    s_order[v] = clampi((int)a.order[row0 + v], 0, n - 1);
    s_mx[v] = -1;
    s_tmn[v] = kBig;
    s_best_out[v] = -1;
  }
  __syncthreads();
  // the window's own ranks (past its last active one every rank is a
  // no-op), and whether its keys fit 32 bits
  int last = 0, wide = 0;
  long long bound = 0;
  for (int i = tid; i < batch; i += T) {
    const int v = s_order[i];
    if (v >= nnw) continue;
    last = i + 1;
    int m = 0;
    for (int s = 0; s < kMaxPreds; ++s) {
      if (pn[v * kMaxPreds + s] < 0) continue;
      const int wt = pw[v * kMaxPreds + s];
      wide |= wt < 0 || wt >= kNarrowWeights;
      m = max(m, wt);
    }
    bound += m;
  }
  const int steps = (int)block_reduce<kMax>(last, red);
  wide = (int)block_reduce<kMax>(wide, red);
  bound = block_reduce<kSum>(bound, red);
  wide |= bound > kScoreMask;
  SPLIT(0)

  // ---- score pass in rank order: warp 0, a pred slot a lane ----
  int pv = -1;
  long long ps = 0;
  if (steps > 0)
    stage_tile(0, min(kTile, steps), 0, s_order, pn, pw, s_tpn, s_tpw);
  for (int t0 = 0, b = 0; t0 < steps; t0 += kTile, b ^= 1) {
    __syncthreads();
    const int cnt = min(kTile, steps - t0);
    int32_t* tpn = s_tpn + b * kTile * kMaxPreds;
    int32_t* tpw = s_tpw + b * kTile * kMaxPreds;
    if (tid < 32) {
      if (wide)
        score_tile<true>(t0, cnt, n, nnw, s_order, tpn, tpw, s_score,
                         s_best_in, pv, ps);
      else
        score_tile<false>(t0, cnt, n, nnw, s_order, tpn, tpw, s_score,
                          s_best_in, pv, ps);
    } else if (t0 + kTile < steps) {
      const int o = (b ^ 1) * kTile * kMaxPreds;
      stage_tile(t0 + kTile, min(kTile, steps - t0 - kTile), 32, s_order,
                 pn, pw, s_tpn + o, s_tpw + o);
    }
  }
  __syncthreads();
  SPLIT(1)

  // ---- the first max-score node in rank order ----
  long long best = -1;
  for (int i = tid; i < n; i += T)
    best = max(best, i < nnw ? s_score[s_order[i]] : -1ll);
  best = block_reduce<kMax>(best, red);
  long long first = n;
  for (int i = tid; i < n; i += T)
    if ((i < nnw ? s_score[s_order[i]] : -1ll) == best) first = min(first, (long long)i);
  first = block_reduce<kMin>(first, red);
  const int vmax = nnw > 0 ? s_order[min((int)first, n - 1)] : -1;
  SPLIT(2)

  // ---- per node, the best out-edge (the active nodes' slots) ----
  for (int e = tid; e < nact * kMaxPreds; e += T) {
    const int v = e / kMaxPreds, p = pn[e];
    if (p >= 0)
      atomicMax(&s_mx[clampi(p, 0, n - 1)],
                (long long)pw[e] * kWeightShift + s_score[v]);
  }
  __syncthreads();
  const int tcap = n * kMaxPreds;
  for (int e = tid; e < nact * kMaxPreds; e += T) {
    const int v = e / kMaxPreds, p = pn[e];
    if (p < 0) continue;
    const int t = clampi(p, 0, n - 1);
    if ((long long)pw[e] * kWeightShift + s_score[v] == s_mx[t])
      atomicMin(&s_tmn[t], clampi(pt[e], 0, tcap - 1));
  }
  __syncthreads();
  for (int e = tid; e < nact * kMaxPreds; e += T) {
    const int v = e / kMaxPreds, p = pn[e];
    if (p < 0) continue;
    const int t = clampi(p, 0, n - 1);
    if ((long long)pw[e] * kWeightShift + s_score[v] == s_mx[t] &&
        clampi(pt[e], 0, tcap - 1) == s_tmn[t])
      atomicMax(&s_best_out[t], e);
  }
  __syncthreads();
  for (int v = tid; v < n; v += T) {
    if (s_best_out[v] >= 0) s_best_out[v] /= kMaxPreds;   // slot -> head
    s_back[v] = -1;                                      // s_mx is free
    s_fwd[v] = -1;
  }
  __syncthreads();
  SPLIT(3)

  // ---- the walks: back over best in-edges, forward over best out-edges
  if (tid == 0) {
    int v = vmax, idx = n - 1;
    while (v >= 0 && idx >= 0) {
      s_back[idx--] = v;
      v = s_best_in[clampi(v, 0, n - 1)];
    }
    s_ends[0] = max(idx + 1, 0);
  } else if (tid == 32) {
    int v = vmax, c = 0;
    while (v >= 0 && c < n) {
      const int nv = s_best_out[v];
      if (nv < 0) break;
      s_fwd[c++] = nv;
      v = nv;
    }
    s_ends[1] = c;
  }
  __syncthreads();
  for (int i = tid; i < n; i += T) {
    a.back_buf[row0 + i] = s_back[i];
    a.fwd_buf[row0 + i] = s_fwd[i];
  }
  if (tid == 0) {
    a.back_start[w] = s_ends[0];
    a.fwd_cnt[w] = s_ends[1];
  }
  SPLIT(4)
  SPLIT_END
}

}  // namespace pk_consensus

using namespace pk_consensus;

// K7's dynamic shared memory in bytes (ops/poa_fused_kernel.
// consensus_smem_bytes mirrors it).
extern "C" int pk_consensus_smem_bytes(int ncap) { return walk_smem(ncap); }

// One K7 launch; `split` null but in a -DPK_GLUE_SPLIT build.
static int consensus_launch(const void* pn, const void* pw, const void* pt,
                            const void* nn, const void* order,
                            void* back_buf, void* back_start, void* fwd_buf,
                            void* fwd_cnt, void* split, int B, int ncap,
                            void* stream) {
  if (B <= 0) return 0;
  const int smem = walk_smem(ncap);
  if (ncap <= 0 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  WalkArgs a{(long long*)split,     (const int32_t*)pn,
             (const int32_t*)pw,    (const int32_t*)pt,
             (const int32_t*)nn,    (const int64_t*)order,
             (int64_t*)back_buf,    (int64_t*)back_start,
             (int64_t*)fwd_buf,     (int64_t*)fwd_cnt,
             B,                     ncap};
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pk_consensus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  pk_consensus_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Plain C entry point (bound with ctypes).  pn, pw 16-byte aligned.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for an ncap
// past a block's shared memory.
extern "C" int pk_consensus_launch(const void* pn, const void* pw,
                                   const void* pt, const void* nn,
                                   const void* order, void* back_buf,
                                   void* back_start, void* fwd_buf,
                                   void* fwd_cnt, int B, int ncap,
                                   void* stream) {
  return consensus_launch(pn, pw, pt, nn, order, back_buf, back_start,
                          fwd_buf, fwd_cnt, nullptr, B, ncap, stream);
}

#ifdef PK_GLUE_SPLIT
// K7 with the clock64() split written to `split` (B, kSplitParts).
extern "C" int pk_consensus_split_launch(
    const void* pn, const void* pw, const void* pt, const void* nn,
    const void* order, void* back_buf, void* back_start, void* fwd_buf,
    void* fwd_cnt, int B, int ncap, void* split, void* stream) {
  return consensus_launch(pn, pw, pt, nn, order, back_buf, back_start,
                          fwd_buf, fwd_cnt, split, B, ncap, stream);
}
#endif
