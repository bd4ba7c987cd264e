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
//     on ties.  The ranks are dependent, so one warp walks them, a slot a
//     lane (8 lanes; 64-bit shuffles for the max, a ballot for the first
//     slot); the block stages the next tile of ranks' pred and weight rows
//     in shared memory between tiles.  Ranks run to the batch's largest
//     node count, as the plain version's loop does;
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
// What bounds it: the score pass, one dependent step a rank (a shared load,
// three shuffles, a ballot, a store), and the walks, one dependent load a
// step; the bytes (a node's three pred rows, the order, two int64 buffers)
// take a few microseconds at the bench bucket.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPreds = 8;
constexpr int kBig = 1 << 30;
constexpr int kThreads = 512;
constexpr int kTile = 256;                  // ranks staged per tile
constexpr int kSmemMax = 232448;            // a block's shared memory (H100)
constexpr long long kWeightShift = 1ll << 21;

struct WalkArgs {
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

// score and best out-key (int64), then order, best_in, stamp min, best
// out-edge (int32), then the staged tile; the walks' buffers reuse the
// out-key array.
__host__ __device__ inline int walk_smem(int ncap) {
  return 16 * ncap + 16 * ncap + 2 * kTile * kMaxPreds * 4;
}

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ inline long long shfl_max8(long long v) {
#pragma unroll
  for (int o = 1; o < kMaxPreds; o <<= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max (kMax) or min of v over the block, returned to every thread.
template <bool kMax>
__device__ long long block_reduce(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? max(v, u) : min(v, u);
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const long long id = kMax ? (long long)INT64_MIN : (long long)INT64_MAX;
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : id;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? max(v, u) : min(v, u);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) pk_consensus_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long red[32];
  __shared__ int s_ends[2];
  const int n = a.ncap;
  const int w = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31;
  long long* s_score = reinterpret_cast<long long*>(smem);
  long long* s_mx = s_score + n;
  int32_t* s_order = reinterpret_cast<int32_t*>(s_mx + n);
  int32_t* s_best_in = s_order + n;
  int32_t* s_tmn = s_best_in + n;
  int32_t* s_best_out = s_tmn + n;
  int32_t* s_tpn = s_best_out + n;               // (kTile, 8)
  int32_t* s_tpw = s_tpn + kTile * kMaxPreds;    // (kTile, 8)
  int32_t* s_back = reinterpret_cast<int32_t*>(s_mx);
  int32_t* s_fwd = s_back + n;

  const size_t row0 = (size_t)w * n;
  const int32_t* pn = a.pn + row0 * kMaxPreds;
  const int32_t* pw = a.pw + row0 * kMaxPreds;
  const int32_t* pt = a.pt + row0 * kMaxPreds;
  const int nnw = a.nn[w];
  int steps = 0;                                 // the batch's largest nn
  for (int b = tid; b < a.B; b += T) steps = max(steps, a.nn[b]);
  steps = clampi((int)block_reduce<true>(steps, red), 0, n);
  for (int v = tid; v < n; v += T) {
    s_score[v] = 0;
    s_best_in[v] = -1;
    s_order[v] = clampi((int)a.order[row0 + v], 0, n - 1);
    s_mx[v] = -1;
    s_tmn[v] = kBig;
    s_best_out[v] = -1;
  }

  // ---- score pass in rank order: warp 0, a pred slot a lane ----
  for (int t0 = 0; t0 < steps; t0 += kTile) {
    const int cnt = min(kTile, steps - t0);
    __syncthreads();
    for (int k = tid; k < 2 * cnt; k += T) {
      const int r = k >> 1;
      const int32_t* src = (k & 1 ? pw : pn) +
                           (size_t)s_order[t0 + r] * kMaxPreds;
      int32_t* dst = (k & 1 ? s_tpw : s_tpn) + r * kMaxPreds;
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      d4[0] = s4[0];
      d4[1] = s4[1];
    }
    __syncthreads();
    if (tid < 32) {
      const int s = lane & (kMaxPreds - 1);
      for (int k = 0; k < cnt; ++k) {
        const int v = s_order[t0 + k];
        const int p = s_tpn[k * kMaxPreds + s];
        const int wt = s_tpw[k * kMaxPreds + s];
        const bool vm = p >= 0 && v < nnw;
        const long long sc = s_score[clampi(p, 0, n - 1)];
        const long long key = vm ? (long long)wt * kWeightShift + sc : -1;
        const long long mx = shfl_max8(key);
        const unsigned first = __ballot_sync(0xffffffffu, key == mx) & 0xffu;
        const unsigned has = __ballot_sync(0xffffffffu, vm) & 0xffu;
        if (lane == __ffs(first) - 1) {
          s_score[v] = has ? (long long)wt + sc : 0;
          s_best_in[v] = has ? p : -1;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- the first max-score node in rank order ----
  long long best = -1;
  for (int i = tid; i < n; i += T)
    best = max(best, i < nnw ? s_score[s_order[i]] : -1ll);
  best = block_reduce<true>(best, red);
  long long first = n;
  for (int i = tid; i < n; i += T)
    if ((i < nnw ? s_score[s_order[i]] : -1ll) == best) first = min(first, (long long)i);
  first = block_reduce<false>(first, red);
  const int vmax = nnw > 0 ? s_order[min((int)first, n - 1)] : -1;

  // ---- per node, the best out-edge ----
  for (int e = tid; e < n * kMaxPreds; e += T) {
    const int v = e / kMaxPreds, p = pn[e];
    if (p >= 0 && v < nnw)
      atomicMax(&s_mx[clampi(p, 0, n - 1)],
                (long long)pw[e] * kWeightShift + s_score[v]);
  }
  __syncthreads();
  const int tcap = n * kMaxPreds;
  for (int e = tid; e < n * kMaxPreds; e += T) {
    const int v = e / kMaxPreds, p = pn[e];
    if (p < 0 || v >= nnw) continue;
    const int t = clampi(p, 0, n - 1);
    if ((long long)pw[e] * kWeightShift + s_score[v] == s_mx[t])
      atomicMin(&s_tmn[t], clampi(pt[e], 0, tcap - 1));
  }
  __syncthreads();
  for (int e = tid; e < n * kMaxPreds; e += T) {
    const int v = e / kMaxPreds, p = pn[e];
    if (p < 0 || v >= nnw) continue;
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
}

}  // namespace

// K7's dynamic shared memory in bytes (ops/poa_fused_kernel.
// consensus_smem_bytes mirrors it).
extern "C" int pk_consensus_smem_bytes(int ncap) { return walk_smem(ncap); }

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
  if (B <= 0) return 0;
  const int smem = walk_smem(ncap);
  if (ncap <= 0 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  WalkArgs a{(const int32_t*)pn,    (const int32_t*)pw,
             (const int32_t*)pt,    (const int32_t*)nn,
             (const int64_t*)order, (int64_t*)back_buf,
             (int64_t*)back_start,  (int64_t*)fwd_buf,
             (int64_t*)fwd_cnt,     B,
             ncap};
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pk_consensus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  pk_consensus_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
