// K6 on Hopper: the round prep of the fused `pk` MSA build — each window's
// canonical group-Kahn order and the rank-space operands of K3 and the
// fusion, in one launch a round, with no host sync.
//
// Replaces the on-device XLA loop of the JAX package's pk build:
// svscope_tpu/ops/poa_fused.py::_toposort (its lax.while_loop) inside
// ::_pk_round_prep (the rank-space gathers, the sinks from out-degrees, the
// read staging).  The plain torch versions are
// svscope_tpu_torch/ops/poa_fused.py::toposort_reference and
// ::pk_round_prep_reference; tests/torch_glue_model.py transcribes this
// kernel's per-window loop.  Results are equal, cyclic states included.
//
// One block per window; everything the loop touches lives in shared memory:
//   * the column ids gm, the placed flag and the step at which each column
//     was placed, and per column the min / max column id of its unplaced
//     blockers;
//   * the window's cross-column edges (tail column, head column), packed in
//     one word each and collected once from the pred rows (8 slots a node).
// A Kahn step (kahn_step of the plain version): the blockers are reduced
// over the edges whose tail is unplaced with shared atomics, gstar (the
// smallest ready column) and the first column from gstar on that cannot
// join the run are block reductions, and every unplaced column in
// [gstar, first failure) is placed at this step.  The loop ends at a step
// that places nothing, when every column is placed, or at `ncap` steps.
// The order is the stable sort of the keys (step * ncap + column) by node
// id: a bitonic sort of (key << 16 | id) words in shared memory (the edge
// buffer, free by then).  Then the rank-space view: chars, column ids and
// sinks (out-degree 0, counted with shared atomics) by rank, the pred rows
// mapped to ranks with empty slots copying slot 0 (16-byte stores, for K3),
// and the read staged as K3 and the fusion take it.
//
// Two modes: with `charsr` null only the order (order, rank, cyclic) is
// written, as the build's final toposort needs it; otherwise only the
// round's operands and cyclic, and ovf |= cyclic when `ovf` is given.
//
// What bounds it: the steps are dependent (about 80 a round on the bench
// bucket), each a pass over the window's edges and columns and three block
// reductions, so a window costs its steps' barriers and shared-memory
// atomics; bytes and operations are far below that.  Windows run in
// parallel, one block each, and the heavy tier's few windows spread each
// step's edges and columns over up to 1024 threads.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPreds = 8;
constexpr int kBig = 1 << 30;
constexpr int kIdBits = 16;                 // node ids below 2^16
constexpr int kSmemMax = 232448;            // a block's shared memory (H100)

struct PrepArgs {
  const int32_t* pn;     // (B, ncap, 8) pred node ids, -1 empty
  const int32_t* gm;     // (B, ncap) column id
  const int32_t* nn;     // (B,) node count
  const int32_t* ch;     // (B, ncap) base code          (prep mode)
  const int32_t* seq;    // (B, l_max) the round's read  (prep mode)
  const int32_t* slen;   // (B,)                          (prep mode)
  int32_t* ovf;          // (B,) |= cyclic, or null
  uint8_t* cyclic;       // (B,) bool
  int64_t* order;        // (B, ncap)                     (order mode)
  int64_t* rank;         // (B, ncap)                     (order mode)
  int32_t* charsr;       // (B, ncap)                     (prep mode) ...
  int32_t* sinksr;       // (B, ncap)
  int32_t* predsp;       // (B, ncap, 8), 16-byte aligned
  int32_t* seqv;         // (B, l_max + 1)
  int32_t* lb;           // (B,)
  int32_t* nn_eff;       // (B,)
  int32_t* gminr;        // (B, ncap)
  int B, ncap, l_max;
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory of one window's block: the edge words (8 a node),
// which the sort's 8-byte keys reuse (at most 2 ncap of them), then gm, the
// placement step, the blocker max and min (int32 each) and the placed flags.
__host__ __device__ inline int prep_smem(int ncap) {
  const int edges = 4 * kMaxPreds * ncap;
  const int keys = 8 * pow2_at_least(ncap);
  return (edges > keys ? edges : keys) + 16 * ncap + ((ncap + 15) & ~15);
}

// Block threads: a quarter of the sort's width, 128 to 1024.
inline int prep_threads(int ncap) {
  const int t = pow2_at_least(ncap) / 4;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Min (or sum) of v over the block, returned to every thread.  The first
// barrier frees `red` from the previous reduction's readers.
template <bool kSum>
__device__ int block_reduce(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kSum ? v + u : min(v, u);
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : (kSum ? 0 : kBig);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kSum ? v + u : min(v, u);
  }
  return v;
}

__global__ void __launch_bounds__(1024) pk_prep_kernel(PrepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[32];
  __shared__ int s_ne;
  const int n = a.ncap;
  const int w = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int p2 = pow2_at_least(n);
  const int ebytes = max(4 * kMaxPreds * n, 8 * p2);
  uint32_t* s_edge = reinterpret_cast<uint32_t*>(smem);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);
  int32_t* s_gm = reinterpret_cast<int32_t*>(smem + ebytes);
  int32_t* s_itg = s_gm + n;       // step placed; out-degree after the sort
  int32_t* s_bmax = s_itg + n;     // blocker max; order after the sort
  int32_t* s_bmin = s_bmax + n;    // blocker min; rank after the sort
  uint8_t* s_placed = reinterpret_cast<uint8_t*>(s_bmin + n);

  const int32_t* pn = a.pn + (size_t)w * n * kMaxPreds;
  const int nnw = a.nn[w];
  const int nact = clampi(nnw, 0, n);      // active nodes: ids < nn
  if (tid == 0) s_ne = 0;
  for (int v = tid; v < n; v += T) {
    s_gm[v] = a.gm[(size_t)w * n + v];
    s_itg[v] = kBig;
    s_bmax[v] = -1;
    s_bmin[v] = kBig;
    s_placed[v] = 0;
  }
  __syncthreads();
  // the cross-column edges of the active nodes, (tail << 16) | head
  int ngrp = 0;
  for (int v = tid; v < nact; v += T) {
    const int4* row = reinterpret_cast<const int4*>(pn + (size_t)v * kMaxPreds);
    const int4 r0 = row[0], r1 = row[1];
    const int p[kMaxPreds] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const int h = s_gm[v];
    ngrp += h == v;
#pragma unroll
    for (int s = 0; s < kMaxPreds; ++s) {
      if (p[s] < 0) continue;
      const int t = s_gm[clampi(p[s], 0, n - 1)];
      if (t != h) s_edge[atomicAdd(&s_ne, 1)] = ((uint32_t)t << kIdBits) | h;
    }
  }
  int remaining = block_reduce<true>(ngrp, red);   // unplaced columns
  const int ne = s_ne;

  for (int it = 0; it < n && remaining > 0; ++it) {
    for (int e = tid; e < ne; e += T) {
      const uint32_t ed = s_edge[e];
      const int t = ed >> kIdBits, h = ed & ((1u << kIdBits) - 1);
      if (!s_placed[t]) {
        atomicMax(&s_bmax[h], t);
        atomicMin(&s_bmin[h], t);
      }
    }
    __syncthreads();
    int r = kBig;
    for (int g = tid; g < nact; g += T)
      if (s_gm[g] == g && !s_placed[g] && s_bmax[g] < 0) r = min(r, g);
    const int gstar = block_reduce<false>(r, red);
    r = kBig;
    for (int g = tid; g < nact; g += T) {
      if (s_gm[g] != g || s_placed[g] || g < gstar) continue;
      const int bx = s_bmax[g];
      if (!(bx < 0 || (s_bmin[g] >= gstar && bx < g))) r = min(r, g);
    }
    const int fail = block_reduce<false>(r, red);
    // every unplaced column in [gstar, fail) can join the run; the
    // blockers are reset for the next step (read by their owner only)
    int cnt = 0;
    for (int g = tid; g < n; g += T) {
      if (g < nact && g >= gstar && g < fail && s_gm[g] == g &&
          !s_placed[g]) {
        s_placed[g] = 1;
        s_itg[g] = it;
        ++cnt;
      }
      s_bmax[g] = -1;
      s_bmin[g] = kBig;
    }
    const int placed = block_reduce<true>(cnt, red);
    remaining -= placed;
    if (placed == 0) break;
  }
  const int cyc = remaining > 0;

  // keys: (step * ncap + column) of placed nodes, kBig else; by node id
  for (int i = tid; i < p2; i += T) {
    unsigned long long k = ~0ull;
    if (i < n) {
      long long key = kBig;
      if (i < nact) {
        const int g = clampi(s_gm[i], 0, n - 1);
        if (s_placed[g] && s_itg[g] < kBig)
          key = (long long)s_itg[g] * n + s_gm[i];
      }
      k = ((unsigned long long)key << kIdBits) | (unsigned)i;
    }
    s_key[i] = k;
  }
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += T) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long x = s_key[i], y = s_key[l];
          if ((x > y) == ((i & k) == 0)) {
            s_key[i] = y;
            s_key[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  int32_t* s_order = s_bmax;
  int32_t* s_rank = s_bmin;
  int32_t* s_deg = s_itg;
  for (int i = tid; i < n; i += T) {
    const int v = (int)(s_key[i] & ((1ull << kIdBits) - 1));
    s_order[i] = v;
    s_rank[v] = i;
    s_deg[i] = 0;
  }
  if (tid == 0) {
    a.cyclic[w] = (uint8_t)cyc;
    if (a.ovf) a.ovf[w] |= cyc;
  }
  __syncthreads();

  if (!a.charsr) {                                   // order mode
    for (int i = tid; i < n; i += T) {
      a.order[(size_t)w * n + i] = s_order[i];
      a.rank[(size_t)w * n + i] = s_rank[i];
    }
    return;
  }
  // out-degrees of the active nodes' pred slots (sinks)
  for (int e = tid; e < nact * kMaxPreds; e += T) {
    const int p = pn[e];
    if (p >= 0) atomicAdd(&s_deg[clampi(p, 0, n - 1)], 1);
  }
  __syncthreads();
  const size_t row0 = (size_t)w * n;
  for (int i = tid; i < n; i += T) {
    const int v = s_order[i];
    a.charsr[row0 + i] = a.ch[row0 + v];
    a.gminr[row0 + i] = s_gm[v];
    a.sinksr[row0 + i] = s_deg[v] == 0;
    const int4* row = reinterpret_cast<const int4*>(pn + (size_t)v * kMaxPreds);
    const int4 r0 = row[0], r1 = row[1];
    int p[kMaxPreds] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int s = 0; s < kMaxPreds; ++s)
      p[s] = p[s] >= 0 ? s_rank[clampi(p[s], 0, n - 1)] : -1;
#pragma unroll
    for (int s = 1; s < kMaxPreds; ++s)
      if (p[s] < 0) p[s] = p[0];
    int4* out = reinterpret_cast<int4*>(a.predsp + (row0 + i) * kMaxPreds);
    out[0] = make_int4(p[0], p[1], p[2], p[3]);
    out[1] = make_int4(p[4], p[5], p[6], p[7]);
  }
  const int sl = a.slen[w];
  const size_t l1 = (size_t)a.l_max + 1;
  for (int j = tid; j <= a.l_max; j += T)
    a.seqv[w * l1 + j] = j == 0 ? 255 : a.seq[(size_t)w * a.l_max + j - 1];
  if (tid == 0) {
    a.lb[w] = sl;
    a.nn_eff[w] = sl > 0 ? nnw : 0;
  }
}

}  // namespace

// K6's dynamic shared memory in bytes (ops/poa_fused_kernel.prep_smem_bytes
// mirrors it).
extern "C" int pk_prep_smem_bytes(int ncap) { return prep_smem(ncap); }

// Plain C entry point (bound with ctypes).  With charsr null: order mode
// (order, rank, cyclic); else prep mode (charsr ... gminr, cyclic, and
// ovf |= cyclic when ovf is not null).  pn and predsp 16-byte aligned.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for an ncap
// past the node ids' 16 bits or past a block's shared memory.
extern "C" int pk_prep_launch(const void* pn, const void* gm, const void* nn,
                              const void* ch, const void* seq,
                              const void* slen, void* ovf, void* cyclic,
                              void* order, void* rank, void* charsr,
                              void* sinksr, void* predsp, void* seqv, void* lb,
                              void* nn_eff, void* gminr, int B, int ncap,
                              int l_max, void* stream) {
  if (B <= 0) return 0;
  if (ncap <= 0 || ncap > (1 << kIdBits)) return (int)cudaErrorInvalidValue;
  const int smem = prep_smem(ncap);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  PrepArgs a;
  a.pn = (const int32_t*)pn;
  a.gm = (const int32_t*)gm;
  a.nn = (const int32_t*)nn;
  a.ch = (const int32_t*)ch;
  a.seq = (const int32_t*)seq;
  a.slen = (const int32_t*)slen;
  a.ovf = (int32_t*)ovf;
  a.cyclic = (uint8_t*)cyclic;
  a.order = (int64_t*)order;
  a.rank = (int64_t*)rank;
  a.charsr = (int32_t*)charsr;
  a.sinksr = (int32_t*)sinksr;
  a.predsp = (int32_t*)predsp;
  a.seqv = (int32_t*)seqv;
  a.lb = (int32_t*)lb;
  a.nn_eff = (int32_t*)nn_eff;
  a.gminr = (int32_t*)gminr;
  a.B = B;
  a.ncap = ncap;
  a.l_max = l_max;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pk_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  pk_prep_kernel<<<B, prep_threads(ncap), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
