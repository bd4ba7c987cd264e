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
// One block per window, everything in shared memory, in four parts:
//   * setup (the whole block, a dozen barriers): the cross-column edges of
//     the active nodes, (tail column, head column) from the pred rows, go
//     into two lists by counting sort, per head column its blockers and
//     per tail column its heads (duplicates kept: a head's count of
//     unplaced blocker edges is 0 exactly when it has no unplaced blocker,
//     and the range test does not care), each column's first four entries
//     of both also inline (blk4, out4: one 8-byte load); a bitmask of the
//     unplaced column founders and one of the ready founders (count 0);
//   * the Kahn steps (warp 0 alone, __syncwarp only): gstar is the first
//     ready bit of an unplaced column (the word that can hold the lowest
//     one first, else a ballot over 32 mask words at a time); the run is
//     scanned a 32-column word at a time from gstar over the words of
//     unplaced founders, a lane a column, each lane testing JAX's C (every
//     unplaced blocker t of its column g has gstar <= t < g), and a ballot
//     finds the first failure; the columns before it are placed at once,
//     appended to the placement list, and their heads' counts go down
//     (shared atomics), a head whose count reaches 0 turning ready.
//     Testing a column after the run's earlier columns were placed gives
//     JAX's answer: those blockers lie in [gstar, g) anyway, so the words
//     of a step need no barrier between them.  A step costs the words its
//     run spans, not the window.  The loop ends at a step that places
//     nothing, when every column is placed, or at `ncap` steps;
//   * the order, without a sort: the placement list is already in (step,
//     column) order, so a column's first rank is a scan of its member
//     counts over the list, a member's rank within its column the number
//     of its column's members with a smaller id, and the nodes with key
//     BIG (inactive, or in an unplaced column) follow by id (a scan of
//     their flags) — exactly the stable argsort of (step * ncap + column);
//   * the rank-space view: chars, column ids and sinks (out-degree 0,
//     shared atomics) by rank, the pred rows mapped to ranks with empty
//     slots copying slot 0 (16-byte stores, for K3), and the read staged
//     as K3 and the fusion take it.
//
// Two modes: with `charsr` null only the order (order, rank, cyclic) is
// written, as the build's final toposort needs it; otherwise only the
// round's operands and cyclic, and ovf |= cyclic when `ovf` is given.
//
// What bounds it: the Kahn steps, which are dependent (57 a window on
// average, 77 at most, at the bench bucket; 317 and 340 at the heavy
// tier's ncap 3073).  A step is one warp's chain of dependent shared
// loads, ballots and returning shared atomics, about 1,500 cycles on the
// H100 (tools/glue_split.py: the gstar search ~270, the blocker tests of
// its words ~520-550, their placement with the heads' counts ~580-610,
// ~90 to close it), with no block barrier; setup, order and rank-space
// writes take 10-25 us together.  Bytes and operations are far below
// that.  Windows run in parallel, a block each.
#include <cstdint>
#include <cuda_runtime.h>

// A named namespace, not an anonymous one: a profiler's trace names a
// kernel by its demangled name, which would begin "(anonymous
// namespace)::" and so read as no name where the name is cut at its first
// parenthesis.
namespace pk_prep {

constexpr int kMaxPreds = 8;
constexpr int kIdBits = 16;                 // node ids below 2^16
constexpr int kThreads = 512;
constexpr int kSmemMax = 232448;            // a block's shared memory (H100)
constexpr unsigned kFull = 0xffffffffu;

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
  long long* split;      // (B, kSplitParts), -DPK_GLUE_SPLIT builds only
  int B, ncap, l_max;
};

// clock64() cycles of thread 0 per part (setup, Kahn steps, order, the
// rank-space view or the order's write), then the Kahn steps' own parts
// (the gstar search, a word's blocker test, its placement, closing the
// step), in a build with -DPK_GLUE_SPLIT (tools/glue_split.py); a part
// ends at the barrier that closes it.
constexpr int kSplitParts = 8;
#ifdef PK_GLUE_SPLIT
#define SPLIT_BEGIN long long split_acc[kSplitParts] = {}; \
  long long split_t = clock64();
#define SPLIT(k) if (tid == 0) { const long long t_ = clock64(); \
  split_acc[k] += t_ - split_t; split_t = t_; }
#define SPLIT_END if (tid == 0 && a.split) \
  for (int k_ = 0; k_ < kSplitParts; ++k_) \
  a.split[(size_t)w * kSplitParts + k_] = split_acc[k_];
#define SPLIT_ACC split_acc
#define STEP_SPLIT_BEGIN long long step_t = clock64();
#define STEP_SPLIT(k) if (lane == 0) { const long long t_ = clock64(); \
  acc[k] += t_ - step_t; step_t = t_; }
#else
#define SPLIT_BEGIN
#define SPLIT(k)
#define SPLIT_END
#define SPLIT_ACC nullptr
#define STEP_SPLIT_BEGIN
#define STEP_SPLIT(k)
#endif

// Dynamic shared memory of one window's block: per column its first four
// blockers and first four heads (4 x uint16 each), then gm, the blocker and
// head list offsets, the blocker counts and the placement list (int32
// each), the unplaced and ready masks (a bit a column), the blocker and
// head lists (uint16, 8 a node; after the loop they hold five int32 arrays
// of the order part), then the placed flags.
__host__ __device__ inline int prep_smem(int ncap) {
  const int words = (ncap + 31) / 32;
  return 16 * ncap + 4 * (5 * ncap + 2) + 8 * words +
         4 * kMaxPreds * ncap + ((ncap + 15) & ~15);
}

// The four uint16 fields of a list head packed in a uint2.
__device__ inline int field4(uint2 q, int j) {
  const unsigned x = j < 2 ? q.x : q.y;
  return (j & 1) ? (int)(x >> 16) : (int)(x & 0xffffu);
}

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Sum of v over the block, returned to every thread.  The first barrier
// frees `red` from the previous reduction's readers.
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
  return __reduce_add_sync(kFull, v);
}

// Exclusive scan of a[0, m) in place (a thread a contiguous slice);
// returns the total to every thread.  Starts and ends with a barrier.
__device__ int block_scan(int* a, int m, int* red) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = T >> 5;
  const int per = (m + T - 1) / T;
  const int lo = min(tid * per, m), hi = min(lo + per, m);
  __syncthreads();
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int r = lane < nwarp ? red[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, r, o);
      if (lane >= o) r += y;
    }
    red[lane] = r;
  }
  __syncthreads();
  int base = (warp ? red[warp - 1] : 0) + x - s;
  const int total = red[nwarp - 1];
  for (int i = lo; i < hi; ++i) {
    const int t = a[i];
    a[i] = base;
    base += t;
  }
  __syncthreads();
  return total;
}

// The Kahn steps of one window, run by one warp.  Returns the number of
// columns left unplaced; `plist` gets the placed columns in (step, column)
// order and *npl their count; `acc`, in a -DPK_GLUE_SPLIT build, gets
// lane 0's cycles per part of the steps.  A step is a short chain of
// dependent warp operations: a column's count and first four blockers and
// heads come in one load each (blk4, out4; the lists' rest only past
// four), a head whose count of unplaced blocker edges reaches 0 turns
// ready (the atomic's return says so), a ready bit may stay set on a
// placed column (pend masks it), and the step's words need no barrier
// between them: a count or a placed flag read before another lane's
// update of this step only makes a column test its blockers, and those
// placed in this step lie in [gstar, g) anyway.
__device__ int kahn_steps(int n, int remaining, const int32_t* hoff,
                          const int32_t* toff, int32_t* cnt, int32_t* plist,
                          uint32_t* pend, uint32_t* ready,
                          const uint16_t* blk, const uint16_t* outh,
                          const uint2* blk4, const uint2* out4,
                          uint8_t* placed, int* npl_out, long long* acc) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  STEP_SPLIT_BEGIN
  const int nw = (n + 31) >> 5;
  int npl = 0;
  int rlo = 0;                              // no ready bit below word rlo
  for (int it = 0; it < n && remaining > 0; ++it) {
    // gstar: the first ready bit of an unplaced column, word rlo first
    int gw = -1;
    uint32_t gp = rlo < nw ? pend[rlo] : 0u;
    uint32_t gx = rlo < nw ? ready[rlo] & gp : 0u;
    if (gx) {
      gw = rlo;
    } else {
      for (int wb = rlo + 1; wb < nw; wb += 32) {
        const int wi = wb + lane;
        const uint32_t y = wi < nw ? pend[wi] : 0u;
        const uint32_t x = wi < nw ? ready[wi] & y : 0u;
        const unsigned nz = __ballot_sync(kFull, x != 0);
        if (nz) {
          const int src = __ffs(nz) - 1;
          gx = __shfl_sync(kFull, x, src);
          gp = __shfl_sync(kFull, y, src);
          gw = wb + src;
          break;
        }
      }
    }
    if (gw < 0) break;                      // nothing ready: places nothing
    const int gstar = gw * 32 + __ffs(gx) - 1;
    STEP_SPLIT(4)
    rlo = gw;
    int newmin = nw;                        // lowest word readied here
    int placed_now = 0;
    int wi = gw;
    uint32_t word = gp & (~0u << (gstar & 31));
    for (;;) {
      if (!word) {                          // the next word holding an
        int found = -1;                     // unplaced column
        for (int wb = wi + 1; wb < nw; wb += 32) {
          const int wj = wb + lane;
          const uint32_t x = wj < nw ? pend[wj] : 0u;
          const unsigned nz = __ballot_sync(kFull, x != 0);
          if (nz) {
            const int src = __ffs(nz) - 1;
            word = __shfl_sync(kFull, x, src);
            found = wb + src;
            break;
          }
        }
        if (found < 0) break;               // no unplaced column past here
        wi = found;
      }
      const int col = wi * 32 + lane;
      const bool act = (word >> lane) & 1u;
      bool ok = true;
      uint2 o4 = make_uint2(0, 0);
      int t0 = 0, t1 = 0;
      if (act) {                            // JAX's C over the blockers
        const int c = cnt[col];
        const uint2 b4 = blk4[col];
        const int e0 = hoff[col], e1 = hoff[col + 1];
        o4 = out4[col];
        t0 = toff[col];
        t1 = toff[col + 1];
        if (c > 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = field4(b4, j);
            ok &= placed[t] || (t >= gstar && t < col);
          }
          for (int k = e0 + 4; k < e1 && ok; ++k) {
            const int t = blk[k];
            ok = placed[t] || (t >= gstar && t < col);
          }
        }
      }
      const unsigned bad = __ballot_sync(kFull, act && !ok);
      const uint32_t take =
          bad ? word & ((1u << (__ffs(bad) - 1)) - 1u) : word;
      const bool mine = (take >> lane) & 1u;
      STEP_SPLIT(5)
      if (mine) {                           // place; the heads' blocker
        placed[col] = 1;                    // counts, a head that reaches
        plist[npl + __popc(take & below)] = col;   // 0 made ready
        const int nh = t1 - t0;
        int left[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          left[j] = j < nh ? atomicSub(&cnt[field4(o4, j)], 1) : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = field4(o4, j);
          if (left[j] == 1) {
            atomicOr(&ready[h >> 5], 1u << (h & 31));
            newmin = min(newmin, h >> 5);
          }
        }
        for (int k = t0 + 4; k < t1; ++k) {
          const int h = outh[k];
          if (atomicSub(&cnt[h], 1) == 1) {
            atomicOr(&ready[h >> 5], 1u << (h & 31));
            newmin = min(newmin, h >> 5);
          }
        }
      }
      if (lane == 0) atomicAnd(&pend[wi], ~take);
      npl += __popc(take);
      placed_now += __popc(take);
      STEP_SPLIT(6)
      if (bad) break;
      ++wi;
      word = wi < nw ? pend[wi] : 0u;
    }
    __syncwarp();
    rlo = min(rlo, __reduce_min_sync(kFull, newmin));
    remaining -= placed_now;
    STEP_SPLIT(7)
    if (placed_now == 0) break;
  }
  *npl_out = npl;
  return remaining;
}

__global__ void __launch_bounds__(kThreads) pk_prep_kernel(PrepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[32];
  __shared__ int s_left, s_npl;
  const int n = a.ncap;
  const int w = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nw = (n + 31) >> 5;
  uint2* s_blk4 = reinterpret_cast<uint2*>(smem);   // first four blockers
  uint2* s_out4 = s_blk4 + n;                       // first four heads
  int32_t* s_gm = reinterpret_cast<int32_t*>(s_out4 + n);
  int32_t* s_hoff = s_gm + n;              // blocker list offsets (n + 1)
  int32_t* s_toff = s_hoff + n + 1;        // head list offsets (n + 1)
  int32_t* s_cnt = s_toff + n + 1;         // unplaced blocker edges
  int32_t* s_plist = s_cnt + n;            // placed columns, in order
  uint32_t* s_pend = reinterpret_cast<uint32_t*>(s_plist + n);
  uint32_t* s_ready = s_pend + nw;
  uint16_t* s_blk = reinterpret_cast<uint16_t*>(s_ready + nw);
  uint16_t* s_outh = s_blk + kMaxPreds * n;
  uint8_t* s_placed = reinterpret_cast<uint8_t*>(s_outh + kMaxPreds * n);

  const int32_t* pn = a.pn + (size_t)w * n * kMaxPreds;
  const int nnw = a.nn[w];
  const int nact = clampi(nnw, 0, n);      // active nodes: ids < nn
  SPLIT_BEGIN

  // ---- setup: the edge lists by counting sort ----
  for (int v = tid; v <= n; v += T) {
    if (v < n) {
      s_gm[v] = clampi(a.gm[(size_t)w * n + v], 0, n - 1);
      s_placed[v] = 0;
      s_plist[v] = 0;                      // tail fill cursor for now
    }
    s_hoff[v] = 0;
    s_toff[v] = 0;
  }
  __syncthreads();
  for (int e = tid; e < nact * kMaxPreds; e += T) {
    const int p = pn[e];
    if (p < 0) continue;
    const int t = s_gm[clampi(p, 0, n - 1)], h = s_gm[e / kMaxPreds];
    if (t != h) {
      atomicAdd(&s_hoff[h], 1);
      atomicAdd(&s_toff[t], 1);
    }
  }
  for (int v = tid; v < n; v += T) s_cnt[v] = 0;
  block_scan(s_hoff, n + 1, red);
  block_scan(s_toff, n + 1, red);
  for (int e = tid; e < nact * kMaxPreds; e += T) {
    const int p = pn[e];
    if (p < 0) continue;
    const int t = s_gm[clampi(p, 0, n - 1)], h = s_gm[e / kMaxPreds];
    if (t != h) {
      s_blk[s_hoff[h] + atomicAdd(&s_cnt[h], 1)] = (uint16_t)t;
      s_outh[s_toff[t] + atomicAdd(&s_plist[t], 1)] = (uint16_t)h;
    }
  }
  __syncthreads();
  // each column's first four blockers and heads (the last one repeated)
  for (int v = tid; v < n; v += T) {
    uint16_t q[8];
    const int e0 = s_hoff[v], eb = s_hoff[v + 1] - 1;
    const int f0 = s_toff[v], fb = s_toff[v + 1] - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q[j] = eb >= e0 ? s_blk[min(e0 + j, eb)] : 0;
      q[4 + j] = fb >= f0 ? s_outh[min(f0 + j, fb)] : 0;
    }
    s_blk4[v] = make_uint2(q[0] | (q[1] << 16), q[2] | (q[3] << 16));
    s_out4[v] = make_uint2(q[4] | (q[5] << 16), q[6] | (q[7] << 16));
  }
  // the founder masks: unplaced (all of them) and ready (no blocker)
  int founders = 0;
  for (int base = warp * 32; base < nw * 32; base += T) {
    const int g = base + lane;
    const bool f = g < nact && s_gm[g] == g;
    const unsigned fb = __ballot_sync(kFull, f);
    const unsigned rb = __ballot_sync(kFull, f && s_cnt[g] == 0);
    if (lane == 0) {
      s_pend[base >> 5] = fb;
      s_ready[base >> 5] = rb;
    }
    founders += lane == 0 ? __popc(fb) : 0;
  }
  founders = block_sum(founders, red);
  SPLIT(0)

  // ---- the Kahn steps: warp 0 ----
  if (warp == 0) {
    int npl;
    const int left = kahn_steps(n, founders, s_hoff, s_toff, s_cnt, s_plist,
                                s_pend, s_ready, s_blk, s_outh, s_blk4,
                                s_out4, s_placed, &npl, SPLIT_ACC);
    if (lane == 0) {
      s_left = left;
      s_npl = npl;
    }
  }
  __syncthreads();
  SPLIT(1)
  const int cyc = s_left > 0;
  const int npl = s_npl;

  // ---- the order: placed columns' members, then BIG keys by id ----
  int32_t* s_big = reinterpret_cast<int32_t*>(s_blk);   // BIG nodes before
  int32_t* s_scr = s_big + n;              // members, column by column
  int32_t* s_order = s_scr + n;
  int32_t* s_rank = s_order + n;
  int32_t* s_deg = s_rank + n;
  int32_t* s_mcnt = s_cnt;                 // members of each column
  int32_t* s_cstart = s_hoff;              // a column's first rank
  int32_t* s_tmp = s_toff;                 // member counts in list order
  for (int v = tid; v < n; v += T) s_mcnt[v] = 0;
  __syncthreads();
  for (int v = tid; v < n; v += T) {
    const int g = s_gm[v];
    const bool keyed = v < nact && s_placed[g];
    s_big[v] = !keyed;
    if (keyed) atomicAdd(&s_mcnt[g], 1);
  }
  __syncthreads();
  for (int i = tid; i < npl; i += T) s_tmp[i] = s_mcnt[s_plist[i]];
  const int nkeyed = block_scan(s_tmp, npl, red);
  for (int i = tid; i < npl; i += T) s_cstart[s_plist[i]] = s_tmp[i];
  block_scan(s_big, n, red);
  for (int v = tid; v < n; v += T) s_tmp[v] = 0;      // member fill
  __syncthreads();
  for (int v = tid; v < n; v += T) {
    const int g = s_gm[v];
    if (v < nact && s_placed[g])
      s_scr[s_cstart[g] + atomicAdd(&s_tmp[g], 1)] = v;
  }
  __syncthreads();
  for (int v = tid; v < n; v += T) {
    const int g = s_gm[v];
    int pos;
    if (v < nact && s_placed[g]) {
      const int c0 = s_cstart[g], c1 = c0 + s_mcnt[g];
      pos = c0;
      for (int k = c0; k < c1; ++k) pos += s_scr[k] < v;
    } else {
      pos = nkeyed + s_big[v];
    }
    s_order[pos] = v;
    s_rank[v] = pos;
    s_deg[v] = 0;
  }
  if (tid == 0) {
    a.cyclic[w] = (uint8_t)cyc;
    if (a.ovf) a.ovf[w] |= cyc;
  }
  __syncthreads();
  SPLIT(2)

  if (!a.charsr) {                                   // order mode
    for (int i = tid; i < n; i += T) {
      a.order[(size_t)w * n + i] = s_order[i];
      a.rank[(size_t)w * n + i] = s_rank[i];
    }
    SPLIT(3)
    SPLIT_END
    return;
  }
  // ---- the rank-space view ----
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
    a.gminr[row0 + i] = a.gm[row0 + v];
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
  SPLIT(3)
  SPLIT_END
}

}  // namespace pk_prep

using namespace pk_prep;

// K6's dynamic shared memory in bytes (ops/poa_fused_kernel.prep_smem_bytes
// mirrors it).
extern "C" int pk_prep_smem_bytes(int ncap) { return prep_smem(ncap); }

// One K6 launch; `split` null but in a -DPK_GLUE_SPLIT build.
static int prep_launch(const void* pn, const void* gm, const void* nn,
                       const void* ch, const void* seq, const void* slen,
                       void* ovf, void* cyclic, void* order, void* rank,
                       void* charsr, void* sinksr, void* predsp, void* seqv,
                       void* lb, void* nn_eff, void* gminr, void* split,
                       int B, int ncap, int l_max, void* stream) {
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
  a.split = (long long*)split;
  a.B = B;
  a.ncap = ncap;
  a.l_max = l_max;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pk_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  pk_prep_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

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
  return prep_launch(pn, gm, nn, ch, seq, slen, ovf, cyclic, order, rank,
                     charsr, sinksr, predsp, seqv, lb, nn_eff, gminr, nullptr,
                     B, ncap, l_max, stream);
}

#ifdef PK_GLUE_SPLIT
// K6 with the clock64() split written to `split` (B, kSplitParts).
extern "C" int pk_prep_split_launch(
    const void* pn, const void* gm, const void* nn, const void* ch,
    const void* seq, const void* slen, void* ovf, void* cyclic, void* order,
    void* rank, void* charsr, void* sinksr, void* predsp, void* seqv,
    void* lb, void* nn_eff, void* gminr, int B, int ncap, int l_max,
    void* split, void* stream) {
  return prep_launch(pn, gm, nn, ch, seq, slen, ovf, cyclic, order, rank,
                     charsr, sinksr, predsp, seqv, lb, nn_eff, gminr, split,
                     B, ncap, l_max, stream);
}
#endif
