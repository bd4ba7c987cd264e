// K4 and K5 on Hopper: the fusion half of one round of the fused `pk` MSA
// build — each window's new alignment is fused into its graph state on the
// device (the host algorithm of svscope_tpu/ops/poa.py, entry by entry).
//
//   K4 replaces svscope_tpu/ops/poa_fused_kernel.py::_fusion_kernel_lockstep
//      (fusion_call's default): one block per window fuses the window's
//      round in a fixed number of parallel phases (below).
//   K5 replaces svscope_tpu/ops/poa_fused_kernel.py::_fusion_kernel
//      (SVSCOPE_PK_FUSION=seq): the serial walk, one warp per window; the
//      warp stages a tile of entries in shared memory, lane 0 walks it.
//
// Both give the serial fusion's state and path bit for bit; the plain torch
// version is svscope_tpu_torch/ops/poa_fused_kernel.py::fusion_reference,
// and tests/torch_fusion_model.py is a torch model of K4's phases.
//
// Graph state, struct of arrays, row ncap-1 the trash row (a node that
// would land there sets the overflow flag):
//   pn, pw, pt (B, ncap, 8)  pred node ids (-1 empty), weights, stamps
//   gc (B, ncap, 5)          per column id: the member node carrying each
//                            base, -1 none
//   ch, gm (B, ncap)         node base code, column id
//   nn, tctr, ovf (B,)       node count, edge stamp counter, overflow flag
// Alignments arrive as K3 left them: right-aligned (B, out_len) rank/seq
// position pairs, the window's entries at ke+1 .. out_len-1.  A creator
// writes its whole new row; nothing relies on what a row held before.
//
// Why a round fuses in parallel.  An entry's read position, base c5, old
// column gid = gminr[rank] and whether it has a node do not depend on the
// state.  Its lookup gc[gid][c5] changes within the round only through a
// join, which writes the key (gid, c5) that a creator found empty; so when
// no two node entries share a key, every lookup equals its round-start
// value.  Then creators are the entries whose lookup is empty, the j-th of
// them gets id nn + j, `cur` is that id or the lookup, `prev` is the cur of
// the last valid entry before (gaps carry it).  With distinct curs each
// entry's edge touches only its own pred row (a creator's row is fresh, so
// its edge lands in slot 0), and a new edge's stamp is tctr plus the new
// edges before it.  A window where that does not hold — two node entries on
// one key, two valid entries on one cur or one read position, a lookup of a
// row at or past nn, a new id reaching the trash row, or overflow already
// set — is detected before anything is written and takes the serial walk
// from its round-start state, on the card, counted (pk_fusion_launch_counted).
//
// What bounds it.  K4: a few dependent round trips to L2 (entries, then
// seq / gminr, then gc; the pred rows) and four block scans, a few
// microseconds for any entry count, plus the launch.  K5: ~2 dependent
// accesses per entry (the gc lookup, then the pred row), entries in order,
// windows in parallel.
#include <cstdint>
#include <cuda_runtime.h>

// A named namespace, not an anonymous one: a profiler's trace names a
// kernel by its demangled name, which would begin "(anonymous
// namespace)::" and so read as no name where the name is cut at its first
// parenthesis.
namespace pk_fusion {

constexpr int kMaxPreds = 8;
constexpr int kAlpha = 5;
constexpr int kFuseThreads = 512;          // K4: threads of a window's block
constexpr int kFuseWarps = kFuseThreads / 32;
constexpr int kSeqWarps = 4;               // K5: windows (warps) per block
constexpr int kSeqTile = 256;              // K5: entries staged per tile
constexpr int kSmemMax = 232448;           // a block's shared memory (H100)

// A staged entry: sp (its read position, -1 for a gap), gid (its rank's old
// column, when it has a node) and a code word: c5 in bits 0-2, a node flag,
// and K4's creator flag, edge kind and slot.
constexpr int kC5Mask = 7;
constexpr int kHasNode = 1 << 3;
constexpr int kCreator = 1 << 4;
constexpr int kKindShift = 5;              // 2 bits
constexpr int kSlotShift = 7;              // 3 bits
constexpr int kEdgeHit = 1;                // the edge exists: weight + 1
constexpr int kEdgeNew = 2;                // a new edge in a free slot
constexpr int kEdgeOvf = 3;                // a new edge, no slot free

struct FuseArgs {
  const int32_t* an;      // (B, out_len)
  const int32_t* asx;     // (B, out_len)
  const int32_t* ke;      // (B,)
  const int32_t* gminr;   // (B, n_max) pre-round column id by rank
  const int32_t* seqs5;   // (B, l_max) base codes 0-4
  int32_t* pn;
  int32_t* pw;
  int32_t* pt;
  int32_t* gc;
  int32_t* ch;
  int32_t* gm;
  int32_t* nn;
  int32_t* tctr;
  int32_t* ovf;
  int32_t* path;          // (B, l_max), -1 on entry
  int32_t* nflag;         // K4: windows that took the serial walk, or null
  int B, ncap, n_max, l_max, out_len;
};

// One window's state rows.
struct Win {
  int32_t* pn;
  int32_t* pw;
  int32_t* pt;
  int32_t* gc;
  int32_t* ch;
  int32_t* gm;
  int32_t* path;
  int trash;
};

__device__ __forceinline__ Win window_of(const FuseArgs& a, int w) {
  const size_t row0 = (size_t)w * a.ncap;
  return Win{a.pn + row0 * kMaxPreds, a.pw + row0 * kMaxPreds,
             a.pt + row0 * kMaxPreds, a.gc + row0 * kAlpha, a.ch + row0,
             a.gm + row0, a.path + (size_t)w * a.l_max, a.ncap - 1};
}

__device__ __forceinline__ int clamp_row(int v, int trash) {
  return min(max(v, 0), trash);
}

// The state-independent part of entry (anv, aspv).
__device__ __forceinline__ void stage_entry(int anv, int aspv,
                                            const int32_t* gminr,
                                            const int32_t* seq, int n_max,
                                            int l_max, int32_t& sp,
                                            int32_t& gid, int32_t& code) {
  if (aspv < 0) {                             // -1 graph gap, -2 pad
    sp = -1;
    gid = 0;
    code = 0;
    return;
  }
  sp = min(aspv, l_max - 1);
  const bool has_node = anv >= 0;
  gid = has_node ? gminr[min(anv, n_max - 1)] : 0;
  code = seq[sp] | (has_node ? kHasNode : 0);
}

// A creator's whole row, its in-edge from eprev (if >= 0) in slot 0.
__device__ __forceinline__ void new_row(const Win& w, int id, int gid, int c5,
                                        int eprev, int stamp) {
  const bool e = eprev >= 0;
  int4* pn4 = reinterpret_cast<int4*>(w.pn + (size_t)id * kMaxPreds);
  int4* pw4 = reinterpret_cast<int4*>(w.pw + (size_t)id * kMaxPreds);
  int4* pt4 = reinterpret_cast<int4*>(w.pt + (size_t)id * kMaxPreds);
  pn4[0] = make_int4(e ? eprev : -1, -1, -1, -1);
  pn4[1] = make_int4(-1, -1, -1, -1);
  pw4[0] = make_int4(e ? 1 : 0, 0, 0, 0);
  pw4[1] = make_int4(0, 0, 0, 0);
  pt4[0] = make_int4(e ? stamp : 0, 0, 0, 0);
  pt4[1] = make_int4(0, 0, 0, 0);
  int32_t* g = w.gc + (size_t)id * kAlpha;
#pragma unroll
  for (int c = 0; c < kAlpha; ++c) g[c] = (c == c5 && gid == id) ? id : -1;
  w.ch[id] = c5;
  w.gm[id] = gid;
}

// Pred row `row` as two 16-byte loads: the first slot holding `prev`
// (-1 none) and the count of filled slots.
__device__ __forceinline__ void scan_preds(const Win& w, int row, int prev,
                                           int& eslot, int& nvalid) {
  const int4* r = reinterpret_cast<const int4*>(w.pn + (size_t)row * kMaxPreds);
  const int4 lo = r[0];
  const int4 hi = r[1];
  const int v[kMaxPreds] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  eslot = -1;
  nvalid = 0;
#pragma unroll
  for (int s = 0; s < kMaxPreds; ++s) {
    if (eslot < 0 && v[s] == prev) eslot = s;
    nvalid += v[s] >= 0 ? 1 : 0;
  }
}

struct Walk {
  int nn, tc, ovf, prev;
};

// The serial fusion step of one staged valid entry (K5, and K4's flagged
// windows): svscope_tpu/ops/poa.py's order, one entry after the other.
__device__ __forceinline__ void walk_entry(int sp, int gid, int code,
                                           const Win& w, Walk& s) {
  const int trash = w.trash;
  const int c5 = code & kC5Mask;
  const bool has_node = code & kHasNode;
  int cur = has_node ? w.gc[clamp_row(gid, trash) * kAlpha + c5] : -1;
  if (cur < 0) {                              // creates a node
    if (s.nn >= trash) s.ovf = 1;
    const int newid = min(s.nn, trash);
    if (!has_node) gid = newid;
    new_row(w, newid, gid, c5, s.prev, s.tc);
    if (s.prev >= 0) ++s.tc;
    if (has_node) w.gc[clamp_row(gid, trash) * kAlpha + c5] = newid;
    s.nn = min(s.nn + 1, trash);
    cur = newid;
  } else if (s.prev >= 0) {                   // edge prev -> cur
    const int curc = clamp_row(cur, trash);
    int eslot, nvalid;
    scan_preds(w, curc, s.prev, eslot, nvalid);
    const size_t base = (size_t)curc * kMaxPreds;
    if (eslot >= 0) {
      w.pw[base + eslot] += 1;
    } else if (nvalid >= kMaxPreds) {
      s.ovf = 1;
    } else {
      w.pn[base + nvalid] = s.prev;
      w.pw[base + nvalid] = 1;
      w.pt[base + nvalid] = s.tc;
      ++s.tc;
    }
  }
  w.path[sp] = cur;
  s.prev = cur;
}

__device__ void walk_staged(const int32_t* sp, const int32_t* gid,
                            const int32_t* code, int n, const Win& w,
                            Walk& s) {
  for (int i = 0; i < n; ++i) {
    if (sp[i] >= 0) walk_entry(sp[i], gid[i], code[i], w, s);
  }
}

__device__ __forceinline__ bool test_and_set(uint32_t* bits, int i) {
  const uint32_t m = 1u << (i & 31);
  return (atomicOr(bits + (i >> 5), m) & m) != 0;
}

// Exclusive scan over K4's block in thread order: `a` by sum (identity 0),
// `b` by max (identity -1).  Returns the block's totals.  Every thread
// calls it; s_a, s_b hold 32 ints.
__device__ __forceinline__ int2 block_scan(int& a, int& b, int* s_a, int* s_b) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int ia = a;
  int ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xa = __shfl_up_sync(0xffffffffu, ia, o);
    const int xb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia += xa;
      ib = max(ib, xb);
    }
  }
  int ea = ia - a;
  int eb = __shfl_up_sync(0xffffffffu, ib, 1);
  if (lane == 0) eb = -1;
  if (lane == 31) {
    s_a[wid] = ia;
    s_b[wid] = ib;
  }
  __syncthreads();
  if (wid == 0) {
    int va = lane < kFuseWarps ? s_a[lane] : 0;
    int vb = lane < kFuseWarps ? s_b[lane] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xa = __shfl_up_sync(0xffffffffu, va, o);
      const int xb = __shfl_up_sync(0xffffffffu, vb, o);
      if (lane >= o) {
        va += xa;
        vb = max(vb, xb);
      }
    }
    s_a[lane] = va;
    s_b[lane] = vb;
  }
  __syncthreads();
  if (wid > 0) {
    ea += s_a[wid - 1];
    eb = max(eb, s_b[wid - 1]);
  }
  const int2 tot = make_int2(s_a[kFuseWarps - 1], s_b[kFuseWarps - 1]);
  __syncthreads();                            // s_a, s_b free again
  a = ea;
  b = eb;
  return tot;
}

// Dynamic shared memory of K4's block: sp, gid, cur and code of out_len
// entries, then bitmaps over the keys (ncap x 5), the curs (ncap) and the
// read positions (l_max).
__host__ __device__ inline int fusion_smem(int ncap, int l_max, int out_len) {
  return 4 * (4 * out_len + (ncap * kAlpha + 31) / 32 + (ncap + 31) / 32 +
              (l_max + 31) / 32);
}

// K4: block w fuses window w.  Phases: 1 stage the entries (coalesced),
// their bases, old columns and lookups, with the key and read-position
// bitmaps; 2 scan the creators for their ids; 3 the curs' bitmap, prev,
// the pred rows of the edges into existing nodes, a scan of the new edges
// for their stamps; then either the serial walk (flagged) or 4 every write.
__global__ void __launch_bounds__(kFuseThreads)
    pk_fusion_parallel_kernel(FuseArgs a) {
  extern __shared__ int4 smem4[];
  __shared__ int s_a[32];
  __shared__ int s_b[32];
  __shared__ int s_flag;
  __shared__ int s_ovfe;
  const int cap = a.out_len;
  int32_t* s_sp = reinterpret_cast<int32_t*>(smem4);
  int32_t* s_gid = s_sp + cap;
  int32_t* s_cur = s_gid + cap;
  int32_t* s_code = s_cur + cap;
  uint32_t* s_keys = reinterpret_cast<uint32_t*>(s_code + cap);
  const int key_words = (a.ncap * kAlpha + 31) / 32;
  uint32_t* s_curs = s_keys + key_words;
  const int cur_words = (a.ncap + 31) / 32;
  uint32_t* s_sps = s_curs + cur_words;
  const int bit_words = key_words + cur_words + (a.l_max + 31) / 32;

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const Win win = window_of(a, w);
  const int trash = win.trash;
  const int32_t* anw = a.an + (size_t)w * a.out_len;
  const int32_t* asw = a.asx + (size_t)w * a.out_len;
  const int32_t* gminr = a.gminr + (size_t)w * a.n_max;
  const int32_t* seq = a.seqs5 + (size_t)w * a.l_max;
  const int nn0 = a.nn[w];
  const int tc0 = a.tctr[w];
  const int ovf0 = a.ovf[w];
  const int k0 = a.ke[w] + 1;
  const int ne = min(max(a.out_len - k0, 0), a.out_len);

  for (int i = tid; i < bit_words; i += kFuseThreads) s_keys[i] = 0;
  if (tid == 0) {
    s_flag = ovf0 > 0 ? 1 : 0;
    s_ovfe = 0;
  }
  __syncthreads();

  // 1. stage: entry e of the window is alignment index k0 + e
  for (int e = tid; e < ne; e += kFuseThreads) {
    int32_t sp, gid, code;
    stage_entry(anw[k0 + e], asw[k0 + e], gminr, seq, a.n_max, a.l_max, sp,
                gid, code);
    int pre = -1;
    if (sp >= 0) {
      if (test_and_set(s_sps, sp)) s_flag = 1;
      if (code & kHasNode) {
        const int row = clamp_row(gid, trash);
        const int key = row * kAlpha + (code & kC5Mask);
        if (row >= nn0 || test_and_set(s_keys, key)) s_flag = 1;
        pre = win.gc[key];
      }
    }
    s_sp[e] = sp;
    s_gid[e] = gid;
    s_cur[e] = pre;
    s_code[e] = code;
  }
  __syncthreads();

  // 2. creators' ids: thread t owns entries c0 .. c1-1, in order
  const int per = (ne + kFuseThreads - 1) / kFuseThreads;
  const int c0 = min(tid * per, ne);
  const int c1 = min(c0 + per, ne);
  int nc = 0;
  int last = -1;                              // last valid entry
  for (int i = c0; i < c1; ++i) {
    if (s_sp[i] < 0) continue;
    last = i;
    nc += s_cur[i] < 0 ? 1 : 0;
  }
  const int n_new = block_scan(nc, last, s_a, s_b).x;
  const int last0 = last;                     // before this thread's entries
  for (int i = c0; i < c1; ++i) {
    if (s_sp[i] >= 0 && s_cur[i] < 0) {
      s_cur[i] = nn0 + nc++;
      s_code[i] |= kCreator;
    }
  }
  if (tid == 0 && n_new > 0 && nn0 + n_new - 1 >= trash) s_flag = 1;
  __syncthreads();

  // 3. distinct curs; each edge classified against its target's pred row
  int nedge = 0;
  last = last0;
  for (int i = c0; i < c1; ++i) {
    if (s_sp[i] < 0) continue;
    const int curc = clamp_row(s_cur[i], trash);
    if (test_and_set(s_curs, curc)) s_flag = 1;
    const int prev = last >= 0 ? s_cur[last] : -1;
    last = i;
    if (prev < 0) continue;
    int kind = kEdgeNew;
    int slot = 0;                             // a creator's row is fresh
    if (!(s_code[i] & kCreator)) {
      int eslot, nvalid;
      scan_preds(win, curc, prev, eslot, nvalid);
      if (eslot >= 0) {
        kind = kEdgeHit;
        slot = eslot;
      } else if (nvalid >= kMaxPreds) {
        kind = kEdgeOvf;
        s_ovfe = 1;
      } else {
        slot = nvalid;
      }
    }
    nedge += kind == kEdgeNew ? 1 : 0;
    s_code[i] |= kind << kKindShift | slot << kSlotShift;
  }
  int unused = -1;
  const int n_edges = block_scan(nedge, unused, s_a, s_b).x;

  if (s_flag) {                               // the serial walk, exact
    if (tid == 0) {
      Walk s{nn0, tc0, ovf0 > 0 ? 1 : 0, -1};
      walk_staged(s_sp, s_gid, s_code, ne, win, s);
      a.nn[w] = s.nn;
      a.tctr[w] = s.tc;
      a.ovf[w] = s.ovf;
      if (a.nflag) atomicAdd(a.nflag, 1);
    }
    return;
  }

  // 4. writes: no two entries touch one row, key or read position
  int stamp = tc0 + nedge;
  last = last0;
  for (int i = c0; i < c1; ++i) {
    const int sp = s_sp[i];
    if (sp < 0) continue;
    const int cur = s_cur[i];
    const int prev = last >= 0 ? s_cur[last] : -1;
    last = i;
    const int code = s_code[i];
    const int kind = (code >> kKindShift) & 3;
    const int slot = (code >> kSlotShift) & 7;
    if (code & kCreator) {
      const int c5 = code & kC5Mask;
      const bool has_node = code & kHasNode;
      const int gid = has_node ? s_gid[i] : cur;
      new_row(win, cur, gid, c5, kind == kEdgeNew ? prev : -1, stamp);
      if (has_node) win.gc[clamp_row(gid, trash) * kAlpha + c5] = cur;
    } else {
      const size_t at = (size_t)clamp_row(cur, trash) * kMaxPreds + slot;
      if (kind == kEdgeHit) {
        atomicAdd(win.pw + at, 1);
      } else if (kind == kEdgeNew) {
        win.pn[at] = prev;
        win.pw[at] = 1;
        win.pt[at] = stamp;
      }
    }
    stamp += kind == kEdgeNew ? 1 : 0;
    win.path[sp] = cur;
  }
  if (tid == 0) {
    a.nn[w] = nn0 + n_new;
    a.tctr[w] = tc0 + n_edges;
    a.ovf[w] = s_ovfe;
  }
}

// K5: warp v of block b fuses window kSeqWarps * b + v, a tile of entries
// at a time: the lanes stage the tile (coalesced), lane 0 walks it.
__global__ void __launch_bounds__(kSeqWarps * 32)
    pk_fusion_serial_kernel(FuseArgs a) {
  __shared__ int32_t s_sp[kSeqWarps][kSeqTile];
  __shared__ int32_t s_gid[kSeqWarps][kSeqTile];
  __shared__ int32_t s_code[kSeqWarps][kSeqTile];
  const int lane = threadIdx.x & 31;
  const int v = threadIdx.x >> 5;
  const int w = blockIdx.x * kSeqWarps + v;
  if (w >= a.B) return;
  const Win win = window_of(a, w);
  const int32_t* anw = a.an + (size_t)w * a.out_len;
  const int32_t* asw = a.asx + (size_t)w * a.out_len;
  const int32_t* gminr = a.gminr + (size_t)w * a.n_max;
  const int32_t* seq = a.seqs5 + (size_t)w * a.l_max;
  const int k0 = a.ke[w] + 1;
  const int ne = min(max(a.out_len - k0, 0), a.out_len);
  Walk s{a.nn[w], a.tctr[w], a.ovf[w] > 0 ? 1 : 0, -1};
  for (int t0 = 0; t0 < ne; t0 += kSeqTile) {
    const int n = min(kSeqTile, ne - t0);
    for (int e = lane; e < n; e += 32) {
      stage_entry(anw[k0 + t0 + e], asw[k0 + t0 + e], gminr, seq, a.n_max,
                  a.l_max, s_sp[v][e], s_gid[v][e], s_code[v][e]);
    }
    __syncwarp();
    if (lane == 0) walk_staged(s_sp[v], s_gid[v], s_code[v], n, win, s);
    __syncwarp();
  }
  if (lane == 0) {
    a.nn[w] = s.nn;
    a.tctr[w] = s.tc;
    a.ovf[w] = s.ovf;
  }
}

}  // namespace pk_fusion

using namespace pk_fusion;

// K4's dynamic shared memory in bytes (ops/poa_fused_kernel.fusion_smem_bytes
// mirrors it).
extern "C" int pk_fusion_smem_bytes(int ncap, int l_max, int out_len) {
  return fusion_smem(ncap, l_max, out_len);
}

// Plain C entry points (bound with ctypes).  seq != 0 launches K5, else K4;
// nflag, when not null, is an int32 on the device to which K4 adds the
// windows that took the serial walk.  Updates the graph state in place
// (pn, pw, pt 16-byte aligned), launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch,
// or cudaErrorInvalidValue when K4's shared memory would not fit a block.
extern "C" int pk_fusion_launch_counted(
    const void* an, const void* asx, const void* ke, const void* gminr,
    const void* seqs5, void* pn, void* pw, void* pt, void* gc, void* ch,
    void* gm, void* nn, void* tctr, void* ovf, void* path, int B, int ncap,
    int n_max, int l_max, int out_len, int seq, void* nflag, void* stream) {
  if (B <= 0) return 0;
  FuseArgs a;
  a.an = (const int32_t*)an;
  a.asx = (const int32_t*)asx;
  a.ke = (const int32_t*)ke;
  a.gminr = (const int32_t*)gminr;
  a.seqs5 = (const int32_t*)seqs5;
  a.pn = (int32_t*)pn;
  a.pw = (int32_t*)pw;
  a.pt = (int32_t*)pt;
  a.gc = (int32_t*)gc;
  a.ch = (int32_t*)ch;
  a.gm = (int32_t*)gm;
  a.nn = (int32_t*)nn;
  a.tctr = (int32_t*)tctr;
  a.ovf = (int32_t*)ovf;
  a.path = (int32_t*)path;
  a.nflag = (int32_t*)nflag;
  a.B = B;
  a.ncap = ncap;
  a.n_max = n_max;
  a.l_max = l_max;
  a.out_len = out_len;
  const cudaStream_t s = (cudaStream_t)stream;
  if (seq) {
    pk_fusion_serial_kernel<<<(B + kSeqWarps - 1) / kSeqWarps, kSeqWarps * 32,
                              0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const int smem = fusion_smem(ncap, l_max, out_len);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pk_fusion_parallel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  pk_fusion_parallel_kernel<<<B, kFuseThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int pk_fusion_launch(const void* an, const void* asx,
                                const void* ke, const void* gminr,
                                const void* seqs5, void* pn, void* pw,
                                void* pt, void* gc, void* ch, void* gm,
                                void* nn, void* tctr, void* ovf, void* path,
                                int B, int ncap, int n_max, int l_max,
                                int out_len, int seq, void* stream) {
  return pk_fusion_launch_counted(an, asx, ke, gminr, seqs5, pn, pw, pt, gc,
                                  ch, gm, nn, tctr, ovf, path, B, ncap, n_max,
                                  l_max, out_len, seq, nullptr, stream);
}
