// Fusion-body probe on Hopper: the per-entry cost of the serial fusion
// step, split into reads, writes and logic, on the layout K5 runs it (and
// K4 runs it for the windows it cannot fuse in parallel): one warp per
// window, the whole warp staging a tile of entries in shared memory, lane 0
// walking the tile (pk_fusion_serial_kernel in csrc/poa_pk_fusion.cu).
//
// Replaces tools/probe/fusebody_probe.py::run (its Pallas kernel,
// make_kernel), the TPU probe that ran the pk kernel's fusion body alone on
// graph states replayed from the NumPy oracle at round 13.  Every variant
// computes what the JAX variant computes from the same inputs, the
// stand-in constants of `noread` and `logic` included.  How each variant
// maps onto the staged walk:
//
//   full        staging (an, asx coalesced; the clamped read position,
//               seqs5[sposc] and gminr[anc] resolved by the lanes), then
//               lane 0's chain per entry: the live gc[gid][c5] lookup, the
//               pred row pn[cur] as two 16-byte loads with the pw row in the
//               same round trip, then the creator's write and the edge write
//   nowrite     full without the state writes
//   noread      full without the gc, pn and pw reads (pre = anc when c5 > 2;
//               has_e = c5 < 3; slot = c5; w_old = tc); the lanes stage anc
//               in place of gminr[anc], which the constants do not need; the
//               edge writes kept
//   logic       noread's staging and walk on synthetic entries (position
//               k % 400, rank k % 700), no graph-state traffic at all
//   empty       lane 0's counter loop, nothing staged
//   scal16      that loop plus one read a step of a staged tile (the warp
//               stages seqs5[k % l_max], lane 0 adds it up)
//   noveccarry  the counter loop; nn_out gets the step count
//
// The state is the port's struct-of-arrays GraphState (pn, pw, pt, gc, ch,
// gm; ops/poa_fused_kernel.py), as K4 and K5 keep it, updated in place.
// Each window walks its entries k0 .. out_len-1 (the JAX probe: the last
// 480), kTile at a time; an invalid entry (read position < 0) does nothing
// and is skipped, as walk_staged skips it.  The counter loops carry their
// counter through an empty asm statement, so the compiler keeps one
// iteration per step instead of folding the count.  The gc lookup stays
// live (not resolved during staging): walk_entry writes a joined column's
// gchar entry, so K5 reads it live.
//
// Where `full` differs from the serial step (walk_entry of
// csrc/poa_pk_fusion.cu): the creator writes only the lanes the TPU
// kernel's masked-lane write touched (ch, gm, and its own gchar entry when
// it starts a column), where walk_entry writes the whole
// new row (pred slots and every gchar entry); a creator that joins an
// existing column does not write that column's gchar entry; and there is
// no overflow flag (a full pred row only skips the edge).
//
// What bounds it: as the serial walk, one dependent chain a valid entry
// (the lookup, then the pred and weight rows), entries in order, windows
// in parallel; with 8 windows the card runs 8 warps, so the time is that
// chain's latency times the entry count, far above the bytes' bound.
// Each window has a CTA (an SM and its L1) of its own: one warp a block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPreds = 8;
constexpr int kAlpha = 5;
constexpr int kTile = 256;                 // entries staged a tile (kSeqTile)

// A staged entry's code word: c5 in bits 0-2, the node flag.
constexpr int kC5Mask = 7;
constexpr int kHasNode = 1 << 3;

enum Variant {
  kFull = 0, kNoWrite = 1, kNoRead = 2, kLogic = 3, kEmpty = 4, kScal16 = 5,
  kNoVecCarry = 6
};

struct ProbeArgs {
  const int32_t* an;      // (B, out_len) ranks, -1 gap, -2 pad
  const int32_t* asx;     // (B, out_len) read positions
  const int32_t* seqs5;   // (B, l_max) base codes 0-4
  const int32_t* gminr;   // (B, n_max) column id by rank
  const int32_t* nn;      // (B,) node counts
  int32_t* pn;            // (B, ncap, 8), 16-byte aligned
  int32_t* pw;            // (B, ncap, 8), 16-byte aligned
  int32_t* pt;
  int32_t* gc;            // (B, ncap, 5)
  int32_t* ch;            // (B, ncap)
  int32_t* gm;
  int32_t* nn_out;        // (B,)
  int32_t* path;          // (B, l_max)
  int B, ncap, n_max, l_max, out_len, k0;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The state-independent part of entry k (stage_entry of
// csrc/poa_pk_fusion.cu): its clamped read position (-1 invalid), the
// staged id (gminr[anc], or anc for the variants that read no state) and
// its code word.
template <int V>
__device__ __forceinline__ void stage_entry(const ProbeArgs& a,
                                            const int32_t* anw,
                                            const int32_t* asw,
                                            const int32_t* seq,
                                            const int32_t* gminr, int k,
                                            int32_t& sp, int32_t& id,
                                            int32_t& code) {
  const int aspv = V == kLogic ? k % 400 : asw[k];
  const int anv = V == kLogic ? k % 700 : anw[k];
  if (aspv < 0) {
    sp = -1;
    id = 0;
    code = 0;
    return;
  }
  sp = min(aspv, a.l_max - 1);
  const bool has_node = anv >= 0;
  const int anc = clampi(anv, 0, a.n_max - 1);
  id = V == kNoRead || V == kLogic ? anc : (has_node ? gminr[anc] : 0);
  code = seq[sp] | (has_node ? kHasNode : 0);
}

struct Walk {
  int nn, tc, prev;
};

// Lane 0's step for one staged valid entry.
template <int V>
__device__ __forceinline__ void walk_entry(const ProbeArgs& a, int32_t* pn,
                                           int32_t* pw, int32_t* pt,
                                           int32_t* gc, int32_t* ch,
                                           int32_t* gm, int32_t* path,
                                           int sp, int id, int code, Walk& s) {
  constexpr bool kReads = V == kFull || V == kNoWrite;
  const int trash = a.ncap - 1;
  const int c5 = code & kC5Mask;
  const bool has_node = code & kHasNode;
  int pre;
  if (kReads) {
    pre = has_node ? gc[(size_t)clampi(id, 0, trash) * kAlpha + c5] : -1;
  } else {
    pre = has_node && c5 > 2 ? id : -1;
  }
  const bool creator = pre < 0;
  const int newid = min(s.nn, trash);
  const int cur = creator ? newid : pre;
  if (V == kFull && creator) {              // the masked-lane row write
    const int gid = has_node ? id : newid;
    ch[newid] = c5;
    gm[newid] = gid;
    if (gid == newid) gc[(size_t)newid * kAlpha + c5] = newid;
  }
  s.nn = min(s.nn + (creator ? 1 : 0), trash);
  const bool add_e = s.prev >= 0;
  const int curc = clampi(cur, 0, trash);
  bool has_e = false;
  bool newe = false;
  int slot = 0;
  int w_old = 0;
  if (kReads) {
    if (add_e) {
      // the pred row and its weights: four 16-byte loads, one round trip
      const int4* pn4 = reinterpret_cast<const int4*>(
          pn + (size_t)curc * kMaxPreds);
      const int4* pw4 = reinterpret_cast<const int4*>(
          pw + (size_t)curc * kMaxPreds);
      const int4 nlo = pn4[0], nhi = pn4[1];
      const int4 wlo = pw4[0], whi = pw4[1];
      const int v[kMaxPreds] = {nlo.x, nlo.y, nlo.z, nlo.w,
                                nhi.x, nhi.y, nhi.z, nhi.w};
      const int wt[kMaxPreds] = {wlo.x, wlo.y, wlo.z, wlo.w,
                                 whi.x, whi.y, whi.z, whi.w};
      int eslot = kMaxPreds;
      int nvalid = 0;
#pragma unroll
      for (int k = 0; k < kMaxPreds; ++k) {
        if (eslot == kMaxPreds && v[k] == s.prev) eslot = k;
        nvalid += v[k] >= 0 ? 1 : 0;
      }
      has_e = eslot < kMaxPreds;
      newe = !has_e && nvalid < kMaxPreds;
      slot = has_e ? eslot : min(nvalid, kMaxPreds - 1);
#pragma unroll
      for (int k = 0; k < kMaxPreds; ++k) w_old = k == slot ? wt[k] : w_old;
    }
  } else {
    has_e = add_e && c5 < 3;
    slot = min(c5, kMaxPreds - 1);
    w_old = s.tc;
    newe = add_e && !has_e;
  }
  if ((V == kFull || V == kNoRead) && (has_e || newe)) {
    const size_t e = (size_t)curc * kMaxPreds + slot;
    pn[e] = s.prev;
    pw[e] = has_e ? w_old + 1 : 1;
    if (newe) pt[e] = s.tc;
  }
  s.tc += newe ? 1 : 0;
  path[sp] = cur;
  s.prev = cur;
}

template <int V>
__global__ void __launch_bounds__(32) fusebody_probe_kernel(ProbeArgs a) {
  __shared__ int32_t s_sp[kTile], s_id[kTile], s_code[kTile];
  const int lane = threadIdx.x;
  const int w = blockIdx.x;
  const size_t row0 = (size_t)w * a.ncap;
  int32_t* pn = a.pn + row0 * kMaxPreds;
  int32_t* pw = a.pw + row0 * kMaxPreds;
  int32_t* pt = a.pt + row0 * kMaxPreds;
  int32_t* gc = a.gc + row0 * kAlpha;
  int32_t* ch = a.ch + row0;
  int32_t* gm = a.gm + row0;
  const int32_t* anw = a.an + (size_t)w * a.out_len;
  const int32_t* asw = a.asx + (size_t)w * a.out_len;
  const int32_t* gminr = a.gminr + (size_t)w * a.n_max;
  const int32_t* seq = a.seqs5 + (size_t)w * a.l_max;
  int32_t* path = a.path + (size_t)w * a.l_max;
  for (int s = lane; s < a.l_max; s += 32) {
    path[s] = V == kNoVecCarry ? 0 : -1;
  }
  __syncwarp();
  const int nn0 = a.nn[w];
  if (V == kEmpty || V == kNoVecCarry) {
    if (lane == 0) {
      int tc = 0;
      for (int k = a.k0; k < a.out_len; ++k) {
        ++tc;
        asm volatile("" : "+r"(tc));
      }
      a.nn_out[w] = V == kNoVecCarry ? tc : nn0;
    }
    return;
  }
  Walk s{nn0, 0, -1};
  for (int t0 = a.k0; t0 < a.out_len; t0 += kTile) {
    const int n = min(kTile, a.out_len - t0);
    for (int e = lane; e < n; e += 32) {
      if (V == kScal16) {
        s_sp[e] = seq[(t0 + e) % a.l_max];
      } else {
        stage_entry<V>(a, anw, asw, seq, gminr, t0 + e, s_sp[e], s_id[e],
                       s_code[e]);
      }
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        if (V == kScal16) {
          s.prev += s_sp[i];
          ++s.tc;
          asm volatile("" : "+r"(s.prev), "+r"(s.tc));
        } else if (s_sp[i] >= 0) {
          walk_entry<V>(a, pn, pw, pt, gc, ch, gm, path, s_sp[i], s_id[i],
                        s_code[i], s);
        }
      }
    }
    __syncwarp();
  }
  if (lane == 0) a.nn_out[w] = V == kScal16 ? nn0 : s.nn;
}

template <int V>
int launch(const ProbeArgs& a, cudaStream_t s) {
  fusebody_probe_kernel<V><<<a.B, 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  variant: 0 full, 1 nowrite,
// 2 noread, 3 logic, 4 empty, 5 scal16, 6 noveccarry.  Updates the graph
// state in place (pn, pw 16-byte aligned), fills path (-1, or 0 for
// noveccarry) and writes nn_out; launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch
// (-1 for an unknown variant).
extern "C" int fusebody_probe_launch(const void* an, const void* asx,
                                     const void* seqs5, const void* gminr,
                                     const void* nn, void* pn, void* pw,
                                     void* pt, void* gc, void* ch, void* gm,
                                     void* nn_out, void* path, int B,
                                     int ncap, int n_max, int l_max,
                                     int out_len, int k0, int variant,
                                     void* stream) {
  if (B <= 0) return 0;
  ProbeArgs a;
  a.an = (const int32_t*)an;
  a.asx = (const int32_t*)asx;
  a.seqs5 = (const int32_t*)seqs5;
  a.gminr = (const int32_t*)gminr;
  a.nn = (const int32_t*)nn;
  a.pn = (int32_t*)pn;
  a.pw = (int32_t*)pw;
  a.pt = (int32_t*)pt;
  a.gc = (int32_t*)gc;
  a.ch = (int32_t*)ch;
  a.gm = (int32_t*)gm;
  a.nn_out = (int32_t*)nn_out;
  a.path = (int32_t*)path;
  a.B = B;
  a.ncap = ncap;
  a.n_max = n_max;
  a.l_max = l_max;
  a.out_len = out_len;
  a.k0 = k0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kFull: return launch<kFull>(a, s);
    case kNoWrite: return launch<kNoWrite>(a, s);
    case kNoRead: return launch<kNoRead>(a, s);
    case kLogic: return launch<kLogic>(a, s);
    case kEmpty: return launch<kEmpty>(a, s);
    case kScal16: return launch<kScal16>(a, s);
    case kNoVecCarry: return launch<kNoVecCarry>(a, s);
    default: return -1;
  }
}
