// Fusion-body probe on Hopper: K4's per-entry cost, split into reads,
// writes and logic.
//
// Replaces tools/probe/fusebody_probe.py::run (its Pallas kernel,
// make_kernel), the TPU probe that ran the pk kernel's fusion body alone on
// graph states replayed from the NumPy oracle at round 13.  Every variant
// computes what the JAX variant computes from the same inputs, the
// stand-in constants of `noread` and `logic` included:
//
//   full        the whole body: reads, the creator's write, the edge write
//   nowrite     every graph-state write dropped (reads + logic)
//   noread      the member and pred-row reads replaced by constants
//               (pre = anc when c5 > 2; has_e = c5 < 3; slot = c5;
//               w_old = tc), the edge write kept
//   logic       no state traffic (rank = k % 700, position = k % 400)
//   empty       a counter-only loop
//   scal16      a counter plus one scalar read of the read per step
//   noveccarry  the counter loop; nn_out gets the step count
//
// The state is the port's struct-of-arrays GraphState (pn, pw, pt, gc, ch,
// gm; ops/poa_fused_kernel.py), as K4 (csrc/poa_pk_fusion.cu) keeps it, so
// the probe prices K4's own memory traffic; it is updated in place.  One
// thread per window, as K4, over the entries k0 .. out_len-1 (the JAX
// probe: the last 480).  The loops of empty, scal16 and noveccarry carry
// their counter through an empty asm statement, so the compiler keeps one
// iteration per step instead of folding the count.
//
// Where `full` differs from K4's fuse_entry: the creator writes only the
// lanes the TPU kernel's masked-lane write touched (ch, gm, and its own
// gchar entry when it starts a column), where fuse_entry writes the whole
// new row (pred slots and every gchar entry); a creator that joins an
// existing column does not write that column's gchar entry; and there is
// no overflow flag (a full pred row only skips the edge).
//
// What bounds it: as K4, one dependent chain of global reads and writes per
// entry per window (the column's member, then the target row's pred
// slots); with 8 windows the card runs one warp, so the time is that
// chain's latency times the entry count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPreds = 8;
constexpr int kAlpha = 5;

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
  int32_t* pn;            // (B, ncap, 8)
  int32_t* pw;
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

template <int V>
__global__ void fusebody_probe_kernel(ProbeArgs a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= a.B) return;
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
  const int trash = a.ncap - 1;
  for (int s = 0; s < a.l_max; ++s) path[s] = V == kNoVecCarry ? 0 : -1;
  int nn = a.nn[w];
  int tc = 0;
  int prev = -1;
  for (int k = a.k0; k < a.out_len; ++k) {
    if (V == kEmpty || V == kNoVecCarry) {
      ++tc;
      asm volatile("" : "+r"(tc));
      continue;
    }
    if (V == kScal16) {
      prev += seq[k % a.l_max];
      ++tc;
      asm volatile("" : "+r"(prev), "+r"(tc));
      continue;
    }
    const int aspv = V == kLogic ? k % 400 : asw[k];
    const int anv = V == kLogic ? k % 700 : anw[k];
    const bool valid = aspv >= 0;
    const int sposc = clampi(aspv, 0, a.l_max - 1);
    const int c5 = seq[sposc];
    const bool has_node = valid && anv >= 0;
    const int anc = clampi(anv, 0, a.n_max - 1);
    const int gid_old = gminr[anc];
    int pre;
    if (V == kNoRead || V == kLogic) {
      pre = has_node && c5 > 2 ? anc : -1;
    } else {
      const int grow = clampi(has_node ? gid_old : 0, 0, trash);
      pre = has_node ? gc[(size_t)grow * kAlpha + c5] : -1;
    }
    const bool creator = valid && pre < 0;
    const int newid = min(nn, trash);
    const int cur = creator ? newid : pre;
    const int gid = has_node ? gid_old : newid;
    if (V == kFull && creator) {            // the masked-lane row write
      ch[newid] = c5;
      gm[newid] = gid;
      if (gid == newid) gc[(size_t)newid * kAlpha + c5] = newid;
    }
    nn = min(nn + (creator ? 1 : 0), trash);
    const bool add_e = valid && prev >= 0;
    const int curc = clampi(cur, 0, trash);
    bool has_e, newe;
    int slot, w_old;
    if (V == kNoRead || V == kLogic) {
      has_e = add_e && c5 < 3;
      slot = clampi(c5, 0, kMaxPreds - 1);
      w_old = tc;
      newe = add_e && !has_e;
    } else {
      const int32_t* pnr = pn + (size_t)curc * kMaxPreds;
      int eslot = kMaxPreds;
      int nvalid = 0;
#pragma unroll
      for (int s = 0; s < kMaxPreds; ++s) {
        const int v = pnr[s];
        if (eslot == kMaxPreds && v == prev) eslot = s;
        nvalid += v >= 0 ? 1 : 0;
      }
      has_e = add_e && eslot < kMaxPreds;
      newe = add_e && !has_e && nvalid < kMaxPreds;
      slot = has_e ? eslot : clampi(nvalid, 0, kMaxPreds - 1);
      w_old = pw[(size_t)curc * kMaxPreds + slot];
    }
    if ((V == kFull || V == kNoRead) && (has_e || newe)) {
      const size_t e = (size_t)curc * kMaxPreds + slot;
      pn[e] = prev;
      pw[e] = has_e ? w_old + 1 : 1;
      if (newe) pt[e] = tc;
    }
    tc += newe ? 1 : 0;
    if (valid) {
      path[sposc] = cur;
      prev = cur;
    }
  }
  a.nn_out[w] = V == kNoVecCarry ? tc : nn;
}

template <int V>
int launch(const ProbeArgs& a, cudaStream_t s) {
  const int threads = 32;
  fusebody_probe_kernel<V><<<(a.B + threads - 1) / threads, threads, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  variant: 0 full, 1 nowrite,
// 2 noread, 3 logic, 4 empty, 5 scal16, 6 noveccarry.  Updates the graph
// state in place, fills path (-1, or 0 for noveccarry) and writes nn_out;
// launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch (-1 for an unknown variant).
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
