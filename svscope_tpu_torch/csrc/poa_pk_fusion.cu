// K4 and K5 on Hopper: the fusion half of one round of the fused `pk` MSA
// build — each window's new alignment is fused into its graph state on the
// device (the host algorithm of svscope_tpu/ops/poa.py, entry by entry).
//
//   K4 replaces svscope_tpu/ops/poa_fused_kernel.py::_fusion_kernel_lockstep
//      (fusion_call's default): one thread per window, so a warp fuses 32
//      windows in SIMT lockstep, one alignment entry per window per step.
//   K5 replaces svscope_tpu/ops/poa_fused_kernel.py::_fusion_kernel
//      (SVSCOPE_PK_FUSION=seq): one thread walks its group of 8 windows one
//      after the other, as one TPU grid step did.
//
// Both run the same fusion step (fuse_entry), so they give the same state
// bit for bit; the plain torch version is
// svscope_tpu_torch/ops/poa_fused_kernel.py::fusion_reference.
//
// Graph state, struct of arrays, row ncap-1 the trash row (a node that
// would land there sets the overflow flag):
//   pn, pw, pt (B, ncap, 8)  pred node ids (-1 empty), weights, stamps
//   gc (B, ncap, 5)          per column id: the member node carrying each
//                            base, -1 none
//   ch, gm (B, ncap)         node base code, column id
//   nn, tctr, ovf (B,)       node count, edge stamp counter, overflow flag
// Alignments arrive as K3 left them: right-aligned (B, out_len) rank/seq
// position pairs, the window's entries at ke+1 .. out_len-1.  The TPU
// kernel's roll to the left and its 128-wide blocking were TPU layout.
// A creator writes its whole new row; nothing relies on what a row held
// before (the TPU kernel's mrow_known_base assumed the initial pattern).
//
// What bounds it: each entry is a chain of dependent global reads (the
// column's member, the target row's pred slots) and writes, a few hundred
// entries per window per round; the windows are the only parallelism.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPreds = 8;
constexpr int kAlpha = 5;
constexpr int kGroup = 8;      // K5: windows per thread, in order

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
  int B, ncap, n_max, l_max, out_len;
};

// One alignment entry (rank anv, seq position aspv) of one window.
__device__ __forceinline__ void fuse_entry(
    int anv, int aspv, const int32_t* gminr, const int32_t* seq,
    int32_t* pn, int32_t* pw, int32_t* pt, int32_t* gc, int32_t* ch,
    int32_t* gm, int32_t* path, int trash, int n_max, int l_max, int& nn,
    int& tc, int& ovf, int& prev) {
  if (aspv < 0) return;                       // -1 graph gap, -2 pad
  const int sposc = min(aspv, l_max - 1);
  const int c5 = seq[sposc];
  const bool has_node = anv >= 0;
  int gid = 0;
  int pre = -1;
  if (has_node) {
    gid = gminr[min(anv, n_max - 1)];
    pre = gc[min(max(gid, 0), trash) * kAlpha + c5];
  }
  int cur = pre;
  if (pre < 0) {                              // creates a node
    if (nn >= trash) ovf = 1;
    const int newid = min(nn, trash);
    if (!has_node) gid = newid;
    int32_t* pnr = pn + (size_t)newid * kMaxPreds;
    int32_t* pwr = pw + (size_t)newid * kMaxPreds;
    int32_t* ptr = pt + (size_t)newid * kMaxPreds;
#pragma unroll
    for (int s = 0; s < kMaxPreds; ++s) {
      pnr[s] = -1;
      pwr[s] = 0;
      ptr[s] = 0;
    }
#pragma unroll
    for (int c = 0; c < kAlpha; ++c) {
      gc[(size_t)newid * kAlpha + c] =
          (c == c5 && gid == newid) ? newid : -1;
    }
    ch[newid] = c5;
    gm[newid] = gid;
    if (has_node) {                           // joins an existing column
      gc[(size_t)min(max(gid, 0), trash) * kAlpha + c5] = newid;
    }
    nn = min(nn + 1, trash);
    cur = newid;
  }
  if (prev >= 0) {                            // edge prev -> cur
    const int curc = min(max(cur, 0), trash);
    int32_t* pnr = pn + (size_t)curc * kMaxPreds;
    int eslot = -1;
    int nvalid = 0;
#pragma unroll
    for (int s = 0; s < kMaxPreds; ++s) {
      const int v = pnr[s];
      if (eslot < 0 && v == prev) eslot = s;
      nvalid += v >= 0 ? 1 : 0;
    }
    if (eslot >= 0) {
      pw[(size_t)curc * kMaxPreds + eslot] += 1;
    } else if (nvalid >= kMaxPreds) {
      ovf = 1;
    } else {
      pnr[nvalid] = prev;
      pw[(size_t)curc * kMaxPreds + nvalid] = 1;
      pt[(size_t)curc * kMaxPreds + nvalid] = tc;
      ++tc;
    }
  }
  path[sposc] = cur;
  prev = cur;
}

__device__ void fuse_window(const FuseArgs& a, int w) {
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
  int nn = a.nn[w];
  int tc = a.tctr[w];
  int ovf = a.ovf[w] > 0 ? 1 : 0;
  int prev = -1;
  for (int k = a.ke[w] + 1; k < a.out_len; ++k) {
    fuse_entry(anw[k], asw[k], gminr, seq, pn, pw, pt, gc, ch, gm, path,
               trash, a.n_max, a.l_max, nn, tc, ovf, prev);
  }
  a.nn[w] = nn;
  a.tctr[w] = tc;
  a.ovf[w] = ovf;
}

// K4: thread t of the grid fuses window t.
__global__ void pk_fusion_lockstep_kernel(FuseArgs a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w < a.B) fuse_window(a, w);
}

// K5: thread g fuses windows 8g .. 8g+7 one after the other.
__global__ void pk_fusion_seq_kernel(FuseArgs a) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int w1 = min((g + 1) * kGroup, a.B);
  for (int w = g * kGroup; w < w1; ++w) fuse_window(a, w);
}

}  // namespace

// Plain C entry point (bound with ctypes).  seq != 0 launches K5, else K4.
// Updates the graph state in place, launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launch.
extern "C" int pk_fusion_launch(const void* an, const void* asx,
                                const void* ke, const void* gminr,
                                const void* seqs5, void* pn, void* pw,
                                void* pt, void* gc, void* ch, void* gm,
                                void* nn, void* tctr, void* ovf, void* path,
                                int B, int ncap, int n_max, int l_max,
                                int out_len, int seq, void* stream) {
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
  a.B = B;
  a.ncap = ncap;
  a.n_max = n_max;
  a.l_max = l_max;
  a.out_len = out_len;
  const int threads = 32;
  const cudaStream_t s = (cudaStream_t)stream;
  if (seq) {
    const int groups = (B + kGroup - 1) / kGroup;
    pk_fusion_seq_kernel<<<(groups + threads - 1) / threads, threads, 0, s>>>(
        a);
  } else {
    pk_fusion_lockstep_kernel<<<(B + threads - 1) / threads, threads, 0, s>>>(
        a);
  }
  return (int)cudaGetLastError();
}
