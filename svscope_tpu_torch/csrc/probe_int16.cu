// int16 op probe on Hopper: one small kernel per int16 op that a packed
// int16 K1 would use, each checked against a plain torch version and timed.
//
// Replaces tools/probe/int16_mosaic_probe.py::main (its Pallas kernels,
// make_kernel), the TPU probe of the compiler's int16 vector support.  The
// five ops of that probe, on (rows, 128) int16 arrays:
//
//   eq16        where(x == y, x, y)
//   le16        where(x <= y, x, y)
//   max16       max(x, y)
//   roll16      x rolled by one column along each row of 128
//   where_i32m  where(col >= 3, x, y), the mask born from an int32 index
//
// and the packed s16x2 SIMD and DPX intrinsics that a K1-int16 holding two
// columns per 32-bit register would use, on the same arrays read as pairs
// of neighbouring int16:
//
//   vmaxs2          __vmaxs2(x, y)               per-halfword max
//   vimax3_s16x2    __vimax3_s16x2(x, y, z)      per-halfword 3-way max (DPX)
//   viaddmax_s16x2  __viaddmax_s16x2(x, y, z)    per-halfword max(x + y, z)
//                                                (DPX)
//
// What bounds it: device-memory bytes; each op reads one to three arrays
// and writes one, with one to three integer ops per element.  eq16's
// select gives y whichever way the compare goes, so the compiler drops the
// load of x; where_i32m takes each element from x or from y, never both,
// so y is loaded only in the int4 that holds columns 0-2.  Every access is
// 16 bytes: each thread loads one int4 of each input it needs (eight
// int16, or four s16x2 words) and stores one int4, neighbouring threads on
// neighbouring words, in one pass over the arrays (a block of 256 threads
// per 4 KB of each array; a capped grid striding over them ran slower on
// the H100).  A row of `width` int16 (a multiple of 8) is
// width/8 int4: the thread's position p in its row (a 32-bit remainder)
// gives where_i32m's columns p*8 ... p*8+7.  roll16 takes element c-1 of
// its row (the row's last for c = 0): the last element of the thread's
// left neighbour in the row (for p = 0, of the row's last int4) comes by
// __shfl_sync from the lane holding it; only a row that straddles two
// warps (width/8 not dividing 32) reads it from memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op {
  kEq16 = 0, kLe16 = 1, kMax16 = 2, kRoll16 = 3, kWhereI32m = 4,
  kVmaxs2 = 5, kVimax3 = 6, kViaddmax = 7
};

// one 16-byte access: eight int16, or four s16x2 words
union Vec {
  int4 v;
  int16_t h[8];
  uint32_t w[4];
};

template <int OP>
__global__ void int16_probe_kernel(const int4* __restrict__ x,
                                   const int4* __restrict__ y,
                                   const int4* __restrict__ z,
                                   int4* __restrict__ o, int n_vec,
                                   int vpr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (i - lane >= n_vec) return;           // whole warps past the end
  const bool live = i < n_vec;
  const int p = i % vpr;                   // position in the row, in int4
  Vec a, b, c, r;
  a.v = live ? x[i] : make_int4(0, 0, 0, 0);
  // where_i32m reads y only for columns 0-2, all in the row's first int4
  const bool need_y = OP != kRoll16 && (OP != kWhereI32m || p == 0);
  if (OP != kRoll16) b.v = live && need_y ? y[i] : make_int4(0, 0, 0, 0);
  if (OP == kVimax3 || OP == kViaddmax) c.v = live ? z[i] : b.v;
  if (OP == kRoll16) {
    // the lane holding the left neighbour's int4: lane - 1, or for p = 0
    // the row's last int4, lane + vpr - 1
    const int src = p > 0 ? lane - 1 : lane + vpr - 1;
    const bool in_warp = src >= 0 && src < 32;
    int left = __shfl_sync(0xffffffffu, (int)a.h[7], in_warp ? src : lane);
    if (live && !in_warp) {
      const int16_t* xh = reinterpret_cast<const int16_t*>(x);
      left = xh[(size_t)(p > 0 ? i : i + vpr) * 8 - 1];
    }
    r.h[0] = (int16_t)left;
#pragma unroll
    for (int k = 1; k < 8; ++k) r.h[k] = a.h[k - 1];
  } else if (OP >= kVmaxs2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (OP == kVmaxs2) {
        r.w[k] = __vmaxs2(a.w[k], b.w[k]);
      } else if (OP == kVimax3) {
        r.w[k] = __vimax3_s16x2(a.w[k], b.w[k], c.w[k]);
      } else {
        r.w[k] = __viaddmax_s16x2(a.w[k], b.w[k], c.w[k]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int16_t xv = a.h[k];
      const int16_t yv = b.h[k];
      if (OP == kEq16) {
        r.h[k] = xv == yv ? xv : yv;
      } else if (OP == kLe16) {
        r.h[k] = xv <= yv ? xv : yv;
      } else if (OP == kMax16) {
        r.h[k] = (int16_t)max((int)xv, (int)yv);
      } else {
        const int32_t col = p * 8 + k;     // the mask's int32 index
        r.h[k] = col >= 3 ? xv : yv;
      }
    }
  }
  if (live) o[i] = r.v;
}

constexpr int kThreads = 256;
constexpr long long kMaxVec = (1LL << 31) - kThreads;   // i stays an int

template <int OP>
int launch(const void* x, const void* y, const void* z, void* o, int n_vec,
           int vpr, cudaStream_t s) {
  const int blocks = (n_vec + kThreads - 1) / kThreads;
  int16_probe_kernel<OP><<<blocks, kThreads, 0, s>>>(
      (const int4*)x, (const int4*)y, (const int4*)z, (int4*)o, n_vec, vpr);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  op: 0 eq16, 1 le16, 2 max16,
// 3 roll16, 4 where_i32m, 5 vmaxs2, 6 vimax3_s16x2, 7 viaddmax_s16x2.
// x, y, z, o: n int16 each, rows of `width`, 16-byte aligned; z is read by
// ops 6 and 7 only.  width a positive multiple of 8 and n / 8 below 2^31
// (else cudaErrorInvalidValue).  Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError() of the launch (-1 for an
// unknown op).
extern "C" int int16_probe_launch(const void* x, const void* y,
                                  const void* z, void* o, long long n,
                                  int width, int op, void* stream) {
  if (width <= 0 || width % 8 || n % width || n / 8 > kMaxVec) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  const int nv = (int)(n / 8);
  const int vpr = width / 8;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kEq16: return launch<kEq16>(x, y, z, o, nv, vpr, s);
    case kLe16: return launch<kLe16>(x, y, z, o, nv, vpr, s);
    case kMax16: return launch<kMax16>(x, y, z, o, nv, vpr, s);
    case kRoll16: return launch<kRoll16>(x, y, z, o, nv, vpr, s);
    case kWhereI32m: return launch<kWhereI32m>(x, y, z, o, nv, vpr, s);
    case kVmaxs2: return launch<kVmaxs2>(x, y, z, o, nv, vpr, s);
    case kVimax3: return launch<kVimax3>(x, y, z, o, nv, vpr, s);
    case kViaddmax: return launch<kViaddmax>(x, y, z, o, nv, vpr, s);
    default: return -1;
  }
}
