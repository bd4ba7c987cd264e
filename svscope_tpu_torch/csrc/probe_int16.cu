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
// of neighbouring int16 (one 32-bit word per thread step):
//
//   vmaxs2          __vmaxs2(x, y)               per-halfword max
//   vimax3_s16x2    __vimax3_s16x2(x, y, z)      per-halfword 3-way max (DPX)
//   viaddmax_s16x2  __viaddmax_s16x2(x, y, z)    per-halfword max(x + y, z)
//                                                (DPX)
//
// One thread per element (per word for the packed ops), grid-stride.
// What bounds it: device-memory bytes; each op reads two or three arrays
// and writes one, with one to three integer ops per element.  The probe's
// timings at a large size are that rate, so a later K1-int16 with packed
// pairs can be weighed against them; the design stays a plain elementwise
// kernel for that reason.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op {
  kEq16 = 0, kLe16 = 1, kMax16 = 2, kRoll16 = 3, kWhereI32m = 4,
  kVmaxs2 = 5, kVimax3 = 6, kViaddmax = 7
};

template <int OP>
__global__ void int16_probe_kernel(const int16_t* __restrict__ x,
                                   const int16_t* __restrict__ y,
                                   const int16_t* __restrict__ z,
                                   int16_t* __restrict__ o, long long n,
                                   int width) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (OP >= kVmaxs2) {                    // packed pairs, one word per step
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
    const uint32_t* yw = reinterpret_cast<const uint32_t*>(y);
    const uint32_t* zw = reinterpret_cast<const uint32_t*>(z);
    uint32_t* ow = reinterpret_cast<uint32_t*>(o);
    for (; i < n / 2; i += stride) {
      if (OP == kVmaxs2) {
        ow[i] = __vmaxs2(xw[i], yw[i]);
      } else if (OP == kVimax3) {
        ow[i] = __vimax3_s16x2(xw[i], yw[i], zw[i]);
      } else {
        ow[i] = __viaddmax_s16x2(xw[i], yw[i], zw[i]);
      }
    }
    return;
  }
  for (; i < n; i += stride) {
    const int col = (int)(i % width);
    if (OP == kEq16) {
      o[i] = x[i] == y[i] ? x[i] : y[i];
    } else if (OP == kLe16) {
      o[i] = x[i] <= y[i] ? x[i] : y[i];
    } else if (OP == kMax16) {
      o[i] = (int16_t)max((int)x[i], (int)y[i]);
    } else if (OP == kRoll16) {
      o[i] = x[i - col + (col + width - 1) % width];
    } else {
      const int32_t j = col;               // the mask's int32 index
      o[i] = j >= 3 ? x[i] : y[i];
    }
  }
}

constexpr long long kMaxBlocks = 132 * 16;   // 16 CTAs of 256 per SM

template <int OP>
int launch(const void* x, const void* y, const void* z, void* o,
           long long n, int width, cudaStream_t s) {
  const int threads = 256;
  const long long work = OP >= kVmaxs2 ? n / 2 : n;
  const long long want = (work + threads - 1) / threads;
  const int blocks = (int)(want < kMaxBlocks ? (want > 0 ? want : 1)
                                             : kMaxBlocks);
  int16_probe_kernel<OP><<<blocks, threads, 0, s>>>(
      (const int16_t*)x, (const int16_t*)y, (const int16_t*)z, (int16_t*)o,
      n, width);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  op: 0 eq16, 1 le16, 2 max16,
// 3 roll16, 4 where_i32m, 5 vmaxs2, 6 vimax3_s16x2, 7 viaddmax_s16x2.
// x, y, z, o: n int16 each, rows of `width`; z is read by ops 6 and 7 only;
// n even and the arrays 4-byte aligned for the packed ops.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch (-1 for an unknown op).
extern "C" int int16_probe_launch(const void* x, const void* y,
                                  const void* z, void* o, long long n,
                                  int width, int op, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kEq16: return launch<kEq16>(x, y, z, o, n, width, s);
    case kLe16: return launch<kLe16>(x, y, z, o, n, width, s);
    case kMax16: return launch<kMax16>(x, y, z, o, n, width, s);
    case kRoll16: return launch<kRoll16>(x, y, z, o, n, width, s);
    case kWhereI32m: return launch<kWhereI32m>(x, y, z, o, n, width, s);
    case kVmaxs2: return launch<kVmaxs2>(x, y, z, o, n, width, s);
    case kVimax3: return launch<kVimax3>(x, y, z, o, n, width, s);
    case kViaddmax: return launch<kViaddmax>(x, y, z, o, n, width, s);
    default: return -1;
  }
}
