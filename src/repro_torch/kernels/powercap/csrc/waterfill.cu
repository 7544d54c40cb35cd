// K1: dense weighted max-min waterfill over (S, H, J) slot columns.
//
// Replaces the TPU kernel waterfill_call / waterfill_kernel in
// src/repro/kernels/powercap/kernel.py:48 (body :39).
//
// Bound on an H100: fp64 operations.  Every trip of the bisection touches
// every slot (a multiply, a max, a min and an add), and the trips are a
// fixed count, so at the main path's shapes (J = 10, 100 trips) the
// operations outweigh the bytes (each input is read once) about tenfold.
// Design: one warp per (cell, host) row, the row's slots in registers
// (slot j in lane j % 32), sums and the bracket's max as fp64 warp
// shuffles, no shared memory and no atomics; rows are independent, so the
// grid is simply rows / 8 blocks of 8 warps.
#include "waterfill.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <int K>
__global__ void __launch_bounds__(kThreads) waterfill_kernel(
    const double* __restrict__ cap, const double* __restrict__ fl,
    const double* __restrict__ ce, const double* __restrict__ w,
    const unsigned char* __restrict__ act, double* __restrict__ out,
    long long rows, int J, int iters) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const long long base = row * J;
  double x[K];
  powercap::waterfill_row<K>(cap[row], fl + base, ce + base, w + base,
                             act + base, J, iters, x);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < J) out[base + j] = x[k];
  }
}

template <int K>
void launch(const void* cap, const void* fl, const void* ce, const void* w,
            const void* act, void* out, long long rows, int J, int iters,
            cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  waterfill_kernel<K><<<grid, kThreads, 0, stream>>>(
      static_cast<const double*>(cap), static_cast<const double*>(fl),
      static_cast<const double*>(ce), static_cast<const double*>(w),
      static_cast<const unsigned char*>(act), static_cast<double*>(out),
      rows, J, iters);
}

}  // namespace

extern "C" int powercap_waterfill(const void* cap, const void* fl,
                                  const void* ce, const void* w,
                                  const void* act, void* out, long long rows,
                                  int J, int iters, void* stream) {
  if (rows <= 0 || J <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (powercap::slots_per_lane(J)) {
    case 1: launch<1>(cap, fl, ce, w, act, out, rows, J, iters, s); break;
    case 2: launch<2>(cap, fl, ce, w, act, out, rows, J, iters, s); break;
    case 4: launch<4>(cap, fl, ce, w, act, out, rows, J, iters, s); break;
    case 8: launch<8>(cap, fl, ce, w, act, out, rows, J, iters, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* powercap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
