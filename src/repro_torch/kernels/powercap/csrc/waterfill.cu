// K1: dense weighted max-min waterfill over (S, H, J) slot columns.
//
// Replaces the TPU kernel waterfill_call / waterfill_kernel in
// src/repro/kernels/powercap/kernel.py:48 (body :39).
//
// Bound on an H100: fp64 operations in principle (each bisection trip
// touches every slot: a multiply, a max, a min and an add), but at the main
// paths' shapes (J = 10) latency: every trip waits on a butterfly over the
// row's lanes.  Design: a row of J slots takes G lanes (the next power of
// two at or above J, 4 to 32), so a warp runs 32 / G rows at once; the
// row's slots sit in registers (streamed from memory above 256 slots); the
// bisection stops once its bracket has collapsed and a degenerate row runs
// none (waterfill.cuh), which leaves every result bitwise as it was.  No
// shared memory and no atomics: rows are independent, each read once, and
// the grid is rows / (256 / G) blocks of 256 threads.
#include "waterfill.cuh"

namespace {

constexpr int kThreads = 256;

template <int G, int K>
__global__ void __launch_bounds__(kThreads) waterfill_kernel(
    const double* __restrict__ cap, const double* __restrict__ fl,
    const double* __restrict__ ce, const double* __restrict__ w,
    const unsigned char* __restrict__ act, double* __restrict__ out,
    long long rows, int J, int iters) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (row >= rows) return;  // whole rows leave together
  const long long base = row * J;
  const powercap::DenseSlots slots{fl + base, ce + base, w + base,
                                   act + base};
  powercap::waterfill<G, K>(cap[row], slots, J, iters,
                            [&](int j, double x) { out[base + j] = x; });
}

}  // namespace

extern "C" int powercap_waterfill(const void* cap, const void* fl,
                                  const void* ce, const void* w,
                                  const void* act, void* out, long long rows,
                                  int J, int iters, int device,
                                  void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (rows <= 0 || J <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return powercap::with_row_shape(J, [&](auto shape) {
    using Shape = decltype(shape);
    constexpr int kRowsPerBlock = kThreads / Shape::G;
    const unsigned grid =
        static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
    waterfill_kernel<Shape::G, Shape::K><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(cap), static_cast<const double*>(fl),
        static_cast<const double*>(ce), static_cast<const double*>(w),
        static_cast<const unsigned char*>(act), static_cast<double*>(out),
        rows, J, iters);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* powercap_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
