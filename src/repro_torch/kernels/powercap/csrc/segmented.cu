// K3: weighted max-min waterfill over a ragged CSR layout of items grouped
// by host (the vector engine's tick delivery and the object plane's
// entitlement sums).
//
// Replaces the TPU kernel segmented_call / segmented_kernel in
// src/repro/kernels/powercap/kernel.py:181 (body :160), together with its
// driver's scatter back to item order (ops.py:pallas_waterfill_segmented,
// :158).
//
// Bound on an H100: fp64 operations, as for K1.  Each bisection trip
// touches every item (a multiply, a max, a min and an add), so at the main
// path's 1000 hosts x 10 items and 200 trips the operations (8e6) outweigh
// the bytes (each input read once, about 0.4 MB) about twofold, and both
// are far below the launch.  Design: the row routine of K1 (waterfill.cuh)
// on each host's row of JB slots: G lanes a host (JB up to 32; 16 at the
// main path, so a warp runs two hosts), the row in registers up to 256
// slots and streamed from memory past that, so a host may hold any number
// of items.  The arithmetic is the dense waterfill's on a row of JB slots.
// Lane j reads item order[start + j] for j < count and nothing else: there
// is no tail padding and no read past a row.  Slots count..JB-1 are masked
// (floor 0, ceiling 0, weight 1e-12) as in the plain version.  The items
// stay in the caller's order and are read and written through the
// permutation, so a call is one launch with no gather or scatter around
// it.  An empty host writes nothing.
#include "waterfill.cuh"

namespace {

constexpr int kThreads = 256;

// Slot j of one host's CSR window: live for j < count.
struct CsrSlots {
  const long long* order;  // CSR position -> item
  const double* fl;
  const double* ce;
  const double* w;
  long long start;
  int count;

  __device__ __forceinline__ void load(int j, double& f, double& c,
                                       double& wt) const {
    if (j < count) {
      const long long i = order[start + j];
      f = fl[i];
      c = ce[i];
      wt = w[i];
    }
  }
};

template <int G, int K>
__global__ void __launch_bounds__(kThreads) segmented_kernel(
    const double* __restrict__ cap, const long long* __restrict__ starts,
    const long long* __restrict__ counts,
    const long long* __restrict__ order, const double* __restrict__ fl,
    const double* __restrict__ ce, const double* __restrict__ w,
    double* __restrict__ out, long long n_segs, int jb, int iters) {
  const long long h =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (h >= n_segs) return;  // whole rows leave together
  const int count = static_cast<int>(counts[h]);
  if (count == 0) return;
  const CsrSlots slots{order, fl, ce, w, starts[h], count};
  powercap::waterfill<G, K>(cap[h], slots, jb, iters, [&](int j, double x) {
    if (j < count) out[order[slots.start + j]] = x;
  });
}

}  // namespace

// Pointer order: capacity (n_segs), starts, counts (n_segs, int64), order
// (n, int64: CSR position -> item), floors, ceilings, weights (n, item
// order), out (n, item order).  jb: the row width.
extern "C" int powercap_waterfill_segmented(
    const void* cap, const void* starts, const void* counts,
    const void* order, const void* fl, const void* ce, const void* w,
    void* out, long long n_segs, int jb, int iters, int device,
    void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n_segs <= 0 || jb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return powercap::with_row_shape(jb, [&](auto shape) {
    using Shape = decltype(shape);
    constexpr int kRowsPerBlock = kThreads / Shape::G;
    const unsigned grid =
        static_cast<unsigned>((n_segs + kRowsPerBlock - 1) / kRowsPerBlock);
    segmented_kernel<Shape::G, Shape::K><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(cap),
        static_cast<const long long*>(starts),
        static_cast<const long long*>(counts),
        static_cast<const long long*>(order), static_cast<const double*>(fl),
        static_cast<const double*>(ce), static_cast<const double*>(w),
        static_cast<double*>(out), n_segs, jb, iters);
    return static_cast<int>(cudaGetLastError());
  });
}
