// Shared device code of the powercap kernels: fp64 warp reductions and the
// dense weighted max-min waterfill of one row, run by one warp.
//
// The arithmetic follows the plain version (ref.py: waterfill_dense_ref)
// op for op; the library is built with --fmad=false so no multiply-add is
// contracted, and only the order of the sums differs from it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace powercap {

constexpr unsigned kFullMask = 0xffffffffu;

// Butterfly sum: every lane ends with the bitwise-same value (each step adds
// the same two operands on both partners), so all lanes take the same
// bisection branch.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// jnp.clip order: min(max(x, lo), hi).
__device__ __forceinline__ double clip(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

// Slot loaders: `load(j, f, c, w)` (j < J) reads the floor, ceiling and
// weight of slot j when the slot is live and leaves them as they are when
// it is not.  The row routine takes the loader as a template parameter, so
// each kernel keeps its own layout while all share one bisection.
//
// A dense row (K1, K2): slot j is live where its `active` byte is set.
struct DenseSlots {
  const double* fl;
  const double* ce;
  const double* w;
  const unsigned char* act;

  __device__ __forceinline__ void load(int j, double& f, double& c,
                                       double& wt) const {
    if (act[j]) {
      f = fl[j];
      c = ce[j];
      wt = w[j];
    }
  }
};

// Waterfill of one row of J slots by the calling warp: slot j = lane + 32 k
// (k < K) lives in registers.  Finds x = clip(w * level, floor, ceil) with
// sum(x) == min(cap, sum(ceil)) by `iters` bisection trips on the level,
// then bumps the residual pro rata among slots below their ceiling; a row
// whose floors reach the capacity gets pro-rata floors.  Slots that are
// not live count as floor 0, ceiling 0, weight 1e-12 (masked here, before
// anything else, so stale values in them never reach the bracket).
// Writes x[k] (0 for j >= J).
template <int K, class Slots>
__device__ __forceinline__ void waterfill_row(double cap, const Slots& slots,
                                              int J, int iters,
                                              double (&x)[K]) {
  const int lane = threadIdx.x & 31;
  double f[K], c[K], wt[K];
  double sf = 0.0, sc = 0.0, mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    f[k] = 0.0;
    c[k] = 0.0;
    wt[k] = 1e-12;
    if (j < J) slots.load(j, f[k], c[k], wt[k]);
    c[k] = fmax(c[k], f[k]);
    sf += f[k];
    sc += c[k];
    if (j < J) mx = fmax(mx, c[k] / wt[k]);
  }
  const double total_floor = warp_sum(sf);
  const bool degenerate = total_floor >= cap;
  const double target = fmin(cap, warp_sum(sc));
  double hi = warp_max(mx) + 1.0;
  double lo = 0.0;
  for (int it = 0; it < iters; ++it) {
    const double mid = 0.5 * (lo + hi);
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) s += clip(wt[k] * mid, f[k], c[k]);
    const bool under = warp_sum(s) < target;
    lo = under ? mid : lo;
    hi = under ? hi : mid;
  }
  double so = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = clip(wt[k] * hi, f[k], c[k]);
    so += x[k];
  }
  const double gap = target - warp_sum(so);
  double wr[K];
  double swr = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wr[k] = (c[k] - x[k]) > 1e-12 ? wt[k] : 0.0;
    swr += wr[k];
  }
  const double w_room_sum = warp_sum(swr);
  const bool adjust = gap > 1e-12 && w_room_sum > 0.0;
  const double scale = cap / fmax(total_floor, 1e-12);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const double bump = adjust ? gap * wr[k] / fmax(w_room_sum, 1e-300) : 0.0;
    const double o = clip(x[k] + bump, f[k], c[k]);
    x[k] = degenerate ? f[k] * scale : o;
  }
}

// Slots per lane for a row of J slots (0: J too wide for the kernels).
inline int slots_per_lane(int J) {
  return J <= 32 ? 1 : J <= 64 ? 2 : J <= 128 ? 4 : J <= 256 ? 8 : 0;
}

}  // namespace powercap
