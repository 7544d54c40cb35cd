// Shared device code of the powercap kernels: fp64 reductions over a row's
// lanes and the dense weighted max-min waterfill of one row.
//
// The arithmetic follows the plain version (ref.py: waterfill_dense_ref)
// op for op; the library is built with --fmad=false so no multiply-add is
// contracted, and only the order of the sums differs from it.
//
// A row of J slots takes G consecutive lanes of a warp, G the next power of
// two at or above J, at least 4 and at most 32, so a warp runs 32 / G rows
// at once; slot j lives in lane j % G.  Up to 256 slots a row stay in
// registers (K = J / 32 slots a lane); wider rows are read from memory on
// every trip, 32 lanes a chunk, chunks in order (K = 0 below).  Every sum is
// a lane's slots in order, then a butterfly over the row's G lanes, so all
// lanes of a row end with the bitwise-same value and take the same branch.
// For J <= 16 the sums are bitwise those of a butterfly over the whole
// warp: the levels that drop out only ever added lanes that hold 0.0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace powercap {

constexpr unsigned kFullMask = 0xffffffffu;

// The lanes of the calling thread's row: its group of G lanes.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  const int lane = threadIdx.x & 31;
  return (kFullMask >> (32 - G)) << (lane & ~(G - 1));
}

// Butterfly sum over a group of G lanes: each step adds the same two
// operands on both partners, so every lane ends with the same bits.
template <int G>
__device__ __forceinline__ double group_sum(double v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

template <int G>
__device__ __forceinline__ double group_max(double v, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(mask, v, o));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  return group_sum<32>(v, kFullMask);
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

// A row's slots in the lane's registers: slot j = sl + G k (k < K).  Slots
// that are not live count as floor 0, ceiling 0, weight 1e-12 (masked
// here, before anything else, so stale values never reach the bracket).
template <int G, int K, class Slots>
struct HeldRow {
  double f[K], c[K], w[K];
  int sl;

  __device__ __forceinline__ HeldRow(const Slots& s, int J)
      : sl(threadIdx.x & (G - 1)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sl + G * k;
      f[k] = 0.0;
      c[k] = 0.0;
      w[k] = 1e-12;
      if (j < J) s.load(j, f[k], c[k], w[k]);
      c[k] = fmax(c[k], f[k]);
    }
  }

  // fn(j, floor, ceiling, weight) for the lane's slots in order (j >= J
  // included: they hold the masked values).
  template <class Fn>
  __device__ __forceinline__ void each(Fn&& fn) const {
#pragma unroll
    for (int k = 0; k < K; ++k) fn(sl + G * k, f[k], c[k], w[k]);
  }
};

// A row wider than 256 slots, read from memory on every pass: slot j =
// lane + 32 k, k in order, masked as in HeldRow.  The slots past J that a
// held row would visit add only 0.0 to its sums, so the two give the same
// values.
template <class Slots>
struct StreamedRow {
  Slots s;
  int J, sl;

  __device__ __forceinline__ StreamedRow(const Slots& s_, int J_)
      : s(s_), J(J_), sl(threadIdx.x & 31) {}

  template <class Fn>
  __device__ __forceinline__ void each(Fn&& fn) const {
    for (int j = sl; j < J; j += 32) {
      double f = 0.0, c = 0.0, w = 1e-12;
      s.load(j, f, c, w);
      c = fmax(c, f);
      fn(j, f, c, w);
    }
  }
};

template <int G, int K, class Slots>
struct RowOf {
  using type = HeldRow<G, K, Slots>;
};
template <int G, class Slots>
struct RowOf<G, 0, Slots> {
  using type = StreamedRow<Slots>;
};

// Waterfill of one row of J slots by the calling group of G lanes.  Finds
// x = clip(w * level, floor, ceil) with sum(x) == min(cap, sum(ceil)) by at
// most `iters` bisection trips on the level, then bumps the residual pro
// rata among slots below their ceiling; a row whose floors reach the
// capacity gets pro-rata floors.  Calls sink(j, x) for every slot j < J of
// the lane.
//
// Two exits give bitwise the `hi` of all `iters` trips:
// * A degenerate row (total floor >= cap) takes f * scale whatever the
//   bisection finds, so it runs no trip.
// * The bisection ends after the first trip whose midpoint equals an end of
//   the bracket.  That trip either changes nothing or sets lo = hi (or
//   hi = lo).  From then on every trip computes the same mid (0.5 * (lo +
//   hi) of the same two values, or of lo + lo, which is exact), the same
//   sum and the same `under`, so the bracket never changes again.  The
//   test is uniform over the row's lanes: lo, hi and the sum are the same
//   bits in each.  In fp64 the bracket collapses after about 55-65 trips
//   when hi starts at max(c / w) + 1; a level that goes to 0 halves
//   hi on every trip and never collapses within 200.
template <int G, class Row, class Sink>
__device__ __forceinline__ void waterfill_row(double cap, const Row& row,
                                              int J, int iters,
                                              Sink&& sink) {
  const unsigned mask = group_mask<G>();
  double sf = 0.0, sc = 0.0, mx = -INFINITY;
  row.each([&](int j, double f, double c, double w) {
    sf += f;
    sc += c;
    if (j < J) mx = fmax(mx, c / w);
  });
  const double total_floor = group_sum<G>(sf, mask);
  const bool degenerate = total_floor >= cap;
  const double target = fmin(cap, group_sum<G>(sc, mask));
  double hi = group_max<G>(mx, mask) + 1.0;
  double lo = 0.0;
  for (int it = 0; it < iters && !degenerate; ++it) {
    const double mid = 0.5 * (lo + hi);
    double s = 0.0;
    row.each([&](int, double f, double c, double w) {
      s += clip(w * mid, f, c);
    });
    const bool under = group_sum<G>(s, mask) < target;
    const bool collapsed = mid == lo || mid == hi;
    lo = under ? mid : lo;
    hi = under ? hi : mid;
    if (collapsed) break;
  }
  double so = 0.0;
  row.each([&](int, double f, double c, double w) {
    so += clip(w * hi, f, c);
  });
  const double gap = target - group_sum<G>(so, mask);
  double swr = 0.0;
  row.each([&](int, double f, double c, double w) {
    swr += (c - clip(w * hi, f, c)) > 1e-12 ? w : 0.0;
  });
  const double w_room_sum = group_sum<G>(swr, mask);
  const bool adjust = gap > 1e-12 && w_room_sum > 0.0;
  const double scale = cap / fmax(total_floor, 1e-12);
  row.each([&](int j, double f, double c, double w) {
    if (j >= J) return;
    const double x = clip(w * hi, f, c);
    const double wr = (c - x) > 1e-12 ? w : 0.0;
    const double bump = adjust ? gap * wr / fmax(w_room_sum, 1e-300) : 0.0;
    sink(j, degenerate ? f * scale : clip(x + bump, f, c));
  });
}

// The row routine for a row shape: G lanes a row, K slots a lane held in
// registers (K = 0: streamed).
template <int G, int K, class Slots, class Sink>
__device__ __forceinline__ void waterfill(double cap, const Slots& slots,
                                          int J, int iters, Sink&& sink) {
  const typename RowOf<G, K, Slots>::type row(slots, J);
  waterfill_row<G>(cap, row, J, iters, sink);
}

template <int G_, int K_>
struct RowShape {
  static constexpr int G = G_;
  static constexpr int K = K_;
};

// Calls f(RowShape<G, K>{}) for a row of J >= 1 slots and returns its
// result (kernel.py: row_shape mirrors it).
template <class F>
inline int with_row_shape(int J, F&& f) {
  if (J <= 4) return f(RowShape<4, 1>{});
  if (J <= 8) return f(RowShape<8, 1>{});
  if (J <= 16) return f(RowShape<16, 1>{});
  if (J <= 32) return f(RowShape<32, 1>{});
  if (J <= 64) return f(RowShape<32, 2>{});
  if (J <= 128) return f(RowShape<32, 4>{});
  if (J <= 256) return f(RowShape<32, 8>{});
  return f(RowShape<32, 0>{});
}

}  // namespace powercap
