// K2: the whole BalancePowerCap loop for every cell in one launch.
//
// Replaces the TPU kernel balance_round_call / balance_round_kernel in
// src/repro/kernels/powercap/kernel.py:109 (body :70), with the host loop
// that drove it round by round (ops.py:_balance_loop, :81).
//
// Bound on an H100: fp64 operations and, at the main path's few cells,
// latency: each round waterfills every host of the cell at the candidate
// caps (100 bisection trips over the slots), and each round waits on
// block-wide reductions of the previous step.  Design: one block per cell
// runs all of its rounds until its own `done` or max_iters (a done cell
// never commits again, and cells never interact, so the result is the
// reference's global loop); the host columns live in shared memory; every
// reduction is a fixed tree (per-thread strided partials, warp butterfly,
// then warp 0 over the warp partials), so a run is deterministic; the
// candidate-cap waterfill is the K1 row routine, one warp per host, with
// the slot columns read from global memory (they stay in L2 across rounds).
#include "waterfill.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHostArrays = 14;  // doubles per host kept in shared memory

__device__ double block_sum(double v, double* red) {
  v = powercap::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous result has been read by every thread
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < kWarps ? red[lane] : 0.0;
    t = powercap::warp_sum(t);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  return red[kWarps];
}

// Eq. 3 then Eq. 4 of one host; 0 when powered off.
__device__ __forceinline__ double managed_capacity(bool on, double cap,
                                                   double idle, double peak,
                                                   double cpk, double hyp) {
  const double c = powercap::clip(cap, idle, peak);
  const double frac = (c - idle) / (peak - idle);
  const double capped = on ? cpk * frac : 0.0;
  return on ? fmax(capped - hyp, 0.0) : 0.0;
}

// Inverse of Eq. 4.
__device__ __forceinline__ double cap_for_managed(double capacity,
                                                  double idle, double peak,
                                                  double cpk, double hyp) {
  const double c = powercap::clip(capacity + hyp, 0.0, cpk);
  return idle + (peak - idle) * (c / cpk);
}

__device__ double masked_std(const double* v, const unsigned char* on,
                             double safe, int H, double* red) {
  double p = 0.0;
  for (int h = threadIdx.x; h < H; h += kThreads) p += on[h] ? v[h] : 0.0;
  const double mean = block_sum(p, red) / safe;
  double q = 0.0;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    if (on[h]) {
      const double d = v[h] - mean;
      q += d * d;
    }
  }
  return sqrt(block_sum(q, red) / safe);
}

// Per-host VM-entitlement sums at managed capacities `man`: warp w
// waterfills hosts w, w + kWarps, ...
template <int K>
__device__ void entitlements(const double* man, double* ents,
                             const double* fl, const double* ce,
                             const double* w, const unsigned char* act,
                             int H, int J, int iters) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < H; h += kWarps) {
    const long long r = static_cast<long long>(h) * J;
    double x[K];
    const powercap::DenseSlots slots{fl + r, ce + r, w + r, act + r};
    powercap::waterfill_row<K>(man[h], slots, J, iters, x);
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) s += x[k];
    s = powercap::warp_sum(s);
    if (lane == 0) ents[h] = s;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) balance_caps_kernel(
    const unsigned char* __restrict__ on_g, const double* __restrict__ idle_g,
    const double* __restrict__ peak_g, const double* __restrict__ cpk_g,
    const double* __restrict__ hyp_g, const double* __restrict__ fl_g,
    const double* __restrict__ ce_g, const double* __restrict__ w_g,
    const unsigned char* __restrict__ act_g,
    const double* __restrict__ cres_g, const double* __restrict__ budget_g,
    const unsigned char* __restrict__ enabled_g,
    const double* __restrict__ caps_in, double* __restrict__ caps_out,
    unsigned char* __restrict__ did_out, int* __restrict__ rounds_out, int H,
    int J, int iters, double threshold, int max_iters, double min_transfer) {
  extern __shared__ double smem[];
  double* red = smem;
  double* idle = red + (kWarps + 1);
  double* peak = idle + H;
  double* cpk = peak + H;
  double* hyp = cpk + H;
  double* cres = hyp + H;
  double* pkm = cres + H;
  double* caps = pkm + H;
  double* man = caps + H;
  double* ents = man + H;
  double* ns = ents + H;
  double* ncaps = ns + H;
  double* nman = ncaps + H;
  double* nents = nman + H;
  double* nns = nents + H;
  unsigned char* on = reinterpret_cast<unsigned char*>(nns + H);

  const int s = blockIdx.x;
  const long long hb = static_cast<long long>(s) * H;
  const double* fl = fl_g + hb * J;
  const double* ce = ce_g + hb * J;
  const double* w = w_g + hb * J;
  const unsigned char* act = act_g + hb * J;

  double p = 0.0;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    on[h] = on_g[hb + h];
    idle[h] = idle_g[hb + h];
    peak[h] = peak_g[hb + h];
    cpk[h] = cpk_g[hb + h];
    hyp[h] = hyp_g[hb + h];
    cres[h] = cres_g[hb + h];
    pkm[h] = fmax(cpk[h] - hyp[h], 0.0);
    caps[h] = caps_in[hb + h];
    man[h] = managed_capacity(on[h], caps[h], idle[h], peak[h], cpk[h],
                              hyp[h]);
    p += on[h] ? 1.0 : 0.0;
  }
  const double n_on = block_sum(p, red);  // also publishes the columns
  const double safe = fmax(n_on, 1.0);
  entitlements<K>(man, ents, fl, ce, w, act, H, J, iters);
  __syncthreads();
  for (int h = threadIdx.x; h < H; h += kThreads)
    ns[h] = man[h] > 0.0 ? ents[h] / fmax(man[h], 1e-300) : 0.0;
  __syncthreads();

  // `done` and every scalar below come from block_sum, so they are the same
  // in every thread and the loop never diverges around a barrier.
  bool done = !enabled_g[s] || n_on < 2.0;
  bool did = false;
  int rounds = 0;
  for (int r = 0; r < max_iters && !done; ++r) {
    ++rounds;
    const double imbalance = masked_std(ns, on, safe, H, red);
    double pc = 0.0, pe = 0.0;
    for (int h = threadIdx.x; h < H; h += kThreads) {
      if (on[h]) {
        pc += man[h];
        pe += ents[h];
      }
    }
    const double total_cap = block_sum(pc, red);
    const double n_avg = block_sum(pe, red) / fmax(total_cap, 1e-300);
    bool halt = imbalance <= threshold || total_cap <= 0.0 || n_avg <= 1e-12;

    // Hosts above the average level receive (up to their peak), hosts
    // below donate (down to the average level and their reservations).
    const double avg_safe = fmax(n_avg, 1e-300);
    double pn = 0.0, pa = 0.0;
    for (int h = threadIdx.x; h < H; h += kThreads) {
      const double cbar = ents[h] / avg_safe;
      if (on[h] && ns[h] > n_avg)
        pn += fmax(fmin(pkm[h], cbar) - man[h], 0.0);
      if (on[h] && ns[h] < n_avg)
        pa += fmax(man[h] - fmax(cbar, cres[h]), 0.0);
    }
    const double total_need = block_sum(pn, red);
    const double total_avail = block_sum(pa, red);
    const double transfer = fmin(total_need, total_avail);
    halt = halt || transfer <= min_transfer;
    if (halt) {
      done = true;
      break;
    }

    const double need_safe = fmax(total_need, 1e-300);
    const double avail_safe = fmax(total_avail, 1e-300);
    double pcs = 0.0, prc = 0.0;
    for (int h = threadIdx.x; h < H; h += kThreads) {
      const double cbar = ents[h] / avg_safe;
      const bool rec = on[h] && ns[h] > n_avg;
      const bool don = on[h] && ns[h] < n_avg;
      double nc = caps[h];
      if (rec) {
        const double need = fmax(fmin(pkm[h], cbar) - man[h], 0.0);
        if (need > 0.0)
          nc = cap_for_managed(man[h] + transfer * need / need_safe, idle[h],
                               peak[h], cpk[h], hyp[h]);
      }
      if (don) {
        const double avail = fmax(man[h] - fmax(cbar, cres[h]), 0.0);
        if (avail > 0.0)
          nc = cap_for_managed(man[h] - transfer * avail / avail_safe,
                               idle[h], peak[h], cpk[h], hyp[h]);
      }
      ncaps[h] = nc;
      pcs += on[h] ? nc : 0.0;
      prc += rec ? 1.0 : 0.0;
    }
    // Watts conservation under heterogeneous specs: trim the recipients.
    const double over = block_sum(pcs, red) - budget_g[s];
    const double n_rec = block_sum(prc, red);
    const double cut = over / fmax(n_rec, 1.0);
    for (int h = threadIdx.x; h < H; h += kThreads) {
      if (over > 1e-6 && on[h] && ns[h] > n_avg)
        ncaps[h] = fmax(ncaps[h] - cut, idle[h]);
      nman[h] = managed_capacity(on[h], ncaps[h], idle[h], peak[h], cpk[h],
                                 hyp[h]);
    }
    __syncthreads();
    entitlements<K>(nman, nents, fl, ce, w, act, H, J, iters);
    __syncthreads();
    for (int h = threadIdx.x; h < H; h += kThreads)
      nns[h] = nman[h] > 0.0 ? nents[h] / fmax(nman[h], 1e-300) : 0.0;
    __syncthreads();
    // A non-improving round stops the cell without committing.
    if (masked_std(nns, on, safe, H, red) > imbalance + 1e-12) {
      done = true;
      break;
    }
    for (int h = threadIdx.x; h < H; h += kThreads) {
      caps[h] = ncaps[h];
      man[h] = nman[h];
      ents[h] = nents[h];
      ns[h] = nns[h];
    }
    did = true;
    __syncthreads();
  }
  for (int h = threadIdx.x; h < H; h += kThreads) caps_out[hb + h] = caps[h];
  if (threadIdx.x == 0) {
    did_out[s] = did ? 1 : 0;
    rounds_out[s] = rounds;
  }
}

template <int K>
int launch(const void* const* p, long long S, int H, int J, int iters,
           double threshold, int max_iters, double min_transfer,
           size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      balance_caps_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  balance_caps_kernel<K><<<static_cast<unsigned>(S), kThreads, smem,
                           stream>>>(
      static_cast<const unsigned char*>(p[0]),
      static_cast<const double*>(p[1]), static_cast<const double*>(p[2]),
      static_cast<const double*>(p[3]), static_cast<const double*>(p[4]),
      static_cast<const double*>(p[5]), static_cast<const double*>(p[6]),
      static_cast<const double*>(p[7]),
      static_cast<const unsigned char*>(p[8]),
      static_cast<const double*>(p[9]), static_cast<const double*>(p[10]),
      static_cast<const unsigned char*>(p[11]),
      static_cast<const double*>(p[12]), static_cast<double*>(
          const_cast<void*>(p[13])),
      static_cast<unsigned char*>(const_cast<void*>(p[14])),
      static_cast<int*>(const_cast<void*>(p[15])), H, J, iters, threshold,
      max_iters, min_transfer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long powercap_balance_smem_bytes(int H) {
  return static_cast<long long>(sizeof(double)) *
             (kWarps + 1 + static_cast<long long>(kHostArrays) * H) +
         H;
}

// Pointer order: on, idle, peak, capacity_peak, hyp_overhead, floors,
// ceils, weights, active, cpu_reserved, budget, enabled, caps_in,
// caps_out, did_out, rounds_out.
extern "C" int powercap_balance_caps(
    const void* on, const void* idle, const void* peak, const void* cpk,
    const void* hyp, const void* fl, const void* ce, const void* w,
    const void* act, const void* cres, const void* budget,
    const void* enabled, const void* caps_in, void* caps_out, void* did_out,
    void* rounds_out, long long S, int H, int J, int iters, double threshold,
    int max_iters, double min_transfer, void* stream) {
  if (S <= 0 || H <= 0) return 0;
  const void* p[16] = {on,  idle,   peak,    cpk,     hyp,      fl,
                       ce,  w,      act,     cres,    budget,   enabled,
                       caps_in, caps_out, did_out, rounds_out};
  const size_t smem = static_cast<size_t>(powercap_balance_smem_bytes(H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (powercap::slots_per_lane(J)) {
    case 1: return launch<1>(p, S, H, J, iters, threshold, max_iters,
                             min_transfer, smem, s);
    case 2: return launch<2>(p, S, H, J, iters, threshold, max_iters,
                             min_transfer, smem, s);
    case 4: return launch<4>(p, S, H, J, iters, threshold, max_iters,
                             min_transfer, smem, s);
    case 8: return launch<8>(p, S, H, J, iters, threshold, max_iters,
                             min_transfer, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
