// K2: the whole BalancePowerCap loop for every cell in one launch.
//
// Replaces the TPU kernel balance_round_call / balance_round_kernel in
// src/repro/kernels/powercap/kernel.py:109 (body :70), with the host loop
// that drove it round by round (ops.py:_balance_loop, :81).
//
// Bound on an H100: issue rate and latency, not bytes or the fp64 peak.
// A round waterfills every host of the cell at the candidate caps (up to
// `iters` bisection trips, each a butterfly of shuffles and a few fp64
// ops that the SM's warps issue in turn) and waits on cluster-wide sums of
// the step before it.  Design: one thread-block cluster of c blocks
// (kernel.py: balance_plan chooses c, the threads a block and the shared
// memory) runs all of one cell's rounds until its own `done` or max_iters
// (a done cell never commits again, and cells never interact, so the
// result is the reference's global loop).  Block rank r owns a contiguous
// range of ceil(H / c) hosts and keeps their 14 columns and `on` in its
// own shared memory, so a cell's capacity grows with c.  Its warps
// waterfill its hosts with the packed row routine of K1 (waterfill.cuh),
// reading the slot columns from global memory (they stay in L2 across
// rounds).  Every cluster-wide sum is a fixed tree: each block sums its
// threads' strided partials (warp butterfly, then warp 0 over the warp
// partials) and writes the result to a slot of its shared memory; after a
// cluster barrier, warp 0 of every block reads the c slots through DSMEM
// and adds them in rank order.  All blocks then hold the same bits, so
// `done` and `halt` agree across the cluster and no block diverges around
// a barrier.  The sums of a step travel as one vector, the slots are
// double-buffered, and a round costs four exchanges: (need, avail),
// (caps, recipients), (mean of the new levels, capacity, entitlements) and
// the variance.  No atomics.
#include <stdint.h>

#include "waterfill.cuh"

namespace {

constexpr int kHostArrays = 14;  // doubles per host kept in shared memory
constexpr int kMaxVec = 4;       // the widest exchange
constexpr int kMaxWarps = 32;
constexpr int kMaxCluster = 16;

// Shared memory of a block that owns `n` hosts: the warp partials, two
// exchange slots, the exchange's result, then 14 doubles and one flag a
// host (kernel.py: balance_smem_bytes mirrors it).
constexpr long long smem_bytes(long long n) {
  return static_cast<long long>(sizeof(double)) *
             (kMaxWarps * kMaxVec + 3 * kMaxVec + kHostArrays * n) +
         n;
}

// Threads a block for a row shape: 1024, or 512 where a lane holds 4 or 8
// slots in registers (kernel.py: balance_threads mirrors it).
constexpr int threads_for(int K) { return K == 4 || K == 8 ? 512 : 1024; }

// This block's rank in its cluster, and the cluster's blocks.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// Every thread of every block of the cluster; shared-memory writes before
// it are seen by every block after it (arrive releases, wait acquires).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" :::
               "memory");
}

// The double at the offset of `p` (in this block's shared memory) in the
// shared memory of block `rank` of the cluster.
__device__ __forceinline__ double ld_cluster(const double* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(a), "r"(rank));
  double v;
  asm volatile("ld.shared::cluster.f64 %0, [%1];"
               : "=d"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// The cluster-wide sum of each v[i] (see the design note): every block of
// the cluster returns the same bits.  Only the block's first `live` warps
// hold hosts (the others' partials are 0.0 and add nothing), so only they
// reduce.  After the barrier, lane r of warp 0 reads rank r's slot (one
// DSMEM load a lane, all in flight at once) and every lane adds the c
// values in rank order, through shuffles, so all lanes hold the same bits;
// lane 0 hands the sums to the block through `total`.  `buf` alternates
// the slots, so a block that runs ahead into the next exchange never
// overwrites a slot another block has still to read (that block has not
// passed the barrier the next exchange waits on).
template <int N, int kThreads>
__device__ __forceinline__ void cluster_sum(double (&v)[N], double* red,
                                            double* slots, double* total,
                                            int& buf, int c, int live) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < live) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = powercap::warp_sum(v[i]);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) red[warp * kMaxVec + i] = v[i];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const double t = powercap::warp_sum(
          lane < live && lane < kWarps ? red[lane * kMaxVec + i] : 0.0);
      if (lane == 0) slots[buf * kMaxVec + i] = t;
    }
  }
  cluster_sync();
  if (warp == 0) {
    double p[N], t[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      p[i] = lane < c ? ld_cluster(slots + buf * kMaxVec + i, lane) : 0.0;
      t[i] = 0.0;
    }
    for (int r = 0; r < c; ++r) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        t[i] += __shfl_sync(powercap::kFullMask, p[i], r);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) total[i] = t[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = total[i];
  buf ^= 1;
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

// Per-host VM-entitlement sums at managed capacities `man` for the block's
// `n` hosts: G lanes a host, kThreads / G hosts a pass.
template <int G, int K, int kThreads>
__device__ void entitlements(const double* man, double* ents,
                             const double* fl, const double* ce,
                             const double* w, const unsigned char* act,
                             int n, int J, int iters) {
  constexpr int kRows = kThreads / G;
  const unsigned mask = powercap::group_mask<G>();
  for (int h = threadIdx.x / G; h < n; h += kRows) {
    const long long r = static_cast<long long>(h) * J;
    const powercap::DenseSlots slots{fl + r, ce + r, w + r, act + r};
    double s = 0.0;
    powercap::waterfill<G, K>(man[h], slots, J, iters,
                              [&](int, double x) { s += x; });
    s = powercap::group_sum<G>(s, mask);
    if ((threadIdx.x & (G - 1)) == 0) ents[h] = s;
  }
}

template <int G, int K, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) balance_caps_kernel(
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
  const int c = cluster_blocks();
  const int rank = cluster_rank();
  const int s = blockIdx.x / c;
  const int per = (H + c - 1) / c;
  const int h0 = min(H, rank * per);
  const int n = min(H, h0 + per) - h0;  // hosts of this block (may be 0)

  extern __shared__ double smem[];
  double* red = smem;
  double* slots = red + kMaxWarps * kMaxVec;
  double* total = slots + 2 * kMaxVec;
  double* idle = total + kMaxVec;
  double* peak = idle + per;
  double* cpk = peak + per;
  double* hyp = cpk + per;
  double* cres = hyp + per;
  double* pkm = cres + per;
  double* caps = pkm + per;
  double* man = caps + per;
  double* ents = man + per;
  double* ns = ents + per;
  double* ncaps = ns + per;
  double* nman = ncaps + per;
  double* nents = nman + per;
  double* nns = nents + per;
  unsigned char* on = reinterpret_cast<unsigned char*>(nns + per);
  int buf = 0;
  // Warps that hold hosts in the strided loops below.
  const int live = min(kThreads / 32, (n + 31) / 32);

  const long long hb = static_cast<long long>(s) * H + h0;
  const double* fl = fl_g + hb * J;
  const double* ce = ce_g + hb * J;
  const double* w = w_g + hb * J;
  const unsigned char* act = act_g + hb * J;

  double v4[4] = {0.0, 0.0, 0.0, 0.0};
  for (int h = threadIdx.x; h < n; h += kThreads) {
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
    v4[0] += on[h] ? 1.0 : 0.0;
  }
  __syncthreads();
  entitlements<G, K, kThreads>(man, ents, fl, ce, w, act, n, J, iters);
  __syncthreads();
  // v4: hosts on, then the sums of the levels (the first mean), the
  // managed capacities and the entitlements of the hosts that are on.
  for (int h = threadIdx.x; h < n; h += kThreads) {
    ns[h] = man[h] > 0.0 ? ents[h] / fmax(man[h], 1e-300) : 0.0;
    v4[1] += on[h] ? ns[h] : 0.0;
    if (on[h]) {
      v4[2] += man[h];
      v4[3] += ents[h];
    }
  }
  cluster_sum<4, kThreads>(v4, red, slots, total, buf, c, live);
  const double n_on = v4[0];
  const double safe = fmax(n_on, 1.0);
  double total_cap = v4[2], total_ents = v4[3];
  double imbalance;
  {
    const double mean = v4[1] / safe;
    double q[1] = {0.0};
    for (int h = threadIdx.x; h < n; h += kThreads) {
      if (on[h]) {
        const double d = ns[h] - mean;
        q[0] += d * d;
      }
    }
    cluster_sum<1, kThreads>(q, red, slots, total, buf, c, live);
    imbalance = sqrt(q[0] / safe);
  }

  // `done` and every scalar below come from cluster_sum, so they are the
  // same in every thread of the cluster and the loop never diverges around
  // a barrier.  A committed round's imbalance, capacity and entitlement
  // sums are those the next round would compute from the committed
  // columns (the same values, summed in the same order), so they carry
  // over.
  bool done = !enabled_g[s] || n_on < 2.0;
  bool did = false;
  int rounds = 0;
  for (int r = 0; r < max_iters && !done; ++r) {
    ++rounds;
    const double n_avg = total_ents / fmax(total_cap, 1e-300);
    bool halt = imbalance <= threshold || total_cap <= 0.0 || n_avg <= 1e-12;

    // Hosts above the average level receive (up to their peak), hosts
    // below donate (down to the average level and their reservations).
    const double avg_safe = fmax(n_avg, 1e-300);
    double na[2] = {0.0, 0.0};
    for (int h = threadIdx.x; h < n; h += kThreads) {
      const double cbar = ents[h] / avg_safe;
      if (on[h] && ns[h] > n_avg)
        na[0] += fmax(fmin(pkm[h], cbar) - man[h], 0.0);
      if (on[h] && ns[h] < n_avg)
        na[1] += fmax(man[h] - fmax(cbar, cres[h]), 0.0);
    }
    cluster_sum<2, kThreads>(na, red, slots, total, buf, c, live);
    const double total_need = na[0];
    const double total_avail = na[1];
    const double transfer = fmin(total_need, total_avail);
    halt = halt || transfer <= min_transfer;
    if (halt) {
      done = true;
      break;
    }

    const double need_safe = fmax(total_need, 1e-300);
    const double avail_safe = fmax(total_avail, 1e-300);
    double cr[2] = {0.0, 0.0};
    for (int h = threadIdx.x; h < n; h += kThreads) {
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
      cr[0] += on[h] ? nc : 0.0;
      cr[1] += rec ? 1.0 : 0.0;
    }
    cluster_sum<2, kThreads>(cr, red, slots, total, buf, c, live);
    // Watts conservation under heterogeneous specs: trim the recipients.
    const double over = cr[0] - budget_g[s];
    const double n_rec = cr[1];
    const double cut = over / fmax(n_rec, 1.0);
    for (int h = threadIdx.x; h < n; h += kThreads) {
      if (over > 1e-6 && on[h] && ns[h] > n_avg)
        ncaps[h] = fmax(ncaps[h] - cut, idle[h]);
      nman[h] = managed_capacity(on[h], ncaps[h], idle[h], peak[h], cpk[h],
                                 hyp[h]);
    }
    __syncthreads();
    entitlements<G, K, kThreads>(nman, nents, fl, ce, w, act, n, J, iters);
    __syncthreads();
    double mce[3] = {0.0, 0.0, 0.0};
    for (int h = threadIdx.x; h < n; h += kThreads) {
      nns[h] = nman[h] > 0.0 ? nents[h] / fmax(nman[h], 1e-300) : 0.0;
      mce[0] += on[h] ? nns[h] : 0.0;
      if (on[h]) {
        mce[1] += nman[h];
        mce[2] += nents[h];
      }
    }
    cluster_sum<3, kThreads>(mce, red, slots, total, buf, c, live);
    const double mean = mce[0] / safe;
    double q[1] = {0.0};
    for (int h = threadIdx.x; h < n; h += kThreads) {
      if (on[h]) {
        const double d = nns[h] - mean;
        q[0] += d * d;
      }
    }
    cluster_sum<1, kThreads>(q, red, slots, total, buf, c, live);
    const double new_imbalance = sqrt(q[0] / safe);
    // A non-improving round stops the cell without committing.
    if (new_imbalance > imbalance + 1e-12) {
      done = true;
      break;
    }
    for (int h = threadIdx.x; h < n; h += kThreads) {
      caps[h] = ncaps[h];
      man[h] = nman[h];
      ents[h] = nents[h];
      ns[h] = nns[h];
    }
    imbalance = new_imbalance;
    total_cap = mce[1];
    total_ents = mce[2];
    did = true;
    __syncthreads();
  }
  for (int h = threadIdx.x; h < n; h += kThreads) caps_out[hb + h] = caps[h];
  if (rank == 0 && threadIdx.x == 0) {
    did_out[s] = did ? 1 : 0;
    rounds_out[s] = rounds;
  }
  // No block leaves while another may still read its exchange slots.
  cluster_sync();
}

// The kernel's attributes for a cluster of c blocks with `smem` bytes of
// dynamic shared memory each.
template <int G, int K>
cudaError_t prepare(int c, long long smem) {
  const auto fn = balance_caps_kernel<G, K, threads_for(K)>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && c > 8)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                    long long blocks, int c, int threads, long long smem,
                    cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(c);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

}  // namespace

// Clusters of c blocks that can be resident at once for rows of J slots at
// `smem` bytes a block (cudaOccupancyMaxActiveClusters), in *out.
extern "C" int powercap_balance_max_active_clusters(int J, int c,
                                                    long long smem,
                                                    int device,
                                                    int* out) {
  *out = 0;
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (J <= 0 || c < 1 || c > kMaxCluster) return 0;
  return powercap::with_row_shape(J, [&](auto shape) {
    using Shape = decltype(shape);
    constexpr int kThreads = threads_for(Shape::K);
    cudaError_t e = prepare<Shape::G, Shape::K>(c, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, c, c, kThreads, smem, nullptr);
    e = cudaOccupancyMaxActiveClusters(
        out,
        reinterpret_cast<const void*>(
            balance_caps_kernel<Shape::G, Shape::K, kThreads>),
        &cfg);
    return static_cast<int>(e);
  });
}

// Pointer order: on, idle, peak, capacity_peak, hyp_overhead, floors,
// ceils, weights, active, cpu_reserved, budget, enabled, caps_in,
// caps_out, did_out, rounds_out.  `cluster` blocks of `threads` threads
// and `smem` bytes run each cell (the plan's; checked here against the
// kernel's own counts).
extern "C" int powercap_balance_caps(
    const void* on, const void* idle, const void* peak, const void* cpk,
    const void* hyp, const void* fl, const void* ce, const void* w,
    const void* act, const void* cres, const void* budget,
    const void* enabled, const void* caps_in, void* caps_out, void* did_out,
    void* rounds_out, long long S, int H, int J, int iters, double threshold,
    int max_iters, double min_transfer, int cluster, int threads,
    long long smem, int device, void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (S <= 0 || H <= 0) return 0;
  if (J <= 0 || cluster < 1 || cluster > kMaxCluster ||
      smem < smem_bytes((H + cluster - 1) / cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return powercap::with_row_shape(J, [&](auto shape) {
    using Shape = decltype(shape);
    constexpr int kThreads = threads_for(Shape::K);
    if (threads != kThreads) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = prepare<Shape::G, Shape::K>(cluster, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(cfg, attr, S * cluster, cluster, kThreads, smem, st);
    e = cudaLaunchKernelEx(
        &cfg, balance_caps_kernel<Shape::G, Shape::K, kThreads>,
        static_cast<const unsigned char*>(on),
        static_cast<const double*>(idle), static_cast<const double*>(peak),
        static_cast<const double*>(cpk), static_cast<const double*>(hyp),
        static_cast<const double*>(fl), static_cast<const double*>(ce),
        static_cast<const double*>(w),
        static_cast<const unsigned char*>(act),
        static_cast<const double*>(cres), static_cast<const double*>(budget),
        static_cast<const unsigned char*>(enabled),
        static_cast<const double*>(caps_in), static_cast<double*>(caps_out),
        static_cast<unsigned char*>(did_out), static_cast<int*>(rounds_out),
        H, J, iters, threshold, max_iters, min_transfer);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}
