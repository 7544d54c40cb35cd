// K5 on the tensor cores: causal GQA flash attention backward in bfloat16,
// from the forward's log-sum-exp.
//
// Replaces, for bf16 at D 64, 112 and 128, the TPU kernel
// flash_attention_bwd_kernel in src/repro/kernels/flash_attention/
// kernel_bwd.py:125: its dk/dv kernel (_dkdv_kernel, body :43, pallas_call
// :161) and its dq kernel (_dq_kernel, body :84, pallas_call :195).
// flash_bwd.cu keeps float32, the other head dims and the pitches that TMA
// cannot read (kernel_bwd.py's plan chooses, never by trying).
//
// The math is flash_bwd.cu's: with scale = 1 / sqrt(D), p = exp(q.k scale
// - lse) on the keys inside Skv and, when causal, at or before q_offset +
// row (0 elsewhere, as kernel_bwd.py:_mask), D = rowsum(dO O) (the
// wrapper's float32 op), dv = p^T dO, dp = dO v^T, ds = p (dp - D) scale,
// dk = ds^T q, dq = ds k; dk and dv summed over each KV head's group.
//
// Bound on an H100: 10 B Hq D operations a causal pair (the five products)
// against 3.35 TB/s for q, k, v, o, dO, lse, dq, dk and dv: operations
// bound it, so every product runs on the tensor cores (wgmma), fed by TMA.
// The two kernels recompute s and dp (14 B Hq D a pair in all) so that
// the dq sum needs no atomics: each output element is one thread's sum in
// a fixed order, and a launch gives the same bits every time.
//
// dk/dv kernel: one block per (128 keys, KV head, batch), the causal
//   blocks with the most query tiles first.  A producer warpgroup (one
//   thread issuing) TMA-loads K and V once, then keeps a ring of (Q, dO)
//   tiles of 64 query rows (32 at D 112 and 128) with their lse and D
//   rows in flight, walking the group's Hq / Hkv query heads and, for
//   each, the query tiles that can see the block's keys.  Two consumer
//   warpgroups own 64 keys each:
//     S^T = K Q^T, dP^T = V dO^T      wgmma SS, both K-major over D;
//     P^T = exp(S^T scale - lse),     float32 registers (masked to 0 only
//     dS^T = P^T (dP^T - D) scale       on the diagonal and ragged tiles);
//     dV += P^T dO, dK += dS^T Q      wgmma RS: P^T and dS^T in registers
//                                     as A, each split into a bf16 high
//                                     part and remainder (two products,
//                                     kept to 2^-16: bf16 alone misses
//                                     the plain version's tolerance where
//                                     few terms cancel), dO and Q read
//                                     MN-major from the ring.
//   No score tile goes through shared memory.  dK and dV stay in float32
//   registers across the group and all its query tiles and are stored
//   once, clipped at Skv and D.
// dq kernel: one block per (192 query rows at D 64, 128 at D 112 and
//   128; query head; batch), the causal blocks with the most key tiles
//   first; Q and dO loaded once, K and V tiles of 64 keys through the ring
//   up to the causal diagonal.  Each of its three (two) consumer
//   warpgroups owns 64 rows: S = Q K^T and dP = dO V^T (SS),
//   dS in registers, dQ += dS K (RS, dS split as above, K read MN-major);
//   dQ stored once.
#include "flash_tc.cuh"

namespace fa_tc {
namespace {

constexpr int kKTile = 64;     // keys of a dq ring stage

template <int DP>
struct DkdvLayout {
  static constexpr int kNb = DP / 64;
  static constexpr int kRows = 128;        // keys: two warpgroups
  // Query rows of a ring stage: 64 at D 64, 32 at D 112 and 128 (where dK
  // and dV take 128 registers a thread).  Q's and dO's boxes stay 8,192
  // bytes apart either way, the MN-major stride of flash_tc.cuh.
  static constexpr int kQTile = DP == 64 ? 64 : 32;
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr int kKV = kNb * kRows * kRowBytes;    // K, V: [box][rows]
  static constexpr int kTile = kNb * kBox;               // Q, dO: [box][64]
  static constexpr int kRowsBytes = kQTile * 4;          // lse or D rows
  static constexpr int kStageLoad = 2 * kNb * kQTile * kRowBytes +
                                    2 * kRowsBytes;
  static constexpr int kStage = 2 * kTile + kAlign;      // 1024-aligned
  static constexpr int kSmem = 2 * kKV + kStages * kStage + kAlign;
};

template <int DP>
struct DqLayout {
  static constexpr int kNb = DP / 64;
  // Consumer warpgroups (64 query rows each): three at D 64, whose tiles
  // need about 130 registers a thread, so that a third hides the others'
  // waits; two at D 112 and 128 (dQ alone takes 64 registers).
  static constexpr int kCons = DP == 64 ? 3 : 2;
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr int kRows = 64 * kCons;               // query rows
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr int kQ = kNb * kRows * kRowBytes;     // Q, dO: [box][rows]
  static constexpr int kTile = kNb * kBox;               // K, V: [box][64]
  static constexpr int kStage = 2 * kTile;
  static constexpr int kSmem = 2 * kQ + kStages * kStage + kAlign;
};

struct BwdArgs {
  const float* lse;   // (B, Hq, Sq) with row pitch sqp
  const float* dsum;  // the same
  bf16* dq;           // (B, Sq, Hq, D), packed
  bf16* dk;           // (B, Skv, Hkv, D), packed
  bf16* dv;
  long long sqp;
  int Sq, Skv, Hq, Hkv, D, q_offset, causal;
  float scale;
};

// The first query tile of `tile` rows that can see keys from k0 on.
__device__ __forceinline__ int first_q_tile(const BwdArgs& a, int k0,
                                            int tile) {
  return a.causal && k0 > a.q_offset ? (k0 - a.q_offset) / tile : 0;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap dmap,
                             const __grid_constant__ CUtensorMap lmap,
                             const __grid_constant__ CUtensorMap smap,
                             const BwdArgs a) {
  using L = DkdvLayout<DP>;
  constexpr int kQTile = L::kQTile;
  constexpr int kKvRows = L::kRows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[L::kStages], empty[L::kStages],
      kvbar;
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1u);
  const uint32_t ring = base + 2 * L::kKV;
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kKvRows;
  const int G = a.Hq / a.Hkv;
  const int iq0 = first_q_tile(a, k0, kQTile);
  const int nq = (a.Sq + kQTile - 1) / kQTile;
  const int per_head = nq > iq0 ? nq - iq0 : 0;
  const int n = G * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), 2);
    }
    bar_init(smem_u32(&kvbar), 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      tma_prefetch(&dmap);
      tma_prefetch(&lmap);
      tma_prefetch(&smap);
      bar_expect(smem_u32(&kvbar), 2 * L::kKV);
      for (int c = 0; c < L::kNb; ++c) {
        tma_load4(base + c * kKvRows * kRowBytes, &kmap, smem_u32(&kvbar),
                  64 * c, hk, k0, b);
        tma_load4(base + L::kKV + c * kKvRows * kRowBytes, &vmap,
                  smem_u32(&kvbar), 64 * c, hk, k0, b);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % L::kStages;
        if (it >= L::kStages)
          bar_wait(smem_u32(&empty[s]), (it / L::kStages - 1) & 1);
        const int h = hk * G + it / per_head;
        const int q0 = (iq0 + it % per_head) * kQTile;
        const uint32_t qt = ring + s * L::kStage, dt = qt + L::kTile;
        const uint32_t rows = dt + L::kTile;
        const uint32_t bar = smem_u32(&full[s]);
        bar_expect(bar, L::kStageLoad);
        for (int c = 0; c < L::kNb; ++c) {
          tma_load4(qt + c * kBox, &qmap, bar, 64 * c, h, q0, b);
          tma_load4(dt + c * kBox, &dmap, bar, 64 * c, h, q0, b);
        }
        tma_load(rows, &lmap, bar, q0, h, b);
        tma_load(rows + L::kRowsBytes, &smap, bar, q0, h, b);
      }
    }
    return;
  }

  regs_inc<232>();
  const int t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int kw0 = k0 + 64 * wg;                 // the warpgroup's first key
  const int key0 = kw0 + 16 * (t / 32) + g;     // and key0 + 8
  const float sl2 = a.scale * kLog2e;
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  bar_wait(smem_u32(&kvbar), 0);

  // Each query tile: S^T and dP^T issued together, P formed while dP^T
  // runs, then dS, then dV += P^T dO and dK += dS^T Q issued together
  // (issuing dV before forming dS keeps more registers live: slower).
  // Accumulators are set before the products' fence and read only after
  // their wait (ptxas serializes every wgmma of a kernel that writes one
  // while a product is in flight).
  for (int it = 0; it < n; ++it) {
    const int s = it % L::kStages;
    bar_wait(smem_u32(&full[s]), (it / L::kStages) & 1);
    const int q0 = (iq0 + it % per_head) * kQTile;
    const bool live =
        kw0 < a.Skv && !(a.causal && kw0 > a.q_offset + q0 + kQTile - 1);
    if (live) {
      const uint32_t qt = ring + s * L::kStage, dt = qt + L::kTile;
      const float* lse_s = reinterpret_cast<const float*>(
          smem_raw + (dt + L::kTile - smem_u32(smem_raw)));
      const float* dsum_s = lse_s + kQTile;
      float st[kQTile / 2], dpt[kQTile / 2];
#pragma unroll
      for (int i = 0; i < kQTile / 2; ++i) st[i] = dpt[i] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<kQTile, 0, 0>(st, kmajor(base, kKvRows, 64 * wg, kk),
                             kmajor(qt, 64, 0, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<kQTile, 0, 0>(dpt,
                             kmajor(base + L::kKV, kKvRows, 64 * wg, kk),
                             kmajor(dt, 64, 0, kk));
      wgmma_commit();
      fence_regs(st);
      fence_regs(dpt);
      wgmma_wait<1>();
      fence_regs(st);

      const bool edge = q0 + kQTile > a.Sq || kw0 + 64 > a.Skv ||
                        (a.causal && kw0 + 63 > a.q_offset + q0);
#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j) {
        const int col = 8 * j + 2 * c4;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = ex2(fmaf(st[i], sl2, -(e % 2 ? ls.y : ls.x) * kLog2e));
          if (edge) {
            const int key = key0 + 8 * (e / 2), query = q0 + col + e % 2;
            if (key >= a.Skv || query >= a.Sq ||
                (a.causal && key > a.q_offset + query))
              p = 0.f;
          }
          st[i] = p;
        }
      }
      uint32_t ph[kQTile / 16][4], pl[kQTile / 16][4];
      uint32_t sh[kQTile / 16][4], sl[kQTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        split_a(ph[kk], pl[kk], st, kk);
      wgmma_wait<0>();
      fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < kQTile / 8; ++j) {
        const float2 ds = *reinterpret_cast<const float2*>(dsum_s + 8 * j +
                                                           2 * c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dpt[i] = st[i] * (dpt[i] - (e % 2 ? ds.y : ds.x)) * a.scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk)
        split_a(sh[kk], sl[kk], dpt, kk);
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        const uint64_t d_o = mnmajor(dt, L::kNb, kk);
        mma_rs<DP, 1>(dv, ph[kk], d_o);
        mma_rs<DP, 1>(dv, pl[kk], d_o);
      }
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        const uint64_t dq_ = mnmajor(qt, L::kNb, kk);
        mma_rs<DP, 1>(dk, sh[kk], dq_);
        mma_rs<DP, 1>(dk, sl[kk], dq_);
      }
      wgmma_commit();
      fence_regs(dk);
      fence_regs(dv);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < kQTile / 16; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
        fence_regs(sh[kk]);
        fence_regs(sl[kk]);
      }
    }
    if (t == 0) bar_arrive(smem_u32(&empty[s]));
  }

  const long long head = static_cast<long long>(b) * a.Skv * a.Hkv + hk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.Skv) continue;
    const long long off = (head + static_cast<long long>(key) * a.Hkv) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * c4;
      if (col >= a.D) continue;
      *reinterpret_cast<uint32_t*>(a.dk + off + col) =
          pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + off + col) =
          pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(DqLayout<DP>::kThreads, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap dmap,
                           const BwdArgs a) {
  using L = DqLayout<DP>;
  constexpr int kQRows = L::kRows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[L::kStages], empty[L::kStages],
      qbar;
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1u);
  const uint32_t ring = base + 2 * L::kQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kQRows;
  const int hk = h / (a.Hq / a.Hkv);
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, a.q_offset + q0 + kQRows);
  const int nkv = (kv_end + kKTile - 1) / kKTile;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), L::kCons);
    }
    bar_init(smem_u32(&qbar), 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == L::kCons) {
    if constexpr (L::kCons == 3) regs_dec<24>();
    else regs_dec<40>();
    if (threadIdx.x == 128 * L::kCons) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      tma_prefetch(&dmap);
      bar_expect(smem_u32(&qbar), 2 * L::kQ);
      for (int c = 0; c < L::kNb; ++c) {
        tma_load4(base + c * kQRows * kRowBytes, &qmap, smem_u32(&qbar),
                  64 * c, h, q0, b);
        tma_load4(base + L::kQ + c * kQRows * kRowBytes, &dmap,
                  smem_u32(&qbar), 64 * c, h, q0, b);
      }
      for (int it = 0; it < nkv; ++it) {
        const int s = it % L::kStages;
        if (it >= L::kStages)
          bar_wait(smem_u32(&empty[s]), (it / L::kStages - 1) & 1);
        const uint32_t kt = ring + s * L::kStage, vt = kt + L::kTile;
        const uint32_t bar = smem_u32(&full[s]);
        bar_expect(bar, L::kStage);
        for (int c = 0; c < L::kNb; ++c) {
          tma_load4(kt + c * kBox, &kmap, bar, 64 * c, hk, it * kKTile, b);
          tma_load4(vt + c * kBox, &vmap, bar, 64 * c, hk, it * kKTile, b);
        }
      }
    }
    return;
  }

  if constexpr (L::kCons == 3) regs_inc<160>();
  else regs_inc<232>();
  const int t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int qw0 = q0 + 64 * wg;                  // the warpgroup's first row
  const int row0 = qw0 + 16 * (t / 32) + g;      // and row0 + 8
  const float sl2 = a.scale * kLog2e;
  float lse2[2], dd[2];
  const long long rows = (static_cast<long long>(b) * a.Hq + h) * a.sqp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < a.Sq ? a.lse[rows + row] * kLog2e : 0.f;
    dd[r] = row < a.Sq ? a.dsum[rows + row] : 0.f;
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  bar_wait(smem_u32(&qbar), 0);

  // Each key tile: S and dP issued together, P formed while dP runs,
  // then dS and dQ += dS K.  Accumulators are set before the products'
  // fence and read only after their wait (as in the dk/dv kernel).
  for (int it = 0; it < nkv; ++it) {
    const int s = it % L::kStages;
    bar_wait(smem_u32(&full[s]), (it / L::kStages) & 1);
    const int k0 = it * kKTile;
    const bool live =
        qw0 < a.Sq && !(a.causal && k0 > a.q_offset + qw0 + 63);
    if (live) {
      const uint32_t kt = ring + s * L::kStage, vt = kt + L::kTile;
      float sc[kKTile / 2], dp[kKTile / 2];
#pragma unroll
      for (int i = 0; i < kKTile / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<kKTile, 0, 0>(sc, kmajor(base, kQRows, 64 * wg, kk),
                             kmajor(kt, kKTile, 0, kk));
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<kKTile, 0, 0>(dp, kmajor(base + L::kQ, kQRows, 64 * wg, kk),
                             kmajor(vt, kKTile, 0, kk));
      wgmma_commit();
      fence_regs(sc);
      fence_regs(dp);
      wgmma_wait<1>();
      fence_regs(sc);

      const bool edge = k0 + kKTile > a.Skv ||
                        (a.causal && k0 + kKTile - 1 > a.q_offset + qw0);
#pragma unroll
      for (int i = 0; i < kKTile / 2; ++i) {
        const int r = (i % 4) / 2;
        float p = ex2(fmaf(sc[i], sl2, -lse2[r]));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * c4 + (i % 2);
          if (key >= a.Skv || (a.causal && key > a.q_offset + row0 + 8 * r))
            p = 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kKTile / 2; ++i)
        dp[i] = sc[i] * (dp[i] - dd[(i % 4) / 2]) * a.scale;
      uint32_t sh[kKTile / 16][4], sl[kKTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk)
        split_a(sh[kk], sl[kk], dp, kk);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        const uint64_t dk_ = mnmajor(kt, L::kNb, kk);
        mma_rs<DP, 1>(dq, sh[kk], dk_);
        mma_rs<DP, 1>(dq, sl[kk], dk_);
      }
      wgmma_commit();
      fence_regs(dq);
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        fence_regs(sh[kk]);
        fence_regs(sl[kk]);
      }
    }
    if (t == 0) bar_arrive(smem_u32(&empty[s]));
  }

  const long long head = static_cast<long long>(b) * a.Sq * a.Hq + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.Sq) continue;
    const long long off = (head + static_cast<long long>(row) * a.Hq) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * c4;
      if (col < a.D)
        *reinterpret_cast<uint32_t*>(a.dq + off + col) =
            pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

// A rank-3 float32 map over (Sq, Hq, B) rows with pitch sqp, read in
// boxes of `tile` values (TMA's zeros past Sq).
int map_rows(CUtensorMap* map, const float* ptr, long long sqp, int Sq,
             int Hq, int B, int tile) {
  const long long dims[3] = {Sq, Hq, B};
  const long long strides[2] = {sqp * 4, sqp * Hq * 4};
  const int box[3] = {tile, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

struct BwdOperands {
  Operand q, k, v, dout;
};

template <int DP>
int launch_dkdv(const BwdOperands& o, const BwdArgs& a, int B,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm, lm, sm;
  constexpr int kQTile = DkdvLayout<DP>::kQTile;
  int rc = map_bshd(&qm, o.q, B, a.Sq, a.Hq, a.D, kQTile);
  if (rc == 0) rc = map_bshd(&dm, o.dout, B, a.Sq, a.Hq, a.D, kQTile);
  constexpr int kKvRows = DkdvLayout<DP>::kRows;
  if (rc == 0) rc = map_bshd(&km, o.k, B, a.Skv, a.Hkv, a.D, kKvRows);
  if (rc == 0) rc = map_bshd(&vm, o.v, B, a.Skv, a.Hkv, a.D, kKvRows);
  if (rc == 0) rc = map_rows(&lm, a.lse, a.sqp, a.Sq, a.Hq, B, kQTile);
  if (rc == 0) rc = map_rows(&sm, a.dsum, a.sqp, a.Sq, a.Hq, B, kQTile);
  if (rc != 0) return rc;
  const int smem = DkdvLayout<DP>::kSmem;
  const cudaError_t attr = allow_smem<flash_bwd_dkdv_tc_kernel<DP>>(smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.Hkv, B, (a.Skv + kKvRows - 1) / kKvRows);
  flash_bwd_dkdv_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, dm, lm, sm, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq(const BwdOperands& o, const BwdArgs& a, int B,
              cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm;
  constexpr int kQRows = DqLayout<DP>::kRows;
  int rc = map_bshd(&qm, o.q, B, a.Sq, a.Hq, a.D, kQRows);
  if (rc == 0) rc = map_bshd(&dm, o.dout, B, a.Sq, a.Hq, a.D, kQRows);
  if (rc == 0) rc = map_bshd(&km, o.k, B, a.Skv, a.Hkv, a.D, kKTile);
  if (rc == 0) rc = map_bshd(&vm, o.v, B, a.Skv, a.Hkv, a.D, kKTile);
  if (rc != 0) return rc;
  const int smem = DqLayout<DP>::kSmem;
  const cudaError_t attr = allow_smem<flash_bwd_dq_tc_kernel<DP>>(smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.Hq, B, (a.Sq + kQRows - 1) / kQRows);
  flash_bwd_dq_tc_kernel<DP><<<grid, DqLayout<DP>::kThreads, smem, stream>>>(
      qm, km, vm, dm, a);
  return static_cast<int>(cudaGetLastError());
}

int run(bool dkdv, const BwdOperands& o, const BwdArgs& a, int B,
        cudaStream_t s) {
  if (a.D == 64) return dkdv ? launch_dkdv<64>(o, a, B, s)
                             : launch_dq<64>(o, a, B, s);
  if (a.D == 112 || a.D == 128) return dkdv ? launch_dkdv<128>(o, a, B, s)
                                            : launch_dq<128>(o, a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int dkdv_smem_bytes(int dp) {
  return dp == 64 ? DkdvLayout<64>::kSmem : DkdvLayout<128>::kSmem;
}

int dq_smem_bytes(int dp) {
  return dp == 64 ? DqLayout<64>::kSmem : DqLayout<128>::kSmem;
}

}  // namespace fa_tc

// K5 in the tensor-core regime (bf16, D 64, 112 or 128).  q, k, v and dO
// are (B, S, H, D) with D contiguous and the given element strides (each
// a multiple of 8, the bases 16-byte aligned: kernel_bwd.py's plan
// checks); lse and dsum are float32 (B, Hq, Sq) with row pitch sqp (a
// multiple of 4); dq is a packed (B, Sq, Hq, D), dk and dv packed
// (B, Skv, Hkv, D).  The dk/dv kernel writes dk and dv, the dq kernel dq;
// each entry point launches one kernel.
#define BWD_TC_ARGS                                                          \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *dsum, void *dq, void *dk, void *dv,       \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,        \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,        \
      long long v_sh, long long do_sb, long long do_ss, long long do_sh,     \
      long long sqp, int B, int Sq, int Skv, int Hq, int Hkv, int D,         \
      int q_offset, int causal, float scale, void *stream

namespace {

int bwd_tc(bool dkdv, BWD_TC_ARGS) {
  using namespace fa_tc;
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0 || sqp < Sq)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdOperands o{{q, q_sb, q_ss, q_sh},
                      {k, k_sb, k_ss, k_sh},
                      {v, v_sb, v_ss, v_sh},
                      {dout, do_sb, do_ss, do_sh}};
  const BwdArgs a{static_cast<const float*>(lse),
                  static_cast<const float*>(dsum), static_cast<bf16*>(dq),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), sqp, Sq,
                  Skv, Hq, Hkv, D, q_offset, causal, scale};
  return run(dkdv, o, a, B, static_cast<cudaStream_t>(stream));
}

}  // namespace

#define BWD_TC_CALL                                                          \
  q, k, v, dout, lse, dsum, dq, dk, dv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,  \
      v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, sqp, B, Sq, Skv, Hq, Hkv, D,    \
      q_offset, causal, scale, stream

extern "C" int flash_attention_bwd_dkdv_tc(BWD_TC_ARGS, int device) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return bwd_tc(true, BWD_TC_CALL);
}

extern "C" int flash_attention_bwd_dq_tc(BWD_TC_ARGS, int device) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return bwd_tc(false, BWD_TC_CALL);
}
