// K4 on the tensor cores: causal GQA flash attention forward in bfloat16,
// with the log-sum-exp.
//
// Replaces, for bf16 at D 64, 112 and 128, the TPU kernel
// flash_attention_kernel / _flash_kernel in
// src/repro/kernels/flash_attention/kernel.py:83 (body :32, pallas_call
// :111); flash_fwd.cu keeps float32, the other head dims and the pitches
// that TMA cannot read (kernel.py's plan chooses, never by trying).
//
// Bound on an H100: 4 B Hq D operations a causal pair against 3.35 TB/s
// for q, k, v and o: at path T's layer (B 4, S 4096, 36 heads of 64) the
// operations bound it by 7x, so the products run on the tensor cores
// (wgmma), fed by TMA.
//
// Design: one block per (128 query rows, query head, batch), the causal
// blocks with the most key tiles launched first.  A producer warpgroup
// (one thread issuing; its registers handed to the consumers) TMA-loads
// the block's Q once and then K and V tiles of 128 keys (64 at D 112 and
// 128) into a ring of kStages stages, each guarded by a full and an empty
// mbarrier.  Two consumer warpgroups own 64 query rows each.  For each key
// tile:
//   S = Q K^T                wgmma RS: the warpgroup's rows of Q held in
//                            registers for the whole block, K read
//                            K-major over D;
//   mask, online softmax     in float32 registers: the running (m, l, acc)
//                            of the reference (flash_fwd.cu:7-12), masked
//                            scores at -1e30, exp2 of scores scaled by
//                            log2(e) / sqrt(D);
//   O += P V                 wgmma RS: P in registers as the A operand,
//                            split into a bf16 high part and remainder
//                            (two products, P kept to 2^-16: bf16 P alone
//                            misses the plain version's bf16 tolerance on
//                            rows that see few keys), V read MN-major.
// Only tiles that cross the causal diagonal or the ragged end of the keys
// are masked; tiles wholly past the diagonal are never loaded, and a
// warpgroup skips the products of a tile whose keys all lie past its rows.
// The epilogue divides by l (clamped at 1e-30), stores O in bf16 clipped
// at Sq and D, and the log-sum-exp m / sqrt(D) + log(l) in natural log,
// float32, as K5 and the plain version read it.  Each output is one
// thread's sums in a fixed order, so a launch gives the same bits every
// time.
#include "flash_tc.cuh"

namespace fa_tc {
namespace {

constexpr int kStages = 2;

template <int DP>
struct FwdLayout {
  static constexpr int kNb = DP / 64;
  static constexpr int kRows = 128;        // query rows: two warpgroups
  // Keys of a tile: 128 at D 64, 64 at D 112 and 128 (where O takes 64
  // registers a thread and the split P another 64 at 128 keys).
  static constexpr int kKeys = DP == 64 ? 128 : 64;
  static constexpr int kQ = kNb * kRows * kRowBytes;   // [box][128 rows]
  static constexpr int kK = kNb * kKeys * kRowBytes;   // [box][keys]
  static constexpr int kV = kNb * kKeys * kRowBytes;   // [half][box][64]
  static constexpr int kStage = kK + kV;
  static constexpr int kSmem = kQ + kStages * kStage + kAlign;
};

struct FwdArgs {
  bf16* o;           // (B, Sq, Hq, D), packed
  float* lse;        // (B, Hq, Sq), packed
  int Sq, Skv, Hq, Hkv, D, q_offset, causal;
  float scale;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const FwdArgs a) {
  using L = FwdLayout<DP>;
  constexpr int kKeys = L::kKeys;
  constexpr int kRows = L::kRows;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1u);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const int hk = h / (a.Hq / a.Hkv);
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, a.q_offset + q0 + kRows);
  const int nkv = (kv_end + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), 2);
    }
    bar_init(smem_u32(&qbar), 1);
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    regs_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      bar_expect(smem_u32(&qbar), L::kQ);
      for (int c = 0; c < L::kNb; ++c)
        tma_load4(base + c * kRows * kRowBytes, &qmap, smem_u32(&qbar),
                  64 * c, h, q0, b);
      for (int it = 0; it < nkv; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          bar_wait(smem_u32(&empty[s]), (it / kStages - 1) & 1);
        const uint32_t kt = base + L::kQ + s * L::kStage, vt = kt + L::kK;
        const uint32_t bar = smem_u32(&full[s]);
        const int k0 = it * kKeys;
        bar_expect(bar, L::kStage);
        for (int c = 0; c < L::kNb; ++c)
          tma_load4(kt + c * kKeys * kRowBytes, &kmap, bar, 64 * c, hk, k0,
                    b);
        for (int half = 0; half < kKeys / 64; ++half)
          for (int c = 0; c < L::kNb; ++c)
            tma_load4(vt + (half * L::kNb + c) * kBox, &vmap, bar, 64 * c,
                      hk, k0 + 64 * half, b);
      }
    }
    return;
  }

  regs_inc<232>();
  const int t = threadIdx.x % 128, lane = t % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int row0 = 64 * wg + 16 * (t / 32) + g;   // and row0 + 8
  const int qw0 = q0 + 64 * wg;                   // the warpgroup's first row
  const float sl2 = a.scale * kLog2e;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  bar_wait(smem_u32(&qbar), 0);
  // The warpgroup's rows of Q, held in registers for every S = Q K^T.
  uint32_t qa[DP / 16][4];
  load_a<DP>(qa, base, kRows, 64 * wg);

  for (int it = 0; it < nkv; ++it) {
    const int s = it % kStages;
    bar_wait(smem_u32(&full[s]), (it / kStages) & 1);
    const int k0 = it * kKeys;
    const bool live =
        qw0 < a.Sq && !(a.causal && k0 > a.q_offset + qw0 + 63);
    if (live) {
      const uint32_t kt = base + L::kQ + s * L::kStage, vt = kt + L::kK;
      // Accumulators are set here, before the products' fence, and read
      // only after their wait: ptxas serializes every wgmma of a kernel
      // that writes one while a product is in flight.
      float sc[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_rs<kKeys, 0>(sc, qa[kk], kmajor(kt, kKeys, 0, kk));
      wgmma_commit();
      fence_regs(sc);
      wgmma_wait<0>();
      fence_regs(sc);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) fence_regs(qa[kk]);

      if (k0 + kKeys > a.Skv ||
          (a.causal && k0 + kKeys - 1 > a.q_offset + qw0)) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * c4 + (i % 2);
          const int qpos = a.q_offset + q0 + row0 + 8 * ((i % 4) / 2);
          if (key >= a.Skv || (a.causal && key > qpos)) sc[i] = kNegInf;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i)
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = ex2((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        ms[r] = mx[r] * sl2;
        l[r] *= alpha;
#pragma unroll
        for (int i = 0; i < DP / 2; ++i)
          if ((i % 4) / 2 == r) o[i] *= alpha;
      }
      uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], sl2, -ms[(i % 4) / 2]));
        l[(i % 4) / 2] += sc[i];
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        split_a(ph[kk], pl[kk], sc, kk);

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t dv = mnmajor(vt, L::kNb, kk);
        mma_rs<DP, 1>(o, ph[kk], dv);
        mma_rs<DP, 1>(o, pl[kk], dv);
      }
      wgmma_commit();
      fence_regs(o);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
    }
    if (t == 0) bar_arrive(smem_u32(&empty[s]));
  }

  bf16* og = a.o + (static_cast<long long>(b) * a.Sq * a.Hq + h) * a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + row0 + 8 * r;
    if (row >= a.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    bf16* orow = og + static_cast<long long>(row) * a.Hq * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * c4;
      if (col < a.D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * j + 2 * r] / lc, o[4 * j + 2 * r + 1] / lc);
    }
    if (c4 == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + row] =
          m[r] * a.scale + logf(lc);
  }
}

template <int DP>
int launch_fwd(const Operand& q, const Operand& k, const Operand& v,
               const FwdArgs& a, int B, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  constexpr int kRows = FwdLayout<DP>::kRows;
  int rc = map_bshd(&qm, q, B, a.Sq, a.Hq, a.D, kRows);
  if (rc == 0)
    rc = map_bshd(&km, k, B, a.Skv, a.Hkv, a.D, FwdLayout<DP>::kKeys);
  if (rc == 0) rc = map_bshd(&vm, v, B, a.Skv, a.Hkv, a.D, 64);
  if (rc != 0) return rc;
  const int smem = FwdLayout<DP>::kSmem;
  const cudaError_t attr = allow_smem<flash_fwd_tc_kernel<DP>>(smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.Hq, B, (a.Sq + kRows - 1) / kRows);
  flash_fwd_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int fwd_smem_bytes(int dp) {
  return dp == 64 ? FwdLayout<64>::kSmem : FwdLayout<128>::kSmem;
}

}  // namespace fa_tc

// K4 in the tensor-core regime (bf16, D 64, 112 or 128).  q, k and v are
// (B, S, H, D) with D contiguous and the given element strides (each a
// multiple of 8, the bases 16-byte aligned: kernel.py's plan checks);
// o is a packed (B, Sq, Hq, D) and lse a packed (B, Hq, Sq).
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int q_offset, int causal, float scale, int device, void* stream) {
  using namespace fa_tc;
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Skv,
                  Hq, Hkv, D, q_offset, causal, scale};
  const Operand qo{q, q_sb, q_ss, q_sh}, ko{k, k_sb, k_ss, k_sh},
      vo{v, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_fwd<64>(qo, ko, vo, a, B, s);
  if (D == 112 || D == 128) return launch_fwd<128>(qo, ko, vo, a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A tensor-core launch's dynamic shared memory, to hold kernel.py's plan
// against: kernel 0 is K4's, 1 K5's dk/dv kernel, 2 its dq kernel.
extern "C" long long flash_attention_tc_smem_bytes(int kernel, int d) {
  using namespace fa_tc;
  const int dp = d == 64 ? 64 : 128;
  if (kernel == 0) return fwd_smem_bytes(dp);
  if (kernel == 1) return dkdv_smem_bytes(dp);
  return dq_smem_bytes(dp);
}
