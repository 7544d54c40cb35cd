// K7's two bfloat16 regimes on the tensor cores (wgmma fed by TMA).
//
// Wide regime (C > 64: a prefill's expert buckets), bound by operations.
// gmm_wide_kernel computes 128 (C) x 256 (F) tiles of out[e] = x[e] w[e]:
// a 64-deep stage moves 48 KB through L2 for 4.2 MFLOP (a 128 x 128 tile
// would move 32 KB for 2.1, more than L2 feeds at the tensor cores' rate).
// The grid is persistent: one block an SM walks the tiles
// (expert-major, then rows of C, then columns of F, so blocks that share
// x's rows and an expert's weight run together out of L2).  Of its 384
// threads, a producer warpgroup (one thread issuing, its registers handed
// to the consumers with setmaxnreg) keeps TMA loads of each 64-deep stage
// (x's 128 x 64 box, K-major, and w's 64 x 256 as four 64 x 64 boxes,
// MN-major: w is read as it lies in memory, F contiguous, through wgmma's
// transposed B) in flight in a ring of kWideStages stages, each guarded by
// a full and an empty mbarrier, running on across tiles, so the next
// tile's loads start while this tile's epilogue runs.  Two consumer
// warpgroups each own 64 rows and run four wgmma m64n256k16 a stage into
// 128 float32 accumulators a thread, keep one stage's products in flight
// (wgmma.wait_group 1) and release the stage before.  The epilogue rounds
// to bfloat16 into two swizzled 64 x 64 buffers a warpgroup and stores
// them with TMA (which clips rows past C and columns past F), so the
// stores drain while the next tile's products run (stores straight from
// registers, 4 bytes a thread, would hold the consumers for the whole
// epilogue, which matters most for the down product's 16 stages a tile).
// The kernel is a template on each operand's majorness, so the backward's
// transposed operands are read in place, with no copy (ops.py): dX = dY W^T
// reads W^T K-major, as four 64 x 64 boxes of its packed D axis a stage
// (the layout of x's rows), and dW = X^T dY reads X^T MN-major, as two
// 64 x 64 boxes of its packed C axis a stage (the layout of w's boxes,
// through wgmma's transposed A).  A stage moves the same bytes in every
// layout.
//
// Narrow regime (C <= 64: a decode step's buckets), bound by bytes: every
// expert's weight is read once.  gmm_narrow_kernel swaps the operands,
// out[e]^T = w[e]^T x[e]^T, so that 64 columns of F fill the instruction's
// 64 rows and the C tokens are its N, rounded up to 8, 16, 32 or 64
// (wgmma m64nNk16: no rows of dead tokens).  One block per (64 columns of
// F, expert): a producer warp streams w's 64 x 64 boxes (MN-major A,
// wgmma's transposed A) and x's N x 64 box (K-major B) through
// kNarrowStages stages, so a block keeps up to 40 KB of weights in flight
// and two to four blocks share an SM; one consumer warpgroup multiplies.
// Path M's decode step has 64 x 16 = 1,024 blocks.  The whole D loop runs
// in the block, so there is no split of D, no second pass and no atomic.
//
// Both regimes read through rank-3 tensor maps over (E, C, D) and
// (E, D, F), built on the host for each launch: every element past C, D
// or F arrives as TMA's zero fill and never as the next expert's rows.
// Each output element is one thread's sum in a fixed order, so a launch
// gives the same bits every time.
#include "gmm.cuh"
#include "sm90.cuh"

namespace k7 {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kRowBytes = 128;             // a box row: 64 bf16
constexpr int kDepth = 64;                 // contraction depth of a stage
constexpr int kBox = 64 * kRowBytes;       // a 64 x 64 box, 8,192 bytes
constexpr int kAlign = 1024;               // swizzle atom alignment

constexpr int kWideM = 128, kWideN = 256;
constexpr int kWideStages = 4;
constexpr int kWideConsumers = 2;          // warpgroups, and one producer
constexpr int kWideThreads = 128 * (kWideConsumers + 1);
constexpr int kWideStageBytes = kWideM * kRowBytes + kWideN / 64 * kBox;

constexpr int kNarrowF = 64;
constexpr int kNarrowStages = 6;
constexpr int kNarrowThreads = 128 + 32;

// Descriptor strides (leading, stride byte offsets) of the K-major operand
// (x: 8-row groups 1,024 bytes apart; the leading offset unused) and of
// the MN-major one (w: 64-wide atoms one box apart, 8-row groups of the
// contraction index 1,024 bytes apart), as sm90.cuh sets out.
constexpr uint32_t kKLbo = 16, kKSbo = 1024;
constexpr uint32_t kMnLbo = kBox, kMnSbo = 1024;

__host__ __device__ constexpr int narrow_n(int C) {
  return C <= 8 ? 8 : C <= 16 ? 16 : C <= 32 ? 32 : 64;
}

__host__ __device__ constexpr int narrow_stage_bytes(int n) {
  return kBox + n * kRowBytes;
}

// XT: x is read MN-major (its C axis packed: X^T of the backward's dW),
// else K-major; WT: w is read K-major (its D axis packed: W^T of dX), else
// MN-major.
template <int XT, int WT>
__global__ void __launch_bounds__(kWideThreads, 1)
    gmm_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap omap, int E, int C,
                    int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kWideStages], empty[kWideStages];
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1u);
  const uint32_t ebase = base + kWideStages * kWideStageBytes;
  const int nn = (F + kWideN - 1) / kWideN, nm = (C + kWideM - 1) / kWideM;
  const int tiles = nn * nm * E;
  const int nk = (D + kDepth - 1) / kDepth;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), kWideConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == kWideConsumers) {
    // Producer warpgroup: one thread issues every copy, tile after tile,
    // the ring's stages and phases running on across tiles.
    regs_dec<40>();
    if (threadIdx.x == 128 * kWideConsumers) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      tma_prefetch(&omap);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % nn * kWideN, m0 = tile / nn % nm * kWideM;
        const int e = tile / (nn * nm);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kWideStages;
          if (it >= kWideStages)
            bar_wait(smem_u32(&empty[s]), (it / kWideStages - 1) & 1);
          const uint32_t a = base + s * kWideStageBytes;
          const uint32_t b = a + kWideM * kRowBytes;
          const uint32_t bar = smem_u32(&full[s]);
          bar_expect(bar, kWideStageBytes);
          if constexpr (XT) {
#pragma unroll
            for (int q = 0; q < kWideM / 64; ++q)
              tma_load(a + q * kBox, &xmap, bar, m0 + 64 * q, kt * kDepth, e);
          } else {
            tma_load(a, &xmap, bar, kt * kDepth, m0, e);
          }
#pragma unroll
          for (int q = 0; q < kWideN / 64; ++q) {
            if constexpr (WT)
              tma_load(b + q * kBox, &wmap, bar, kt * kDepth, n0 + 64 * q, e);
            else
              tma_load(b + q * kBox, &wmap, bar, n0 + 64 * q, kt * kDepth, e);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile.
    regs_inc<232>();
    const int t = threadIdx.x % 128;
    const bool lead = t == 0;
    float acc[kWideN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = tile % nn * kWideN, m0 = tile / nn % nm * kWideM;
      const int e = tile / (nn * nm);
#pragma unroll
      for (int i = 0; i < kWideN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kWideStages;
        bar_wait(smem_u32(&full[s]), (it / kWideStages) & 1);
        const uint32_t a = base + s * kWideStageBytes + wg * 64 * kRowBytes;
        const uint32_t b = base + s * kWideStageBytes + kWideM * kRowBytes;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk)
          wgmma_n256<XT, 1 - WT>(
              acc,
              XT ? desc(a + 16 * kRowBytes * kk, kMnLbo, kMnSbo)
                 : desc(a + 32 * kk, kKLbo, kKSbo),
              WT ? desc(b + 32 * kk, kKLbo, kKSbo)
                 : desc(b + 16 * kRowBytes * kk, kMnLbo, kMnSbo));
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();
        // The products of the stage before have finished: release it.
        if (kt > 0 && lead)
          bar_arrive(smem_u32(&empty[(it - 1) % kWideStages]));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lead) bar_arrive(smem_u32(&empty[(it - 1) % kWideStages]));

      // Epilogue: the warpgroup's 64 x 256 block in four 64 x 64 boxes,
      // each rounded to bf16 into one of two swizzled buffers and stored by
      // TMA while the next box is written (and the next tile's products
      // run); the store clips rows past C and columns past F.
      const int r = (t / 32) * 16 + (t % 32) / 4;   // and r + 8
#pragma unroll
      for (int q = 0; q < kWideN / 64; ++q) {
        const uint32_t buf = ebase + (2 * wg + q % 2) * kBox;
        if (lead) bulk_wait_read<1>();   // the store of 2 boxes ago has read
        named_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * q + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            st_shared(buf + row * kRowBytes + ((jj ^ (row % 8)) * 16) +
                          (t % 4) * 4,
                      *reinterpret_cast<const uint32_t*>(&v));
          }
        }
        fence_async_smem();
        named_sync(1 + wg, 128);
        if (lead) {
          tma_store(&omap, buf, n0 + 64 * q, m0 + 64 * wg, e);
          bulk_commit();
        }
      }
    }
    if (lead) bulk_wait_all();
  }
}

template <int N>
__device__ __forceinline__ void narrow_mma(float (&acc)[N / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (N == 8) wgmma_n8<1, 0>(acc, da, db);
  else if constexpr (N == 16) wgmma_n16<1, 0>(acc, da, db);
  else if constexpr (N == 32) wgmma_n32<1, 0>(acc, da, db);
  else wgmma_n64<1, 0>(acc, da, db);
}

template <int N>
__global__ void __launch_bounds__(kNarrowThreads)
    gmm_narrow_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      bf16* __restrict__ out, int C, int D, int F) {
  constexpr int kStageBytes = narrow_stage_bytes(N);
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kNarrowStages],
      empty[kNarrowStages];
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1u);
  const int e = blockIdx.y, f0 = blockIdx.x * kNarrowF;
  const int nk = (D + kDepth - 1) / kDepth;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNarrowStages; ++s) {
      bar_init(smem_u32(&full[s]), 1);
      bar_init(smem_u32(&empty[s]), 1);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      tma_prefetch(&xmap);
      tma_prefetch(&wmap);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kNarrowStages;
        if (kt >= kNarrowStages)
          bar_wait(smem_u32(&empty[s]), (kt / kNarrowStages - 1) & 1);
        const uint32_t wt = base + s * kStageBytes;
        const uint32_t bar = smem_u32(&full[s]);
        bar_expect(bar, kStageBytes);
        tma_load(wt, &wmap, bar, f0, kt * kDepth, e);
        tma_load(wt + kBox, &xmap, bar, kt * kDepth, 0, e);
      }
    }
    return;
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kNarrowStages;
    bar_wait(smem_u32(&full[s]), (kt / kNarrowStages) & 1);
    const uint32_t wt = base + s * kStageBytes, xt = wt + kBox;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
      narrow_mma<N>(acc, desc(wt + 16 * kRowBytes * kk, kMnLbo, kMnSbo),
                    desc(xt + 32 * kk, kKLbo, kKSbo));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x == 0)
      bar_arrive(smem_u32(&empty[(kt - 1) % kNarrowStages]));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc holds out[e]^T: its rows are columns f of out, its columns tokens c.
  const int t = threadIdx.x;
  const int f = f0 + (t / 32) * 16 + (t % 32) / 4;
  bf16* oe = out + static_cast<long long>(e) * C * F;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 8 * j + 2 * (t % 4) + i;
      if (c >= C) continue;
      bf16* orow = oe + static_cast<long long>(c) * F;
      if (f < F) orow[f] = __float2bfloat16(acc[4 * j + i]);
      if (f + 8 < F) orow[f + 8] = __float2bfloat16(acc[4 * j + 2 + i]);
    }
  }
}

// ------------------------------------------------------------------ host
// A rank-3 bf16 map over (d2, d1, d0), d0 contiguous, with strides s1 and
// s2 (elements), read in boxes of b1 rows of b0 elements, 128-byte
// swizzled.
int make_map(CUtensorMap* map, const void* ptr, long long d0, long long d1,
             long long d2, long long s1, long long s2, int b0, int b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1) * 2,
                                 static_cast<cuuint64_t>(s2) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Once for each kernel: allow its dynamic shared memory past 48 KB.
template <auto Kernel>
cudaError_t allow_smem(long long smem) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  return attr;
}

// The SMs of the current card (the wide regime's persistent grid).
int sm_count() {
  static const int count = []() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return count;
}

template <int N>
int launch_narrow_n(const Args& a, cudaStream_t stream) {
  CUtensorMap xm, wm;
  int rc = make_map(&xm, a.x, a.D, a.C, a.E, a.sxp, a.sxe, kDepth, N);
  if (rc == 0)
    rc = make_map(&wm, a.w, a.F, a.D, a.E, a.swp, a.swe, 64, kDepth);
  if (rc != 0) return rc;
  const long long smem = narrow_smem_bytes(N);
  const cudaError_t attr = allow_smem<gmm_narrow_kernel<N>>(smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.F + kNarrowF - 1) / kNarrowF, a.E);
  gmm_narrow_kernel<N><<<grid, kNarrowThreads, smem, stream>>>(
      xm, wm, static_cast<bf16*>(a.out), a.C, a.D, a.F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

long long wide_smem_bytes() {
  return static_cast<long long>(kWideStages) * kWideStageBytes +
         2 * kWideConsumers * kBox + kAlign;
}

long long narrow_smem_bytes(int C) {
  return static_cast<long long>(kNarrowStages) *
             narrow_stage_bytes(narrow_n(C)) + kAlign;
}

// The maps of one layout: x over (D, C, E) in boxes of 64 x 128 (K-major)
// or, transposed, over (C, D, E) in 64 x 64 boxes (MN-major); w over
// (F, D, E) in 64 x 64 boxes (MN-major) or, transposed, over (D, F, E) in
// 64 x 64 boxes too (K-major: four boxes of 64 rows make the tile's 256).
template <int XT, int WT>
int launch_wide_t(const Args& a, cudaStream_t stream) {
  CUtensorMap xm, wm, om;
  int rc = XT ? make_map(&xm, a.x, a.C, a.D, a.E, a.sxp, a.sxe, 64, kDepth)
              : make_map(&xm, a.x, a.D, a.C, a.E, a.sxp, a.sxe, kDepth,
                         kWideM);
  if (rc == 0)
    rc = WT ? make_map(&wm, a.w, a.D, a.F, a.E, a.swp, a.swe, kDepth, 64)
            : make_map(&wm, a.w, a.F, a.D, a.E, a.swp, a.swe, 64, kDepth);
  if (rc == 0)
    rc = make_map(&om, a.out, a.F, a.C, a.E, a.F,
                  static_cast<long long>(a.C) * a.F, 64, 64);
  if (rc != 0) return rc;
  const cudaError_t attr =
      allow_smem<gmm_wide_kernel<XT, WT>>(wide_smem_bytes());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = static_cast<long long>((a.F + kWideN - 1) / kWideN) *
                          ((a.C + kWideM - 1) / kWideM) * a.E;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  gmm_wide_kernel<XT, WT><<<blocks, kWideThreads, wide_smem_bytes(),
                            stream>>>(xm, wm, om, a.E, a.C, a.D, a.F);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const Args& a, cudaStream_t stream) {
  if (a.xt && a.wt) return launch_wide_t<1, 1>(a, stream);
  if (a.xt) return launch_wide_t<1, 0>(a, stream);
  if (a.wt) return launch_wide_t<0, 1>(a, stream);
  return launch_wide_t<0, 0>(a, stream);
}

int launch_narrow(const Args& a, cudaStream_t stream) {
  switch (narrow_n(a.C)) {
    case 8: return launch_narrow_n<8>(a, stream);
    case 16: return launch_narrow_n<16>(a, stream);
    case 32: return launch_narrow_n<32>(a, stream);
    default: return launch_narrow_n<64>(a, stream);
  }
}

}  // namespace k7
