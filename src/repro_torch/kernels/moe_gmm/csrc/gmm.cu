// K7: grouped expert GEMM, out[e] = x[e] @ w[e] for every expert e, with
// x (E, C, D), w (E, D, F) and out (E, C, F); the products are summed in
// float32 and the result is written in the inputs' type.  x and w may be
// views with any expert stride and either of their two inner axes packed
// (a transposed operand is read in place: the backward's W^T and X^T,
// ops.py), with any pitch for the other; out is packed.
//
// Replaces the TPU kernel grouped_matmul_kernel / _gmm_kernel in
// src/repro/kernels/moe_gmm/kernel.py:46 (body :26, pallas_call :66).
// The Pallas kernel zero-pads C, D and F to its 128 x 512 x 128 blocks and
// carries a float32 accumulator in VMEM across the sequential D axis of
// its grid; here each block loops over D itself and keeps its sums in
// registers.
//
// One call is one launch of one of three kernels, chosen by the wrapper's
// plan (ops.py, kernel.plan) from the dtype and the shape, never by trying:
//  * wide (bf16, C > 64: the MoE layer's prefill products, C of hundreds,
//    D and F of 1-2 thousand).  About C operations per weight byte, far
//    above the H100's ratio of bf16 tensor-core operations to bytes, so
//    operations bound it: gmm_wide_kernel in gmm_tc.cu, wgmma on the
//    tensor cores fed by TMA through a ring of shared-memory stages;
//  * narrow (bf16, C <= 64: a decode step's products, C = 8).  Every
//    expert's weight is read once, so bytes bound it: gmm_narrow_kernel in
//    gmm_tc.cu, the operands swapped so that F fills wgmma's 64 rows and
//    the tokens its N, the weights streamed by TMA;
//  * CUDA cores (float32, whose checks hold tokens and routing to the
//    plain version and would not survive TF32; and bf16 that TMA cannot
//    describe: a row or expert pitch of x, w or out that is no multiple
//    of 16 bytes, a base address that is not 16-byte aligned, or D = 0).
//    gmm_kernel below, in float32: one block of 256 threads per (expert,
//    64 rows of C, 64 columns of F); the D loop takes tiles of 32, x's
//    (64 x 32) and w's (32 x 64) read with neighbouring threads on
//    neighbouring addresses along whichever axis is packed (a template
//    parameter of each operand), converted to float32 and staged in
//    shared memory, the next tile's loads in flight in registers; each
//    thread owns a 4 x 4 tile of accumulators.  Ragged edges are masked.
// Every output element is one thread's sum over D in a fixed order, with
// no atomics, so a launch gives the same bits every time.
//
// The CPU tests reach the plan (tests/test_torch_moe.py); the kernels run
// only on the card, where chip_smoke.py holds each regime against the
// plain version (ref.py) and times it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gmm.cuh"

namespace k7 {
namespace {

constexpr int kTileM = 64;  // rows of C a block owns
constexpr int kTileN = 64;  // columns of F a block owns
constexpr int kTileK = 32;  // depth of one step of the D loop
constexpr int kThreads = 256;
constexpr int kLdw = kTileN + 4;  // w's tile pitch: 16-byte rows, and a
                                  // transposed load's stores 4-way at most
constexpr int kLoadsX = kTileM * kTileK / kThreads;  // 8 a thread
constexpr int kLoadsW = kTileK * kTileN / kThreads;  // 8 a thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// XT: x's C axis is packed (element (c, d) at d * sxp + c), else its D
// axis (c * sxp + d); WT: w's D axis is packed ((d, f) at f * swp + d),
// else its F axis (d * swp + f).  Each tile is loaded along the packed
// axis, so a warp's loads fall on neighbouring addresses either way.
template <typename T, bool XT, bool WT>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int C, int D, int F, long long sxe,
               long long sxp, long long swe, long long swp) {
  __shared__ float xs[kTileM][kTileK + 1];
  __shared__ __align__(16) float ws[kTileK][kLdw];

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * kTileN;
  const T* xe = x + e * sxe;
  const T* we = w + e * swe;
  T* oe = out + static_cast<long long>(e) * C * F;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // Warps whose rows all lie past C (a decode step's short buckets) load
  // and synchronise with the block but do no arithmetic.
  const bool live = row0 + ty * 4 < C;

  // Load i of a thread: row r and depth k of x's tile, depth k and column
  // n of w's, the packed axis fastest across the threads.
  auto x_at = [&](int idx, int& r, int& k) {
    if constexpr (XT) r = idx % kTileM, k = idx / kTileM;
    else r = idx / kTileK, k = idx % kTileK;
  };
  auto w_at = [&](int idx, int& k, int& n) {
    if constexpr (WT) k = idx % kTileK, n = idx / kTileK;
    else k = idx / kTileN, n = idx % kTileN;
  };
  float xr[kLoadsX], wr[kLoadsW];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoadsX; ++i) {
      int r, k;
      x_at(tid + i * kThreads, r, k);
      const int row = row0 + r, kk = k0 + k;
      xr[i] = (row < C && kk < D)
                  ? to_f(XT ? xe[kk * sxp + row] : xe[row * sxp + kk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoadsW; ++i) {
      int k, n;
      w_at(tid + i * kThreads, k, n);
      const int kk = k0 + k, col = col0 + n;
      wr[i] = (kk < D && col < F)
                  ? to_f(WT ? we[col * swp + kk] : we[kk * swp + col]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kLoadsX; ++i) {
      int r, k;
      x_at(tid + i * kThreads, r, k);
      xs[r][k] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kLoadsW; ++i) {
      int k, n;
      w_at(tid + i * kThreads, k, n);
      ws[k][n] = wr[i];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (D + kTileK - 1) / kTileK;
  if (nk > 0) {
    load(0);
    stash();
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) * kTileK);
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kTileK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
    if (kt + 1 < nk) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= C) continue;
    T* orow = oe + static_cast<long long>(row) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < F) put(orow + col, acc[i][j]);
    }
  }
}

template <typename T, bool XT, bool WT>
int launch_core(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.F + kTileN - 1) / kTileN, (a.C + kTileM - 1) / kTileM,
                  a.E);
  gmm_kernel<T, XT, WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<T*>(a.out), a.C, a.D, a.F, a.sxe, a.sxp, a.swe, a.swp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.xt && a.wt) return launch_core<T, true, true>(a, stream);
  if (a.xt) return launch_core<T, true, false>(a, stream);
  if (a.wt) return launch_core<T, false, true>(a, stream);
  return launch_core<T, false, false>(a, stream);
}

// TMA's terms for the tensor-core regimes (16-byte aligned bases and
// pitches, something to contract), and out's rows in 16-byte pitches.
bool tma_ok(const Args& a) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  return a.D > 0 && aligned(a.x) && aligned(a.w) && aligned(a.out) &&
         a.sxe % 8 == 0 && a.sxp % 8 == 0 && a.swe % 8 == 0 &&
         a.swp % 8 == 0 && a.F % 8 == 0;
}

}  // namespace
}  // namespace k7

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  regime: the
// plan's (0 CUDA cores, 1 wide, 2 narrow); a tensor-core regime takes
// bfloat16 that TMA can describe (and the narrow one C <= 64 with neither
// operand transposed), else the call returns cudaErrorInvalidValue.
// Strides are in elements: sxe and swe the experts', sxp and swp the
// pitches (the stride of the inner axis that is not packed); xt: x's C
// axis is the packed one, wt: w's D axis.  device: the tensors' card,
// made current first, since a host thread that has not used the card yet
// (autograd's worker thread, whose first work may be the backward's K7
// launches) has no current context and its launches fail.  D = 0 writes
// zeros.
extern "C" int moe_gmm(const void* x, const void* w, void* out, int E, int C,
                       int D, int F, long long sxe, long long sxp,
                       long long swe, long long swp, int xt, int wt,
                       int dtype, int regime, int device, void* stream) {
  using namespace k7;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (D < 0 || E > 65535 || (C + kTileM - 1) / kTileM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, out, E, C, D, F, sxe, sxp, swe, swp, xt != 0, wt != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regime == kCudaCore) {
    if (dtype == 0) return launch<float>(a, s);
    if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  } else if (dtype == 1 && tma_ok(a)) {
    if (regime == kWide) return launch_wide(a, s);
    if (regime == kNarrow && C <= 64 && !a.xt && !a.wt)
      return launch_narrow(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of a tensor-core launch, for the plan's check.
extern "C" long long moe_gmm_smem_bytes(int regime, int C) {
  if (regime == k7::kWide) return k7::wide_smem_bytes();
  if (regime == k7::kNarrow) return k7::narrow_smem_bytes(C);
  return 0;
}

extern "C" const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
