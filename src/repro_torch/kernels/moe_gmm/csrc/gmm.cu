// K7: grouped expert GEMM, out[e] = x[e] @ w[e] for every expert e, with
// x (E, C, D), w (E, D, F) and out (E, C, F), all packed; the products are
// summed in float32 and the result is written in the inputs' type.
//
// Replaces the TPU kernel grouped_matmul_kernel / _gmm_kernel in
// src/repro/kernels/moe_gmm/kernel.py:46 (body :26, pallas_call :66).
// The Pallas kernel zero-pads C, D and F to its blocks and carries a
// float32 accumulator in VMEM across the sequential D axis of its grid;
// here each block loops over D itself, keeps its accumulators in
// registers, and masks the ragged edges instead of padding.
//
// Bound on an H100: the MoE layer's prefill products (C of hundreds, D and
// F of 1-2 thousand) do about C operations per weight byte, far above the
// card's ratio of bf16 tensor-core operations to bytes, so they are bound
// by operations; a decode step's products (C = 8) read every expert's
// weight once and are bound by bytes.  This first version runs on the
// CUDA cores in float32 (no tensor cores), so the prefill products are far
// from their bound; the decode products come closer, since warps whose
// rows lie past C skip the arithmetic and each weight is read once when
// C <= 64.
//
// Design: one block of 256 threads per (expert, 64 rows of C, 64 columns
// of F).  The D loop takes tiles of 32: the x tile (64 x 32) and the w
// tile (32 x 64) are read from device memory with neighbouring threads on
// neighbouring addresses, converted to float32 and staged in shared
// memory; the next tile's loads are in flight in registers while the
// current one is multiplied.  Each thread owns a 4 x 4 tile of float32
// accumulators (rows 4 ty .. 4 ty + 3, columns 4 tx .. 4 tx + 3).  Every
// output element is one thread's sum over D in a fixed order, so a launch
// gives the same bits every time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;  // rows of C a block owns
constexpr int kTileN = 64;  // columns of F a block owns
constexpr int kTileK = 32;  // depth of one step of the D loop
constexpr int kThreads = 256;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int C, int D, int F) {
  __shared__ float xs[kTileM][kTileK + 1];
  __shared__ __align__(16) float ws[kTileK][kTileN];

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * kTileN;
  const T* xe = x + static_cast<long long>(e) * C * D;
  const T* we = w + static_cast<long long>(e) * D * F;
  T* oe = out + static_cast<long long>(e) * C * F;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // Warps whose rows all lie past C (a decode step's short buckets) load
  // and synchronise with the block but do no arithmetic.
  const bool live = row0 + ty * 4 < C;

  float xr[kLoadsX], wr[kLoadsW];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoadsX; ++i) {
      const int idx = tid + i * kThreads;
      const int row = row0 + idx / kTileK, k = k0 + idx % kTileK;
      xr[i] = (row < C && k < D)
                  ? to_f(xe[static_cast<long long>(row) * D + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoadsW; ++i) {
      const int idx = tid + i * kThreads;
      const int k = k0 + idx / kTileN, col = col0 + idx % kTileN;
      wr[i] = (k < D && col < F)
                  ? to_f(we[static_cast<long long>(k) * F + col]) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kLoadsX; ++i) {
      const int idx = tid + i * kThreads;
      xs[idx / kTileK][idx % kTileK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kLoadsW; ++i) {
      const int idx = tid + i * kThreads;
      ws[idx / kTileN][idx % kTileN] = wr[i];
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

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, cudaStream_t stream) {
  const dim3 grid((F + kTileN - 1) / kTileN, (C + kTileM - 1) / kTileM, E);
  gmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  x (E, C, D),
// w (E, D, F) and out (E, C, F) are packed.  D = 0 writes zeros.
extern "C" int moe_gmm(const void* x, const void* w, void* out, int E, int C,
                       int D, int F, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  if (D < 0 || E > 65535 || (C + kTileM - 1) / kTileM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, E, C, D, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, E, C, D, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
