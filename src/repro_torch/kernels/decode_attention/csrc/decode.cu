// K6: split-K flash decoding, one query token per sequence against a
// ragged KV cache.
//
// Replaces the TPU kernel decode_attention_kernel / _decode_kernel in
// src/repro/kernels/decode_attention/kernel.py:55 (body :30, pallas_call
// :76).
//
// For every (batch b, KV head h, block ik of block_k cache positions) the
// G = Hq / Hkv query rows of the head's group score the block's positions
// below kv_len[b] (scale 1 / sqrt(D)) and emit float32 partials: the
// block's max m, its sum l of exp(s - m) and o = sum p * v.  A block with
// no live position writes m = -1e30, l = 0, o = 0 (the Pallas kernel's
// p = 0 for a fully masked block), so the log-sum-exp combine, which runs
// outside (as it does in the reference), gives it zero weight and no NaN.
//
// Bound on an H100: the bytes of K and V up to kv_len over 3.35 TB/s.
// With G query rows per KV row the kernel does 4 G operations per cache
// element read, far below the card's ratio of operations to bytes.
//
// Design: one block of 256 threads (8 warps) per (block, KV head, batch).
// Blocks that start at or past kv_len write their empty partials and
// leave without reading the cache.  The group's query rows sit in shared
// memory; a warp scores one cache position at a time (lane-strided
// features, a shuffle sum per query row), writing the scores to shared
// memory; a warp per query row then takes the max, the exponentials and
// the sum.  For o, each thread owns one feature and a strided share of
// the positions, for four query rows at a time, and the shares are summed
// in a fixed order, so a launch gives the same bits every time.  Where D
// does not divide the block (D = 112: two shares of 112 threads), the
// threads past kParts * D take no share; they only reach the barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerPass = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Params {
  const void* q;  // (B, Hq, D) packed
  const void* k;
  const void* v;
  const int* kv_len;  // (B,)
  float* o;           // (B, Hkv, nk, G, D) packed
  float* m;           // (B, Hkv, nk, G)
  float* l;
  long long k_sb, k_ss, v_sb, v_ss;  // element strides
  int S, Hq, Hkv, nk, block_k;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params p) {
  constexpr int DL = (D + 31) / 32;       // features per lane
  constexpr int kParts = kThreads / D;    // position shares in the o pass
  extern __shared__ float smem[];
  const int G = p.Hq / p.Hkv;
  float* qs = smem;                       // G x D
  float* ss = qs + G * D;                 // G x block_k
  float* red = ss + G * p.block_k;        // kParts x G x D

  const int ik = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k_start = ik * p.block_k;
  const int kv_len = min(p.kv_len[b], p.S);
  const int n = min(p.block_k, kv_len - k_start);  // live positions
  const long long part = ((long long)(b * p.Hkv + h) * p.nk + ik) * G;

  if (n <= 0) {
    for (int idx = threadIdx.x; idx < G * D; idx += kThreads)
      p.o[part * D + idx] = 0.f;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      p.m[part + g] = kNegInf;
      p.l[part + g] = 0.f;
    }
    return;
  }

  const T* qg = static_cast<const T*>(p.q) + ((long long)b * p.Hq + h * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads)
    qs[idx] = to_f(qg[idx]);
  __syncthreads();

  // Scores of the live positions.
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb
                + (long long)k_start * p.k_ss + (long long)h * D;
  for (int pos = warp; pos < n; pos += kWarps) {
    const T* kr = kg + pos * p.k_ss;
    float kv[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < D ? to_f(kr[d]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc = fmaf(qs[g * D + d], kv[i], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) ss[g * p.block_k + pos] = acc * p.scale;
    }
  }
  __syncthreads();

  // Max, exponentials and sum, one warp per query row.
  for (int g = warp; g < G; g += kWarps) {
    float* row = ss + g * p.block_k;
    float mx = kNegInf;
    for (int pos = lane; pos < n; pos += 32) mx = fmaxf(mx, row[pos]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int pos = lane; pos < n; pos += 32) {
      const float e = expf(row[pos] - mx);
      row[pos] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      p.m[part + g] = mx;
      p.l[part + g] = sum;
    }
  }
  __syncthreads();

  // o = p @ v: thread (share, d) sums positions share, share + kParts, ...
  // Threads with share >= kParts (past kParts * D) sit this pass out.
  const int d = threadIdx.x % D, share = threadIdx.x / D;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb
                + (long long)k_start * p.v_ss + (long long)h * D + d;
  for (int g0 = 0; share < kParts && g0 < G; g0 += kRowsPerPass) {
    const int rows = min(kRowsPerPass, G - g0);
    float acc[kRowsPerPass] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int pos = share; pos < n; pos += kParts) {
      const float vv = to_f(vg[pos * p.v_ss]);
#pragma unroll
      for (int j = 0; j < kRowsPerPass; ++j)
        if (j < rows) acc[j] = fmaf(ss[(g0 + j) * p.block_k + pos], vv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerPass; ++j)
      if (j < rows) red[(share * G + g0 + j) * D + d] = acc[j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    float sum = 0.f;
    for (int s = 0; s < kParts; ++s) sum += red[s * G * D + idx];
    p.o[part * D + idx] = sum;
  }
}

template <int D>
size_t smem_bytes(int G, int block_k) {
  return sizeof(float) *
         (static_cast<size_t>(G) * D + static_cast<size_t>(G) * block_k +
          static_cast<size_t>(kThreads / D) * G * D);
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(p.Hq / p.Hkv, p.block_k);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid(p.nk, p.Hkv, B);
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, s);
    case 32: return launch<T, 32>(p, B, s);
    case 64: return launch<T, 64>(p, B, s);
    case 112: return launch<T, 112>(p, B, s);
    case 128: return launch<T, 128>(p, B, s);
    case 256: return launch<T, 256>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).  Strides are in
// elements; q is packed (B, Hq, D), the head and feature axes of k and v
// are packed, and the partials are packed float32.
extern "C" int decode_attention_partials(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    void* m, void* l, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, int B, int S, int Hq, int Hkv, int D, int block_k,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || block_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nk = (S + block_k - 1) / block_k;
  Params p{q, k, v, static_cast<const int*>(kv_len), static_cast<float*>(o),
           static_cast<float*>(m), static_cast<float*>(l), k_sb, k_ss, v_sb,
           v_ss, S, Hq, Hkv, nk, block_k, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
