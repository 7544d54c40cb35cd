// K4: causal GQA flash attention, forward, with the log-sum-exp.
//
// Replaces the TPU kernel flash_attention_kernel / _flash_kernel in
// src/repro/kernels/flash_attention/kernel.py:83 (body :32, pallas_call
// :111).
//
// Computes, for every (batch, query head, query row), the softmax of the
// scaled scores q.k / sqrt(D) over the keys that are inside the KV length
// and, when causal, at or before q_offset + row; returns the weighted sum
// of the values (in q's type) and the row's log-sum-exp (float32).  The
// running state is the Pallas kernel's: (m, l, acc) in float32, masked
// scores at -1e30, l clamped at 1e-30 before the division and the log.
//
// Bound on an H100: at the serving path's prefill (B = 8, Sq = Skv = 512,
// 32 query heads of 128) the work is 4 * B * Hq * D * (causal pairs)
// operations against 3.35 TB/s for q, k, v and o, so operations bound it
// if they run on the tensor cores.  This first kernel runs them on the
// CUDA cores in float32 (67 TFLOP/s at best), so it is far from that
// bound; wgmma, TMA and warp specialisation are later work.
//
// Design: one block of 256 threads per (64-row query block, query head,
// batch).  The query tile and one 64-row K and V tile at a time sit in
// shared memory as float32, rows padded by one float against bank
// conflicts.  Each thread owns a 4 x 4 patch of the 64 x 64 score tile
// (rows ty + 16 i, columns tx + 16 j) and the same four rows of the output
// (columns tx + 16 j), so the row max and sum are shuffles among the 16
// threads of a row group.  KV blocks that start past the block's last
// causal position are never loaded.  GQA reads KV head h / (Hq / Hkv);
// the batch and sequence strides are arguments, so a view into a larger
// KV cache needs no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;  // element strides
  int Sq, Skv, Hq, Hkv, q_offset, causal;
  float scale;
};

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1);
}

// Rows [r0, r0 + 64) of a (rows, D) slab with row stride ld (elements)
// into shared memory as float32, zero past `rows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int r0, int rows) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] = gr < rows ? to_f(src[gr * ld + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * D;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + (long long)hk * D;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + (long long)hk * D;

  load_tile<T, D>(qs, qg, p.q_ss, q0, p.Sq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // The Pallas kernel visits block k_start when k_start <= q_start +
  // block_q - 1; past that every key of the block is masked for every row.
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, p.q_offset + q0 + kBQ);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous block is done with ks, vs and ps
    load_tile<T, D>(ks, kg, p.k_ss, k0, p.Skv);
    load_tile<T, D>(vs, vg, p.v_ss, k0, p.Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = p.q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool ok = k_pos < p.Skv && (!p.causal || k_pos <= q_pos);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * LP + tx + 16 * j] = e;
        rs += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = og + ((long long)(b * p.Sq + r) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / lc);
    if (tx == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + r] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are
// in elements; the head and feature axes of q, k, v are packed (head
// stride D, feature stride 1), o is a packed (B, Sq, Hq, D) and lse a
// packed (B, Hq, Sq).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, int q_offset, int causal, float scale, int dtype, int device,
    void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || Sq <= 0 || Hq <= 0) return 0;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, static_cast<float*>(lse), q_sb, q_ss, k_sb, k_ss,
           v_sb, v_ss, Sq, Skv, Hq, Hkv, q_offset, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
