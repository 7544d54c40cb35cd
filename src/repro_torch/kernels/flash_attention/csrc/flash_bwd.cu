// K5: causal GQA flash attention, backward, from the forward's
// log-sum-exp.
//
// Replaces the TPU kernel flash_attention_bwd_kernel in
// src/repro/kernels/flash_attention/kernel_bwd.py:125: its dk/dv kernel
// (_dkdv_kernel, body :43, pallas_call :161) and its dq kernel
// (_dq_kernel, body :84, pallas_call :195).
//
// Computes, with scale = 1 / sqrt(D), p = exp(q.k * scale - lse) on the
// keys that are inside the KV length and, when causal, at or before the
// query's position q_offset + row (0 elsewhere), D = rowsum(dO * O) (given,
// computed by the caller in float32), and
//   dv = p^T dO,  dp = dO v^T,  ds = p * (dp - D) * scale,
//   dk = ds^T q,  dq = ds k,
// with dk and dv summed over the query heads of each KV head's group.
// Accumulators are float32; outputs take the inputs' type.
//
// Bound on an H100: at the training path's layer (B = 4, S = 4096, 36 heads
// of 64, causal) the five products take 10 * B * Hq * D operations per
// causal pair against 3.35 TB/s for q, k, v, o, dO, lse, dq, dk and dv, so
// operations bound it if they run on the tensor cores.  This first kernel
// runs them on the CUDA cores in float32 (67 TFLOP/s at best) and the dq
// kernel recomputes s and dp, so it is far from that bound; wgmma, TMA and
// one fused kernel are later work.
//
// Design: two kernels of 256 threads, both with BR x BR tiles (BR, the
// row block, is a template parameter: 64 up to D 128, 32 at D 256) and the
// thread layout of K4 (thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j, i < BR / 16).  Tiles sit in shared memory as float32, rows
// padded by one float against bank conflicts.
//   dkdv: one block per (BR KV rows, KV head, batch).  K and V stay in
//     shared memory; the block loops over the group's Hq / Hkv query heads
//     and, for each, over the query blocks that can see its keys (causal
//     blocks before the first are skipped), so dk and dv sum over the
//     group in registers: no per-query-head buffer, no atomics.
//   dq: one block per (BR query rows, query head, batch), looping over the
//     KV blocks up to the causal diagonal.
// Shared memory: 4 tiles of BR x (D + 1) floats, two BR x (BR + 1) tiles
// (p and ds) and two rows of BR: 100,352 B at D 64, 149,504 B at D 112,
// 165,888 B at D 128 and, with BR 32, 140,288 B at D 256 (of the 232,448
// a block may have; BR 64 at D 256 would take 296,960 B).  Head dims
// 129-255 reach D 256 zero-padded by the wrapper.  Registers: dk and dv
// are 2 x (BR / 16) x D / 16 floats a thread (64 at D 128 and at D 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
  const void* dout;
  const float* lse;   // (B, Hq, Sq)
  const float* dsum;  // (B, Hq, Sq)
  void* dq;           // (B, Sq, Hq, D)
  void* dk;           // (B, Skv, Hkv, D)
  void* dv;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;  // elements
  int Sq, Skv, Hq, Hkv, q_offset, causal;
  float scale;
};

template <int D, int BR>
constexpr int smem_floats() {
  return 4 * BR * (D + 1) + 2 * BR * (BR + 1) + 2 * BR;
}

// Rows [r0, r0 + BR) of a (rows, D) slab with row stride ld (elements)
// into shared memory as float32, zero past `rows`.
template <typename T, int D, int BR>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ld, int r0, int rows) {
  for (int idx = threadIdx.x; idx < BR * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] = gr < rows ? to_f(src[gr * ld + c]) : 0.f;
  }
}

// lse and D of query rows [q0, q0 + BR) into shared memory, zero past Sq.
template <int BR>
__device__ __forceinline__ void load_rows(float* lse_s, float* dsum_s,
                                          const float* lse,
                                          const float* dsum, int q0,
                                          int Sq) {
  if (threadIdx.x < BR) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < Sq ? lse[r] : 0.f;
    dsum_s[threadIdx.x] = r < Sq ? dsum[r] : 0.f;
  }
}

// The thread's (BR / 16) x (BR / 16) patch of p and ds for query rows
// q0 + ty + 16 i and keys k0 + tx + 16 j, from the tiles qs, dos (query
// rows) and ks, vs (keys), written to ps (when given) and dss as
// [query row][key].
template <int D, int BR>
__device__ __forceinline__ void p_and_ds(const Params& p, const float* qs,
                                         const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* dsum_s, float* ps,
                                         float* dss, int q0, int k0) {
  constexpr int LD = D + 1;
  constexpr int LP = BR + 1;
  constexpr int R = BR / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(ty + 16 * i) * LD + d];
      ov[i] = dos[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = ks[(tx + 16 * j) * LD + d];
      vv[j] = vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty + 16 * i;
    const int q_pos = p.q_offset + q0 + row;
    const bool row_ok = q0 + row < p.Sq;
    const float lse = lse_s[row], dsum = dsum_s[row];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int k_pos = k0 + tx + 16 * j;
      const bool ok =
          row_ok && k_pos < p.Skv && (!p.causal || k_pos <= q_pos);
      const float pv = ok ? expf(s[i][j] * p.scale - lse) : 0.f;
      if (ps != nullptr) ps[row * LP + tx + 16 * j] = pv;
      dss[row * LP + tx + 16 * j] = pv * (dp[i][j] - dsum) * p.scale;
    }
  }
}

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int LP = BR + 1;
  constexpr int DJ = D / 16;
  constexpr int R = BR / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BR * LD;
  float* qs = vs + BR * LD;
  float* dos = qs + BR * LD;
  float* ps = dos + BR * LD;
  float* dss = ps + BR * LP;
  float* lse_s = dss + BR * LP;
  float* dsum_s = lse_s + BR;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  load_tile<T, D, BR>(ks, static_cast<const T*>(p.k) + b * p.k_sb +
                          (long long)hk * D, p.k_ss, k0, p.Skv);
  load_tile<T, D, BR>(vs, static_cast<const T*>(p.v) + b * p.v_sb +
                              (long long)hk * D, p.v_ss, k0, p.Skv);

  float dk[R][DJ], dv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // The Pallas kernel visits query block iq when k_start <= q_start +
  // block_q - 1 (q_start = q_offset + iq * block_q); before the first such
  // block every key of this block is masked for every row.
  int iq0 = 0;
  if (p.causal && k0 > p.q_offset) iq0 = (k0 - p.q_offset) / BR;
  const int nq = (p.Sq + BR - 1) / BR;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + (long long)h * D;
    const T* og =
        static_cast<const T*>(p.dout) + b * p.do_sb + (long long)h * D;
    const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * BR;
      __syncthreads();  // the previous block is done with qs, dos, ps, dss
      load_tile<T, D, BR>(qs, qg, p.q_ss, q0, p.Sq);
      load_tile<T, D, BR>(dos, og, p.do_ss, q0, p.Sq);
      load_rows<BR>(lse_s, dsum_s, p.lse + row0, p.dsum + row0, q0, p.Sq);
      __syncthreads();
      p_and_ds<D, BR>(p, qs, dos, ks, vs, lse_s, dsum_s, ps, dss, q0, k0);
      __syncthreads();
      // dv[key][c] += sum_q p[q][key] dO[q][c]; dk the same with ds and q.
#pragma unroll 4
      for (int qq = 0; qq < BR; ++qq) {
        float pk[R], sk[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pk[i] = ps[qq * LP + ty + 16 * i];
          sk[i] = dss[qq * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float ov = dos[qq * LD + tx + 16 * j];
          const float qv = qs[qq * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dv[i][j] = fmaf(pk[i], ov, dv[i][j]);
            dk[i][j] = fmaf(sk[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= p.Skv) continue;
    const long long off = ((long long)(b * p.Skv + r) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkg[off + tx + 16 * j] = from_f<T>(dk[i][j]);
      dvg[off + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int LP = BR + 1;
  constexpr int DJ = D / 16;
  constexpr int R = BR / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BR * LD;
  float* qs = vs + BR * LD;
  float* dos = qs + BR * LD;
  float* dss = dos + BR * LD + BR * LP;  // the dkdv kernel's p tile unused
  float* lse_s = dss + BR * LP;
  float* dsum_s = lse_s + BR;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + (long long)hk * D;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + (long long)hk * D;
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
  load_tile<T, D, BR>(qs, static_cast<const T*>(p.q) + b * p.q_sb +
                              (long long)h * D, p.q_ss, q0, p.Sq);
  load_tile<T, D, BR>(dos, static_cast<const T*>(p.dout) + b * p.do_sb +
                               (long long)h * D, p.do_ss, q0, p.Sq);
  load_rows<BR>(lse_s, dsum_s, p.lse + row0, p.dsum + row0, q0, p.Sq);

  float dq[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  // KV blocks past the block's last causal position are never loaded.
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(kv_end, p.q_offset + q0 + BR);

  for (int k0 = 0; k0 < kv_end; k0 += BR) {
    __syncthreads();  // the previous block is done with ks and dss
    load_tile<T, D, BR>(ks, kg, p.k_ss, k0, p.Skv);
    load_tile<T, D, BR>(vs, vg, p.v_ss, k0, p.Skv);
    __syncthreads();
    p_and_ds<D, BR>(p, qs, dos, ks, vs, lse_s, dsum_s, nullptr, dss, q0,
                    k0);
    __syncthreads();
    // dq[row][c] += sum_key ds[row][key] k[key][c].
#pragma unroll 4
    for (int kk = 0; kk < BR; ++kk) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dss[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = ks[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) dq[i][j] = fmaf(sv[i], kv, dq[i][j]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const long long off = ((long long)(b * p.Sq + r) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqg[off + tx + 16 * j] = from_f<T>(dq[i][j]);
  }
}

// Raise the kernel's dynamic shared memory limit once, then launch it.
template <typename Kernel>
int launch_one(Kernel* kern, bool& configured, dim3 grid, size_t smem,
               const Params& p, cudaStream_t stream) {
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kern<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The row block of head dim D: 64, or 32 where 64 rows of D 256 pass a
// block's shared memory.
template <int D>
constexpr int row_block() {
  return D > 128 ? 32 : 64;
}

template <typename T, int D>
int launch(const Params& p, int B, bool dkdv, cudaStream_t stream) {
  constexpr int BR = row_block<D>();
  const size_t smem = smem_floats<D, BR>() * sizeof(float);
  static bool dkdv_configured = false, dq_configured = false;
  if (dkdv)
    return launch_one(flash_bwd_dkdv_kernel<T, D, BR>, dkdv_configured,
                      dim3((p.Skv + BR - 1) / BR, p.Hkv, B), smem, p,
                      stream);
  return launch_one(flash_bwd_dq_kernel<T, D, BR>, dq_configured,
                    dim3((p.Sq + BR - 1) / BR, p.Hq, B), smem, p, stream);
}

template <typename T>
int dispatch(const Params& p, int B, int D, bool dkdv, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, dkdv, s);
    case 32: return launch<T, 32>(p, B, dkdv, s);
    case 64: return launch<T, 64>(p, B, dkdv, s);
    case 112: return launch<T, 112>(p, B, dkdv, s);
    case 128: return launch<T, 128>(p, B, dkdv, s);
    case 256: return launch<T, 256>(p, B, dkdv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(bool dkdv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* dsum, void* dq,
        void* dk, void* dv, long long q_sb, long long q_ss, long long k_sb,
        long long k_ss, long long v_sb, long long v_ss, long long do_sb,
        long long do_ss, int B, int Sq, int Skv, int Hq, int Hkv, int D,
        int q_offset, int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, dout, static_cast<const float*>(lse),
           static_cast<const float*>(dsum), dq, dk, dv, q_sb, q_ss, k_sb,
           k_ss, v_sb, v_ss, do_sb, do_ss, Sq, Skv, Hq, Hkv, q_offset,
           causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, D, dkdv, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, D, dkdv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the gradients share
// it).  Strides are in elements; the head and feature axes of q, k, v and
// dO are packed (head stride D, feature stride 1); lse and dsum are packed
// (B, Hq, Sq) float32, dq a packed (B, Sq, Hq, D), dk and dv packed
// (B, Skv, Hkv, D).  The dk/dv kernel writes dk and dv, the dq kernel dq;
// each entry point launches one kernel.
#define BWD_ARGS                                                            \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *dsum, void *dq, void *dk, void *dv,      \
      long long q_sb, long long q_ss, long long k_sb, long long k_ss,       \
      long long v_sb, long long v_ss, long long do_sb, long long do_ss,     \
      int B, int Sq, int Skv, int Hq, int Hkv, int D, int q_offset,         \
      int causal, float scale, int dtype, void *stream
#define BWD_CALL                                                            \
  q, k, v, dout, lse, dsum, dq, dk, dv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, \
      do_sb, do_ss, B, Sq, Skv, Hq, Hkv, D, q_offset, causal, scale, dtype, \
      stream

extern "C" int flash_attention_bwd_dkdv(BWD_ARGS, int device) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return run(true, BWD_CALL);
}

extern "C" int flash_attention_bwd_dq(BWD_ARGS, int device) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return run(false, BWD_CALL);
}
