// K6: split-K flash decoding, one query token per sequence against a
// ragged KV cache, with the log-sum-exp combine in the same call.
//
// Replaces the TPU kernel decode_attention_kernel / _decode_kernel in
// src/repro/kernels/decode_attention/kernel.py:55 (body :30, pallas_call
// :76) and the combine that the reference runs after it in plain JAX
// (:102-108).
//
// Bound on an H100: the bytes of K and V up to kv_len over 3.35 TB/s.
// Each cache element read feeds G = Hq / Hkv multiply-adds (4 on path S,
// 1 on paths M and H), far below the card's ratio of operations to bytes,
// so the design is about bytes in flight and launches; the arithmetic
// stays in float32 for float32 and bfloat16 alike.
//
// Design (kernel.py's plan sizes it from the shapes and the SM count):
//  * decode_partials_kernel: one block of 128 threads per (split of Ls
//    cache positions, KV head and group of at most 8 query rows, batch
//    row).  The grid comes from the cache's capacity S; kv_len stays on
//    the device.  A block whose first position is at or past kv_len
//    writes the empty partial (m = -1e30, l = 0, o = 0) and leaves without
//    reading the cache.  The live positions of K and V are copied into
//    shared memory with 16-byte cp.async loads (element copies where a
//    pitch or base is not 16-byte aligned) in stages of 32 positions,
//    double-buffered, so a stage is always in flight.  A lane holds 8
//    features of the group's query rows; LG lanes (D / 8 rounded up to a
//    power of two, at least 4) score one position for every row with
//    log2(LG) shuffles, and keep an online softmax (m, l and 8 features
//    of o a row) over the positions they scored.  The 128 / LG slots are
//    merged in slot order through shared memory, and the block writes its
//    float32 partial (o, m, l), m in log2 units.
//  * decode_combine_kernel: one block per (KV head and row group, batch
//    row, 128 outputs) reads the partials in split order:
//    alpha = 2^(m - m_max) and l_tot once a (split, row) into shared
//    memory, then, one output a thread, o_tot and
//    out = o_tot / max(l_tot, 1e-30) in q's dtype, as ref.combine_partials
//    does (in natural log units there).
// Positions count when they are below kv_len[b] and below S, as in the
// Pallas kernel.  Every sum runs in a fixed order and nothing is atomic,
// so a call gives the same bits every time.
#include "sm90.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_commit;
using sm90::cp_wait_one;

constexpr int kThreads = 128;
constexpr int kStage = 32;  // cache positions a stage
constexpr int kMaxSmem = 232448;
constexpr int kMaxSplits = 512;   // the combine's m and l in shared memory
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;      // (B, Hq, D) packed
  const void* k;      // (B, S, Hkv, D), heads and features packed
  const void* v;
  const int* kv_len;  // (B,)
  float* o;           // (B, Hkv, ns, G, D) packed
  float* m;           // (B, Hkv, ns, G), log2 units
  float* l;
  void* out;          // (B, Hq, D) packed, q's dtype (float32 with lse)
  float* lse;         // (B, Hq) natural log of the row's softmax sum, or null
  long long k_sb, k_ss, v_sb, v_ss;  // element strides
  int S, Hq, Hkv, D, G, split, ns, ngc, vec;
  float scale_log2;   // log2(e) / sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// The 16-byte chunk at `src` as floats (8 bf16 or 4 float32).
__device__ __forceinline__ void chunk_to_f(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void chunk_to_f(const __nv_bfloat16* src,
                                           float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Copies the rows [p0, p0 + 32) below `end` of one head of K and V into
// a stage: 32 rows of D elements each, packed.
template <typename T>
__device__ __forceinline__ void load_stage(T* ks, T* vs, const T* kg,
                                           const T* vg, const Params& p,
                                           int p0, int end) {
  constexpr int CE = 16 / sizeof(T);  // elements a 16-byte chunk
  const int nch = p.D / CE;
  for (int idx = threadIdx.x; idx < kStage * nch; idx += kThreads) {
    const int r = idx / nch, c = idx - r * nch;
    if (p0 + r >= end) continue;
    const T* ksrc = kg + (p0 + r) * p.k_ss + c * CE;
    const T* vsrc = vg + (p0 + r) * p.v_ss + c * CE;
    T* kd = ks + r * p.D + c * CE;
    T* vd = vs + r * p.D + c * CE;
    if (p.vec) {
      cp_async16(kd, ksrc);
      cp_async16(vd, vsrc);
    } else {
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        kd[e] = ksrc[e];
        vd[e] = vsrc[e];
      }
    }
  }
}

template <typename T, int LG, int GR>
__global__ void __launch_bounds__(kThreads)
    decode_partials_kernel(const Params p) {
  constexpr int CE = 16 / sizeof(T);  // elements a chunk
  constexpr int CH = 8 / CE;          // chunks a lane: 8 features
  constexpr int NS = kThreads / LG;   // slots: positions scored at once
  constexpr int PPS = kStage / NS;    // positions a slot scores a stage
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int D = p.D, nch = D / CE;
  const int sp = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / p.ngc, g0 = (blockIdx.y % p.ngc) * GR;
  const int rows = min(GR, p.G - g0);
  const int start = sp * p.split;
  const int kv_len = min(p.kv_len[b], p.S);
  const int end = min(start + p.split, kv_len);
  const long long part = (static_cast<long long>(b) * p.Hkv + h) * p.ns + sp;

  if (end <= start) {
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads)
      p.o[(part * p.G + g0) * D + idx] = 0.f;
    if (threadIdx.x < rows) {
      p.m[part * p.G + g0 + threadIdx.x] = kNegInf;
      p.l[part * p.G + g0 + threadIdx.x] = 0.f;
    }
    return;
  }

  T* st = reinterpret_cast<T*>(smem_raw);  // [2 stages][K, V][32][D]
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * D;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * D;
  const int n_st = (end - start + kStage - 1) / kStage;
  load_stage<T>(st, st + kStage * D, kg, vg, p, start, end);
  cp_commit();

  const int slot = threadIdx.x / LG, lane = threadIdx.x % LG;
  // This lane's query features: chunk lane + LG i of each row.
  float q[GR][8];
  const T* qg = static_cast<const T*>(p.q) +
                (static_cast<long long>(b) * p.Hq + h * p.G + g0) * D;
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + LG * i;
#pragma unroll
      for (int e = 0; e < CE; ++e)
        q[g][i * CE + e] = (g < rows && c < nch) ? to_f(qg[g * D + c * CE + e])
                                                 : 0.f;
    }
  float m[GR], l[GR], acc[GR][8];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[g][f] = 0.f;
  }

  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st) {
      T* nk = st + ((s + 1) & 1) * 2 * kStage * D;
      load_stage<T>(nk, nk + kStage * D, kg, vg, p, start + (s + 1) * kStage,
                    end);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const T* ks = st + (s & 1) * 2 * kStage * D;
    const T* vs = ks + kStage * D;
    const int p0 = start + s * kStage;

    float sc[GR][PPS];
    bool live[PPS];
#pragma unroll
    for (int i = 0; i < PPS; ++i) {
      const int j = slot + NS * i;
      live[i] = p0 + j < end;
      float kf[8];
#pragma unroll
      for (int ci = 0; ci < CH; ++ci) {
        const int c = lane + LG * ci;
        if (c < nch) {
          chunk_to_f(ks + j * D + c * CE, kf + ci * CE);
        } else {
#pragma unroll
          for (int e = 0; e < CE; ++e) kf[ci * CE + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int f = 0; f < 8; ++f) dot = fmaf(q[g][f], kf[f], dot);
#pragma unroll
        for (int off = LG / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[g][i] = live[i] ? dot * p.scale_log2 : kNegInf;
      }
    }
    // The scores become their weights p in place.
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < PPS; ++i) mx = fmaxf(mx, sc[g][i]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int f = 0; f < 8; ++f) acc[g][f] *= alpha;
#pragma unroll
      for (int i = 0; i < PPS; ++i) {
        sc[g][i] = live[i] ? exp2f(sc[g][i] - mx) : 0.f;
        l[g] += sc[g][i];
      }
    }
#pragma unroll
    for (int i = 0; i < PPS; ++i) {
      if (!live[i]) continue;
      const int j = slot + NS * i;
      float vf[8];
#pragma unroll
      for (int ci = 0; ci < CH; ++ci) {
        const int c = lane + LG * ci;
        if (c < nch) {
          chunk_to_f(vs + j * D + c * CE, vf + ci * CE);
        } else {
#pragma unroll
          for (int e = 0; e < CE; ++e) vf[ci * CE + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int f = 0; f < 8; ++f)
          acc[g][f] = fmaf(sc[g][i], vf[f], acc[g][f]);
    }
    __syncthreads();  // the stage is read before it is loaded again
  }

  // Merge the slots in slot order: [NS][GR] m, l, alpha; [NS][GR][D] o.
  float* red_m = reinterpret_cast<float*>(smem_raw);
  float* red_l = red_m + NS * GR;
  float* red_a = red_l + NS * GR;
  float* red_o = red_a + NS * GR;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      red_m[slot * GR + g] = m[g];
      red_l[slot * GR + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int ci = 0; ci < CH; ++ci) {
      const int c = lane + LG * ci;
      if (c < nch) {
#pragma unroll
        for (int e = 0; e < CE; ++e)
          red_o[(slot * GR + g) * D + c * CE + e] = acc[g][ci * CE + e];
      }
    }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int g = threadIdx.x;
    float mb = kNegInf;
    for (int s = 0; s < NS; ++s) mb = fmaxf(mb, red_m[s * GR + g]);
    float lb = 0.f;
    for (int s = 0; s < NS; ++s) {
      const float a = exp2f(red_m[s * GR + g] - mb);
      red_a[s * GR + g] = a;
      lb = fmaf(red_l[s * GR + g], a, lb);
    }
    p.m[part * p.G + g0 + g] = mb;
    p.l[part * p.G + g0 + g] = lb;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int g = idx / D, f = idx - g * D;
    float sum = 0.f;
    for (int s = 0; s < NS; ++s)
      sum = fmaf(red_o[(s * GR + g) * D + f], red_a[s * GR + g], sum);
    p.o[(part * p.G + g0) * D + idx] = sum;
  }
}

// The combine of one (KV head, group of at most GR query rows, batch row,
// 128 outputs): the splits' m and l into shared memory in one pass, then
// the alphas and l_tot, then one output a thread summed over the splits
// in split order.
template <typename T, int GR>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const Params p) {
  __shared__ float alpha[kMaxSplits * GR], ls[kMaxSplits * GR], ltot[GR];
  const int h = blockIdx.x / p.ngc, g0 = (blockIdx.x % p.ngc) * GR;
  const int b = blockIdx.y, rows = min(GR, p.G - g0), D = p.D;
  const long long base = (static_cast<long long>(b) * p.Hkv + h) * p.ns;
  for (int i = threadIdx.x; i < p.ns * rows; i += kThreads) {
    const int sp = i / rows, g = i - sp * rows;
    const long long r = (base + sp) * p.G + g0 + g;
    alpha[sp * GR + g] = p.m[r];
    ls[sp * GR + g] = p.l[r];
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int g = threadIdx.x;
    float mmax = kNegInf;
    for (int sp = 0; sp < p.ns; ++sp) mmax = fmaxf(mmax, alpha[sp * GR + g]);
    float lt = 0.f;
    for (int sp = 0; sp < p.ns; ++sp) {
      const float a = exp2f(alpha[sp * GR + g] - mmax);
      alpha[sp * GR + g] = a;
      lt = fmaf(ls[sp * GR + g], a, lt);
    }
    ltot[g] = fmaxf(lt, 1e-30f);
    // The row's log-sum-exp in natural units (m is in log2 units); a row
    // with no live position has none.
    if (p.lse != nullptr && blockIdx.z == 0)
      p.lse[static_cast<long long>(b) * p.Hq + h * p.G + g0 + g] =
          lt > 0.f ? (mmax + log2f(lt)) * kLn2 : kNegInf;
  }
  __syncthreads();
  const int idx = blockIdx.z * kThreads + threadIdx.x;
  if (idx >= rows * D) return;
  const int g = idx / D;
  const float* o = p.o + (base * p.G + g0) * D + idx;
  float ot = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < p.ns; ++sp)
    ot = fmaf(o[static_cast<long long>(sp) * p.G * D], alpha[sp * GR + g], ot);
  const long long row = (static_cast<long long>(b) * p.Hq + h * p.G + g0) * D;
  if (p.lse != nullptr)
    static_cast<float*>(p.out)[row + idx] = ot / ltot[g];
  else
    from_f(ot / ltot[g], static_cast<T*>(p.out) + row + idx);
}

// Dynamic shared memory of a partials block: the two stages, or the slot
// merge, whichever is larger.
size_t smem_bytes(int D, int esize, int lanes, int rows) {
  const size_t stages = 2ull * 2 * kStage * D * esize;
  const size_t ns = kThreads / lanes;
  const size_t merge = sizeof(float) * ns * rows * (3 + D);
  return stages > merge ? stages : merge;
}

template <typename T, int LG, int GR>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, sizeof(T), LG, GR);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_partials_kernel<T, LG, GR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid(p.ns, p.Hkv * p.ngc, B);
  decode_partials_kernel<T, LG, GR><<<grid, kThreads, smem, stream>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const dim3 cgrid(p.Hkv * p.ngc, B, (GR * p.D + kThreads - 1) / kThreads);
  decode_combine_kernel<T, GR><<<cgrid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LG>
int by_rows(const Params& p, int B, int rows, cudaStream_t s) {
  switch (rows) {
    case 1: return launch<T, LG, 1>(p, B, s);
    case 2: return launch<T, LG, 2>(p, B, s);
    case 4: return launch<T, LG, 4>(p, B, s);
    case 8: return launch<T, LG, 8>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_lanes(const Params& p, int B, int lanes, int rows, cudaStream_t s) {
  switch (lanes) {
    case 4: return by_rows<T, 4>(p, B, rows, s);
    case 8: return by_rows<T, 8>(p, B, rows, s);
    case 16: return by_rows<T, 16>(p, B, rows, s);
    case 32: return by_rows<T, 32>(p, B, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

namespace {

int run(const void* q, const void* k, const void* v, const void* kv_len,
        void* ws, void* out, float* lse, long long k_sb, long long k_ss,
        long long v_sb, long long v_ss, int B, int S, int Hq, int Hkv, int D,
        int split, int lanes, int rows, int vec, float scale, int dtype,
        int device, void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || Hq <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 ||
      D % 8 != 0 || split <= 0 || split % kStage != 0 || lanes * 8 < D ||
      B > 65535 || (S + split - 1) / split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv, ns = (S + split - 1) / split;
  const int ngc = (G + rows - 1) / rows;
  const long long o_size = static_cast<long long>(B) * Hkv * ns * G;
  float* o = static_cast<float*>(ws);
  Params p{q, k, v, static_cast<const int*>(kv_len), o, o + o_size * D,
           o + o_size * (D + 1), out, lse, k_sb, k_ss, v_sb, v_ss, S, Hq,
           Hkv, D, G, split, ns, ngc, vec, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_lanes<float>(p, B, lanes, rows, s);
  if (dtype == 1) return by_lanes<__nv_bfloat16>(p, B, lanes, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  Strides
// are in elements; q and out are packed (B, Hq, D), the head and feature
// axes of k and v are packed.  ws holds the float32 partials: o (B, Hkv,
// ns, G, D), then m and l (B, Hkv, ns, G), with ns = ceil(S / split).
// split (a multiple of 32, at most 512 splits), lanes (4, 8, 16 or 32,
// at least D / 8) and rows (1, 2, 4 or 8) are kernel.py's plan; vec says
// that the bases and
// the pitches of k and v are 16-byte aligned.  One call launches the
// partials kernel and the combine.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* kv_len, void* ws, void* out,
                                long long k_sb, long long k_ss,
                                long long v_sb, long long v_ss, int B, int S,
                                int Hq, int Hkv, int D, int split, int lanes,
                                int rows, int vec, float scale, int dtype,
                                int device, void* stream) {
  return run(q, k, v, kv_len, ws, out, nullptr, k_sb, k_ss, v_sb, v_ss, B,
             S, Hq, Hkv, D, split, lanes, rows, vec, scale, dtype, device,
             stream);
}

// decode_attention with a float32 out (B, Hq, D) and each row's
// log-sum-exp in lse (B, Hq) float32: m_max + log(l_tot) in natural
// units, -1e30 for a row with no live position (whose out is 0): the
// partial of one rank's block of a cache split over the sequence.
extern "C" int decode_attention_lse(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* ws, void* out, long long k_sb,
                                    long long k_ss, long long v_sb,
                                    long long v_ss, int B, int S, int Hq,
                                    int Hkv, int D, int split, int lanes,
                                    int rows, int vec, float scale,
                                    int dtype, int device, void* stream,
                                    void* lse) {
  return run(q, k, v, kv_len, ws, out, static_cast<float*>(lse), k_sb, k_ss,
             v_sb, v_ss, B, S, Hq, Hkv, D, split, lanes, rows, vec, scale,
             dtype, device, stream);
}

// A partials block's dynamic shared memory, to hold kernel.py's plan
// against.
extern "C" long long decode_attention_smem_bytes(int D, int dtype, int lanes,
                                                 int rows) {
  return static_cast<long long>(smem_bytes(D, dtype == 0 ? 4 : 2, lanes,
                                           rows));
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
