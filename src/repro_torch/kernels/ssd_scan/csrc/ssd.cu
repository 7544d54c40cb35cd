// K8: the Mamba-2 SSD intra-chunk step.
//
// Replaces the TPU kernel ssd_chunk_kernel / _ssd_kernel in
// src/repro/kernels/ssd_scan/kernel.py:71 (body :30, pallas_call :89).
//
// For every (batch b, chunk c of Q tokens, head h), with cum the in-chunk
// cumulative sum of the log decay (float32):
//
//   y_intra[t]   = sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s
//   contrib[p,n] = sum_s exp(cum_Q - cum_s) dt_s B_s[n] x_s[p]
//   total        = cum_Q
//
// all written in float32; x, B and C are float32 or bfloat16, the log
// decay and dt float32.  The decay is always exp(cum_t - cum_s) with
// s <= t (never exp(cum_t) * exp(-cum_s): cum falls to about -1e3 within a
// chunk and exp(-cum_s) would overflow), and masked pairs never reach the
// exponential's product.
//
// Bound on an H100: at the serving paths' prefill (B = 8, L = 512, Q = 256,
// 80 heads with P 64 and N 128, or 112 heads with N 64) the work is
// B NC H (Q^2 N + Q^2 P + 2 Q P N) operations, about 2e10, against the
// bytes of x, y_intra and contrib (B and C are shared by the heads and
// read with a head stride of 0), so bytes bound it.  This first version
// runs the products on the CUDA cores in float32.
//
// Design.  The Pallas kernel holds a whole Q x Q score and decay tile for
// four heads in VMEM; one head's 256 x 256 float32 tile is already past a
// block's 227 KB of shared memory, so the query rows are tiled instead,
// as K4 tiles them, without the softmax:
//  * ssd_intra_kernel: one block of 256 threads per (64-row query tile,
//    head, batch x chunk).  C's tile sits in shared memory; the block
//    loops over the key tiles that start at or before its last row,
//    loading B's and x's tiles and dt, forms the 64 x 64 weights
//    (C_t.B_s) exp(cum_t - cum_s) dt_s with s > t masked to 0, and
//    accumulates y in registers (each thread 4 rows and up to 8 columns).
//  * ssd_state_kernel: one block per (64 x 64 tile of (P, N), head, batch
//    x chunk) sums B_s exp(cum_Q - cum_s) dt_s (x) x_s over the chunk's
//    positions, 64 at a time; the tile (0, 0) block writes total.
// Both kernels compute cum in one fixed order (chunk_cumsum): each
// 32-position segment summed in order by one thread, then the segments'
// offsets summed in order and added.  Every block that reads cum reads
// the same bits, a launch gives the same bits every time, and the plain
// version (ref.py: chunk_cumsum) sums in the same order, so the two agree
// on cum to the bit.  That matters: cum reaches about -3e3 within a chunk,
// where a float32 ulp is 2.4e-4, and a decay exp(cum_t - cum_s) is only
// as exact as the difference, so two summation orders would differ in
// the decays by about 1e-3 relative.  One call of the entry point
// launches both kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Params {
  const void* x;          // (B, L, H, P) packed
  const float* ld;        // (B, L, H) packed: dt * A
  const float* dt;        // (B, L, H) packed
  const void* b;          // (B, L, H, N), feature stride 1
  const void* c;
  float* y;               // (B, L, H, P) packed
  float* contrib;         // (B, NC, H, P, N) packed
  float* total;           // (B, NC, H) packed
  long long b_sb, b_sl, b_sh, c_sb, c_sl, c_sh;  // element strides
  int L, H, P, N, Q, NC;
};

// cum[0..Q) of one (batch, chunk, head): ld_chunk points at the chunk's
// first position, positions H apart.  offs holds (Q + 31) / 32 floats.
// Ends with a __syncthreads().
__device__ void chunk_cumsum(float* cum, float* offs, const float* ld_chunk,
                             int H, int Q) {
  const int nseg = (Q + 31) / 32;
  for (int seg = threadIdx.x; seg < nseg; seg += kThreads) {
    const int end = min(Q, seg * 32 + 32);
    float v = 0.f;
#pragma unroll 8
    for (int i = seg * 32; i < end; ++i) {
      v += ld_chunk[(long long)i * H];
      cum[i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int seg = 0; seg < nseg; ++seg) {
      offs[seg] = run;
      run += cum[min(seg * 32 + 31, Q - 1)];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += kThreads) cum[i] += offs[i / 32];
  __syncthreads();
}

// Rows [r0, r0 + 64) of a (rows, cols) slab into shared memory as float32
// with row pitch ld; zero past `rows` and `cols`.  src_row is the element
// stride between rows; columns are packed.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long src_row, int r0,
                                          int rows, int cols, int width) {
  for (int idx = threadIdx.x; idx < kTile * width; idx += kThreads) {
    const int r = idx / width, col = idx - r * width;
    const int gr = r0 + r;
    dst[r * ld + col] = (gr < rows && col < cols)
                            ? to_f(src[gr * src_row + col]) : 0.f;
  }
}

template <typename T, int PJ>
__global__ void __launch_bounds__(kThreads) ssd_intra_kernel(Params p) {
  constexpr int PW = 16 * PJ;          // columns of x a block covers
  constexpr int LDX = PW + 1;
  constexpr int LDW = kTile + 1;
  const int LDN = p.N + 1;
  extern __shared__ float smem[];
  float* cs = smem;                    // 64 x LDN
  float* bs = cs + kTile * LDN;        // 64 x LDN
  float* xs = bs + kTile * LDN;        // 64 x LDX
  float* ws = xs + kTile * LDX;        // 64 x LDW
  float* dts = ws + kTile * LDW;       // 64
  float* cum = dts + kTile;            // Q
  float* offs = cum + p.Q;             // (Q + 31) / 32

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = blockIdx.x * kTile, h = blockIdx.y;
  const int b = blockIdx.z / p.NC, c = blockIdx.z % p.NC;
  const long long l0 = (long long)c * p.Q;   // the chunk's first position
  const long long row = (long long)b * p.L + l0;

  chunk_cumsum(cum, offs, p.ld + row * p.H + h, p.H, p.Q);

  const T* cg = static_cast<const T*>(p.c) + b * p.c_sb + l0 * p.c_sl
                + h * p.c_sh;
  const T* bg = static_cast<const T*>(p.b) + b * p.b_sb + l0 * p.b_sl
                + h * p.b_sh;
  const T* xg = static_cast<const T*>(p.x) + (row * p.H + h) * p.P;
  const long long x_row = (long long)p.H * p.P;
  load_rows<T>(cs, LDN, cg, p.c_sl, t0, p.Q, p.N, p.N);

  float acc[4][PJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

  // Key tiles that start at or before the tile's last row (and inside Q).
  const int s_end = min(p.Q, t0 + kTile);
  for (int s0 = 0; s0 < s_end; s0 += kTile) {
    __syncthreads();  // the previous tile is done with bs, xs, ws and dts
    load_rows<T>(bs, LDN, bg, p.b_sl, s0, p.Q, p.N, p.N);
    load_rows<T>(xs, LDX, xg, x_row, s0, p.Q, p.P, PW);
    for (int r = threadIdx.x; r < kTile; r += kThreads)
      dts[r] = s0 + r < p.Q ? p.dt[(row + s0 + r) * p.H + h] : 0.f;
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int n = 0; n < p.N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * LDN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * LDN + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx + 16 * j;
        float w = 0.f;
        if (t < p.Q && s <= t)
          w = sc[i][j] * expf(cum[t] - cum[s]) * dts[tx + 16 * j];
        ws[(ty + 16 * i) * LDW + tx + 16 * j] = w;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = ws[(ty + 16 * i) * LDW + kk];
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const float xv = xs[kk * LDX + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wv[i], xv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= p.Q) continue;
    float* yrow = p.y + ((row + t) * p.H + h) * p.P;
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int col = tx + 16 * j;
      if (col < p.P) yrow[col] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(Params p) {
  constexpr int LD = kTile + 1;
  extern __shared__ float smem[];
  float* xs = smem;                    // 64 positions x 64 columns of P
  float* bs = xs + kTile * LD;         // 64 positions x 64 columns of N
  float* wq = bs + kTile * LD;         // Q
  float* cum = wq + p.Q;               // Q
  float* offs = cum + p.Q;             // (Q + 31) / 32

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_tiles = (p.N + kTile - 1) / kTile;
  const int p0 = (blockIdx.x / n_tiles) * kTile;
  const int n0 = (blockIdx.x % n_tiles) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z / p.NC, c = blockIdx.z % p.NC;
  const long long l0 = (long long)c * p.Q;
  const long long row = (long long)b * p.L + l0;

  chunk_cumsum(cum, offs, p.ld + row * p.H + h, p.H, p.Q);
  const float last = cum[p.Q - 1];
  for (int s = threadIdx.x; s < p.Q; s += kThreads)
    wq[s] = expf(last - cum[s]) * p.dt[(row + s) * p.H + h];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    p.total[((long long)b * p.NC + c) * p.H + h] = last;

  const T* bg = static_cast<const T*>(p.b) + b * p.b_sb + l0 * p.b_sl
                + h * p.b_sh + n0;
  const T* xg = static_cast<const T*>(p.x) + (row * p.H + h) * p.P + p0;
  const long long x_row = (long long)p.H * p.P;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s0 = 0; s0 < p.Q; s0 += kTile) {
    __syncthreads();  // wq is written; the previous tile is done
    load_rows<T>(xs, LD, xg, x_row, s0, p.Q, p.P - p0, kTile);
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
      const int r = idx / kTile, col = idx - r * kTile;
      const int s = s0 + r;
      bs[r * LD + col] = (s < p.Q && n0 + col < p.N)
                             ? to_f(bg[s * p.b_sl + col]) * wq[s] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < kTile; ++s) {
      float xv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[s * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[s * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }

  float* out = p.contrib
               + (((long long)b * p.NC + c) * p.H + h) * p.P * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pp = p0 + ty + 16 * i;
    if (pp >= p.P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn < p.N) out[(long long)pp * p.N + nn] = acc[i][j];
    }
  }
}

size_t cum_floats(int Q) { return 2 * static_cast<size_t>(Q) + (Q + 31) / 32; }

template <int PJ>
size_t intra_smem(int N, int Q) {
  return sizeof(float) * (2 * static_cast<size_t>(kTile) * (N + 1)
                          + kTile * (16 * PJ + 1) + kTile * (kTile + 1)
                          + kTile + Q + (Q + 31) / 32);
}

size_t state_smem(int Q) {
  return sizeof(float) * (2 * static_cast<size_t>(kTile) * (kTile + 1)
                          + cum_floats(Q));
}

// Raises a kernel's dynamic shared memory limit to `bytes` when that is
// above 48 KB and above what was set before.
template <typename K>
int allow_smem(K kernel, size_t bytes, size_t* configured) {
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024 && bytes > *configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    *configured = bytes;
  }
  return 0;
}

template <typename T, int PJ>
int launch(const Params& p, int B, cudaStream_t stream) {
  static size_t intra_set = 0, state_set = 0;
  const size_t s1 = intra_smem<PJ>(p.N, p.Q), s2 = state_smem(p.Q);
  int rc = allow_smem(ssd_intra_kernel<T, PJ>, s1, &intra_set);
  if (rc) return rc;
  rc = allow_smem(ssd_state_kernel<T>, s2, &state_set);
  if (rc) return rc;
  const dim3 g1((p.Q + kTile - 1) / kTile, p.H, B * p.NC);
  ssd_intra_kernel<T, PJ><<<g1, kThreads, s1, stream>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  const dim3 g2(((p.P + kTile - 1) / kTile) * ((p.N + kTile - 1) / kTile),
                p.H, B * p.NC);
  ssd_state_kernel<T><<<g2, kThreads, s2, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t s) {
  if (p.P <= 64) return launch<T, 4>(p, B, s);
  if (p.P <= 128) return launch<T, 8>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b and c share it); log_decay and dt
// are float32.  x is a packed (B, L, H, P), log_decay and dt packed
// (B, L, H); b and c have a packed feature axis and the given element
// strides for batch, position and head (a head stride of 0 shares one
// row across the heads).  Outputs are packed float32: y (B, L, H, P),
// contrib (B, L / Q, H, P, N), total (B, L / Q, H).  L % Q == 0.
extern "C" int ssd_chunk(const void* x, const void* log_decay, const void* dt,
                         const void* b, const void* c, void* y, void* contrib,
                         void* total, long long b_sb, long long b_sl,
                         long long b_sh, long long c_sb, long long c_sl,
                         long long c_sh, int B, int L, int H, int P, int N,
                         int Q, int dtype, int device, void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (P <= 0 || N <= 0 || Q <= 0 || L % Q != 0 || H > 65535 ||
      static_cast<long long>(B) * (L / Q) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, static_cast<const float*>(log_decay),
           static_cast<const float*>(dt), b, c, static_cast<float*>(y),
           static_cast<float*>(contrib), static_cast<float*>(total),
           b_sb, b_sl, b_sh, c_sb, c_sl, c_sh, L, H, P, N, Q, L / Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
