// K8b: the backward of K8, the Mamba-2 SSD intra-chunk step.
//
// The reference has no backward kernel: its training differentiates the
// plain einsums of src/repro/models/ssd.py:ssd_chunked (the intra-chunk
// part that src/repro/kernels/ssd_scan/kernel.py:71 computes forward).
// This kernel is the port's own, beside K8 (ssd.cu, ssd_tc.cu).
//
// For every (batch b, chunk c of Q tokens, head h), with cum the in-chunk
// cumulative sum of the log decay, L_ts = exp(cum_t - cum_s) for s <= t,
// S_ts = C_t.B_s, w_ts = S_ts L_ts dt_s, G_ts = dy_t.x_s,
// r_s = exp(cum_Q - cum_s) dt_s and the cotangents dy (of y_intra),
// dcontrib (P x N) and dtotal:
//
//   dx_s   = sum_{t>=s} w_ts dy_t + r_s (dcontrib B_s)
//   dC_t   = sum_{s<=t} G_ts L_ts dt_s B_s
//   dB_s   = sum_{t>=s} G_ts L_ts dt_s C_t + r_s (dcontrib^T x_s)
//   ddt_s  = sum_{t>=s} G_ts S_ts L_ts + exp(cum_Q - cum_s) u_s,
//            u_s = x_s^T dcontrib B_s
//   dcum_t = sum_{s<=t} G_ts w_ts - sum_{t'>=t} G_t't w_t't - R_t
//            (+ sum_s R_s + dtotal at t = Q - 1), R_s = r_s u_s
//   dlog_decay_j = sum_{i>=j} dcum_i   (cum is a prefix sum of it)
//
// all in float32; x, B and C are float32 or bfloat16, everything else
// float32.  cum is recomputed in K8's order (ssd.cu: chunk_cumsum; the
// plain version's ref.chunk_cumsum), so every decay equals the forward's
// to the bit, and it is always exp(cum_t - cum_s) with s <= t: never a
// product of exp(cum_t) and exp(-cum_s), which overflows within a chunk.
//
// Bound on an H100: at path TP's shape (B 1, L 4096, Q 256, 80 heads of
// P 64, N 128) the work is about twice K8's operations (the two score
// products S and G, then dx, dB and dC over the causal triangle, and the
// contrib terms) against the bytes of x, B, C, dy, dcontrib and the five
// outputs, so operations bound it on the float32 CUDA cores.  This first
// version runs them there.
//
// Design.  One block of 256 threads per (head, batch x chunk) walks the
// chunk's t x s triangle in 64 x 64 tiles, so no block ever holds the Q x
// Q decay matrix (256 KB at Q 256, past a block's 227 KB):
//  * outer loop over key tiles s: B_s and x_s sit in shared memory and
//    the block accumulates dx_s and dB_s in registers (each thread 4 rows
//    and up to 8 columns of each);
//  * inner loop over query tiles t >= s: C_t and dy_t are loaded, the
//    block forms S and G (each thread a 4 x 4 patch), then w, dS = G L dt
//    and A = G S L into shared tiles, adds w^T dy_t to dx_s, dS^T C_t to
//    dB_s, and dS B_s to dC_t, which lives in the output itself: the first
//    key tile writes it, later ones read, add and write it back, each
//    element always by the same thread (no other block touches this
//    (head, batch x chunk)); row sums of A dt and column sums of A go to
//    dcum and ddt in shared memory;
//  * after a key tile's query tiles, the contrib terms: dcontrib is
//    staged 64 rows of P at a time in C_t's buffer.
// Every sum runs in one fixed order: a launch gives the same bits every
// time, and no float atomics are used (no other block shares an output).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLdt = kTile + 1;      // pitch of the 64 x 64 float tiles
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct BwdParams {
  const void* x;          // (B, L, H, P) packed
  const float* ld;        // (B, L, H) packed: dt * A
  const float* dt;        // (B, L, H) packed
  const void* b;          // (B, L, H, N), feature stride 1
  const void* c;
  const float* dy;        // (B, L, H, P) packed
  const float* dcontrib;  // (B, NC, H, P, N) packed
  const float* dtotal;    // (B, NC, H) packed
  float* dx;              // (B, L, H, P) packed
  float* dld;             // (B, L, H) packed
  float* ddt;             // (B, L, H) packed
  float* db;              // (B, L, H, N) packed
  float* dc;              // (B, L, H, N) packed
  long long b_sb, b_sl, b_sh, c_sb, c_sl, c_sh;  // element strides
  int L, H, P, N, Q, NC;
};

// cum[0..Q) of one (batch, chunk, head) in K8's order (ssd.cu:
// chunk_cumsum): each 32-position segment summed in order by one thread,
// then the segments' offsets summed in order and added.  offs holds
// (Q + 31) / 32 floats.  Ends with a __syncthreads().
__device__ void chunk_cumsum(float* cum, float* offs, const float* ld_chunk,
                             int H, int Q) {
  const int nseg = (Q + 31) / 32;
  for (int seg = threadIdx.x; seg < nseg; seg += kThreads) {
    const int end = min(Q, seg * 32 + 32);
    float v = 0.f;
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
// with row pitch ld, `width` columns; zero past `rows` and `cols`.
// src_row is the element stride between rows; columns are packed.
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

// Shared memory of one block, in floats: B_s and C_t (64 x (N + 1)), x_s
// and dy_t (64 x (P + 1)), the w, dS and A tiles (64 x 65), then cum, dt
// and dcum (Q each), the segment offsets, the key tile's column sums of
// A and its R_s (64 each) and the running sum of R.
size_t bwd_smem_floats(int P, int N, int Q) {
  return 2 * static_cast<size_t>(kTile) * (N + 1)
         + 2 * static_cast<size_t>(kTile) * (P + 1)
         + 3 * static_cast<size_t>(kTile) * kLdt
         + 3 * static_cast<size_t>(Q) + (Q + 31) / 32 + 2 * kTile + 1;
}

// PJ: columns of P a thread covers (16 PJ >= P); NJ: columns of N.
template <typename T, int PJ, int NJ>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel(BwdParams p) {
  const int LDN = p.N + 1, LDP = p.P + 1;
  extern __shared__ float smem[];
  float* bs = smem;                     // 64 x LDN: B of the key tile
  float* cs = bs + kTile * LDN;         // 64 x LDN: C of the query tile
  float* xs = cs + kTile * LDN;         // 64 x LDP: x of the key tile
  float* ys = xs + kTile * LDP;         // 64 x LDP: dy of the query tile
  float* ws = ys + kTile * LDP;         // 64 x 65: w[t][s]
  float* ds = ws + kTile * kLdt;        // 64 x 65: dS[t][s]
  float* as = ds + kTile * kLdt;        // 64 x 65: A[t][s]
  float* cum = as + kTile * kLdt;       // Q
  float* dts = cum + p.Q;               // Q
  float* dcum = dts + p.Q;              // Q
  float* offs = dcum + p.Q;             // (Q + 31) / 32
  float* cola = offs + (p.Q + 31) / 32; // 64: the key tile's sum_t A
  float* rsv = cola + kTile;            // 64: the key tile's R_s
  float* rtot = rsv + kTile;            // 1: sum of R over the chunk

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y / p.NC, c = blockIdx.y % p.NC;
  const long long l0 = (long long)c * p.Q;   // the chunk's first position
  const long long row = (long long)b * p.L + l0;
  const int Q = p.Q, N = p.N, P = p.P;
  const int nt = (Q + kTile - 1) / kTile;

  chunk_cumsum(cum, offs, p.ld + row * p.H + h, p.H, Q);
  for (int i = tid; i < Q; i += kThreads) {
    dts[i] = p.dt[(row + i) * p.H + h];
    dcum[i] = 0.f;
  }
  if (tid == 0) *rtot = 0.f;
  __syncthreads();
  const float last = cum[Q - 1];

  const T* cg = static_cast<const T*>(p.c) + b * p.c_sb + l0 * p.c_sl
                + h * p.c_sh;
  const T* bg = static_cast<const T*>(p.b) + b * p.b_sb + l0 * p.b_sl
                + h * p.b_sh;
  const T* xg = static_cast<const T*>(p.x) + (row * p.H + h) * P;
  const float* yg = p.dy + (row * p.H + h) * P;
  const long long x_row = (long long)p.H * P;
  const long long n_row = (long long)p.H * N;   // dB, dC rows
  float* dcg = p.dc + (row * p.H + h) * N;
  float* dbg = p.db + (row * p.H + h) * N;
  float* dxg = p.dx + (row * p.H + h) * P;
  const float* dcon = p.dcontrib
                      + (((long long)b * p.NC + c) * p.H + h) * P * N;

  for (int si = 0; si < nt; ++si) {
    const int s0 = si * kTile;
    __syncthreads();  // the previous key tile is done with bs, xs, cola
    load_rows<T>(bs, LDN, bg, p.b_sl, s0, Q, N, N);
    load_rows<T>(xs, LDP, xg, x_row, s0, Q, P, P);
    if (tid < kTile) cola[tid] = 0.f;

    float dxa[4][PJ], dba[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < PJ; ++j) dxa[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) dba[i][j] = 0.f;
    }

    for (int ti = si; ti < nt; ++ti) {
      const int t0 = ti * kTile;
      __syncthreads();  // the previous query tile is done with cs, ys, ...
      load_rows<T>(cs, LDN, cg, p.c_sl, t0, Q, N, N);
      load_rows<float>(ys, LDP, yg, x_row, t0, Q, P, P);
      __syncthreads();

      // S = C_t B_s^T and G = dy_t x_s^T: each thread rows ty + 16 i of
      // the query tile, columns tx + 16 j of the key tile.
      float sc[4][4], gc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = gc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
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
#pragma unroll 4
      for (int q = 0; q < P; ++q) {
        float yv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = ys[(ty + 16 * i) * LDP + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[(tx + 16 * j) * LDP + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gc[i][j] = fmaf(yv[i], xv[j], gc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tl = ty + 16 * i, t = t0 + tl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sl = tx + 16 * j, s = s0 + sl;
          float w = 0.f, dsv = 0.f, a = 0.f;
          if (t < Q && s <= t) {
            const float lts = expf(cum[t] - cum[s]);
            const float ldt = lts * dts[s];
            w = sc[i][j] * ldt;
            dsv = gc[i][j] * ldt;
            a = gc[i][j] * sc[i][j] * lts;
          }
          ws[tl * kLdt + sl] = w;
          ds[tl * kLdt + sl] = dsv;
          as[tl * kLdt + sl] = a;
        }
      }
      __syncthreads();

      // dx_s += w^T dy_t and dB_s += dS^T C_t: rows ty + 16 i of the key
      // tile, columns tx + 16 j.
#pragma unroll 2
      for (int tl = 0; tl < kTile; ++tl) {
        float wv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = ws[tl * kLdt + ty + 16 * i];
          dv[i] = ds[tl * kLdt + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const float yv = ys[tl * LDP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dxa[i][j] = fmaf(wv[i], yv, dxa[i][j]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float cv = cs[tl * LDN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dba[i][j] = fmaf(dv[i], cv, dba[i][j]);
        }
      }

      // dC_t += dS B_s: rows ty + 16 i of the query tile, columns
      // tx + 16 j, read from and written back to the output.
      {
        float dca[4][NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dca[i][j] = 0.f;
#pragma unroll 2
        for (int sl = 0; sl < kTile; ++sl) {
          float dv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i] = ds[(ty + 16 * i) * kLdt + sl];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float bv = bs[sl * LDN + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) dca[i][j] = fmaf(dv[i], bv, dca[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
          if (t >= Q) continue;
          float* out = dcg + t * n_row;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int n = tx + 16 * j;
            if (n < N) out[n] = si == 0 ? dca[i][j] : out[n] + dca[i][j];
          }
        }
      }

      // Row sums of A dt (dcum at t) and column sums of A (ddt and dcum
      // at s), each one thread's sum in order.
      if (tid < kTile) {
        float v = 0.f;
        for (int sl = 0; sl < kTile; ++sl)
          v = fmaf(as[tid * kLdt + sl], s0 + sl < Q ? dts[s0 + sl] : 0.f, v);
        if (t0 + tid < Q) dcum[t0 + tid] += v;
      } else if (tid < 2 * kTile) {
        const int sl = tid - kTile;
        float v = 0.f;
        for (int tl = 0; tl < kTile; ++tl) v += as[tl * kLdt + sl];
        cola[sl] += v;
      }
    }
    __syncthreads();  // every query tile is done with cs, ys, ws, ds, as

    // The contrib terms of the key tile: v = dcontrib B_s (rows s, columns
    // p) into dx_s and u_s, and dcontrib^T x_s into dB_s, with dcontrib
    // staged 64 rows of P at a time in cs (row p, column n).
    float rs[4], rem[4], up[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + ty + 16 * i;
      rem[i] = s < Q ? expf(last - cum[s]) : 0.f;
      rs[i] = s < Q ? rem[i] * dts[s] : 0.f;
      up[i] = 0.f;
    }
    for (int pc = 0; pc * kTile < P; ++pc) {
      const int p0 = pc * kTile;
      load_rows<float>(cs, LDN, dcon, N, p0, P, N, N);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int pp = tx + 16 * j;
        if (pp / kTile != pc) continue;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int n = 0; n < N; ++n) {
          const float dv = cs[(pp - p0) * LDN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = fmaf(bs[(ty + 16 * i) * LDN + n], dv, v[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dxa[i][j] = fmaf(rs[i], v[i], dxa[i][j]);
          up[i] = fmaf(xs[(ty + 16 * i) * LDP + pp], v[i], up[i]);
        }
      }
      float e[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) e[i][j] = 0.f;
      const int pend = min(kTile, P - p0);
      for (int q = 0; q < pend; ++q) {
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 16 * i) * LDP + p0 + q];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float dv = cs[q * LDN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) e[i][j] = fmaf(xv[i], dv, e[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dba[i][j] = fmaf(rs[i], e[i][j], dba[i][j]);
      __syncthreads();  // done with this slice of dcontrib
    }
    // u_s: the 16 lanes of a row (the same ty) hold its columns' parts.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        up[i] += __shfl_xor_sync(0xffffffffu, up[i], off, 16);

    // dx_s and dB_s out; ddt_s, R_s and the column terms of dcum.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int sl = ty + 16 * i, s = s0 + sl;
      if (s >= Q) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int pp = tx + 16 * j;
        if (pp < P) dxg[s * x_row + pp] = dxa[i][j];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        if (n < N) dbg[s * n_row + n] = dba[i][j];
      }
      if (tx == 0) {
        const float r = rs[i] * up[i];
        p.ddt[(row + s) * p.H + h] = fmaf(rem[i], up[i], cola[sl]);
        dcum[s] -= fmaf(dts[s], cola[sl], r);
        rsv[sl] = r;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int sl = 0; sl < kTile && s0 + sl < Q; ++sl) v += rsv[sl];
      *rtot += v;
    }
  }
  __syncthreads();
  if (tid == 0)
    dcum[Q - 1] += *rtot + p.dtotal[((long long)b * p.NC + c) * p.H + h];
  __syncthreads();

  // dlog_decay: the suffix sums of dcum, 32-position segments each summed
  // from its end by one thread, then the segments' offsets from the last
  // segment down.
  const int nseg = (Q + 31) / 32;
  for (int seg = tid; seg < nseg; seg += kThreads) {
    const int lo = seg * 32, hi = min(Q, lo + 32);
    float v = 0.f;
    for (int i = hi - 1; i >= lo; --i) {
      v += dcum[i];
      dcum[i] = v;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int seg = nseg - 1; seg >= 0; --seg) {
      offs[seg] = run;
      run += dcum[seg * 32];
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads)
    p.dld[(row + i) * p.H + h] = dcum[i] + offs[i / 32];
}

int allow_smem(const void* kernel, size_t bytes, size_t* configured) {
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

template <typename T, int PJ, int NJ>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  static size_t configured = 0;
  const size_t bytes = sizeof(float) * bwd_smem_floats(p.P, p.N, p.Q);
  const void* k = reinterpret_cast<const void*>(ssd_bwd_kernel<T, PJ, NJ>);
  int rc = allow_smem(k, bytes, &configured);
  if (rc) return rc;
  const dim3 grid(p.H, B * p.NC);
  ssd_bwd_kernel<T, PJ, NJ><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const BwdParams& p, int B, cudaStream_t s) {
  if (p.P <= 64 && p.N <= 64) return launch_bwd<T, 4, 4>(p, B, s);
  if (p.P <= 64 && p.N <= 128) return launch_bwd<T, 4, 8>(p, B, s);
  if (p.P <= 128 && p.N <= 64) return launch_bwd<T, 8, 4>(p, B, s);
  if (p.P <= 128 && p.N <= 128) return launch_bwd<T, 8, 8>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The library's own count of a K8b launch's dynamic shared memory, bytes.
extern "C" long long ssd_bwd_smem_bytes(int P, int N, int Q) {
  return static_cast<long long>(sizeof(float) * bwd_smem_floats(P, N, Q));
}

// dtype: 0 = float32, 1 = bfloat16 (x, b and c share it); the rest is
// float32.  x, dy, dx are packed (B, L, H, P); log_decay, dt, dlog_decay,
// ddt packed (B, L, H); b and c have a packed feature axis and the given
// element strides for batch, position and head (a head stride of 0
// shares one row across the heads); db and dc are packed (B, L, H, N);
// dcontrib packed (B, L / Q, H, P, N), dtotal (B, L / Q, H).  L % Q == 0,
// P and N at most 128.
extern "C" int ssd_chunk_bwd(const void* x, const void* log_decay,
                             const void* dt, const void* b, const void* c,
                             const void* dy, const void* dcontrib,
                             const void* dtotal, void* dx, void* dld,
                             void* ddt, void* db, void* dc, long long b_sb,
                             long long b_sl, long long b_sh, long long c_sb,
                             long long c_sl, long long c_sh, int B, int L,
                             int H, int P, int N, int Q, int dtype,
                             int device, void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (P <= 0 || N <= 0 || Q <= 0 || L % Q != 0 || H > 65535 ||
      static_cast<long long>(B) * (L / Q) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{x, static_cast<const float*>(log_decay),
              static_cast<const float*>(dt), b, c,
              static_cast<const float*>(dy),
              static_cast<const float*>(dcontrib),
              static_cast<const float*>(dtotal), static_cast<float*>(dx),
              static_cast<float*>(dld), static_cast<float*>(ddt),
              static_cast<float*>(db), static_cast<float*>(dc),
              b_sb, b_sl, b_sh, c_sb, c_sl, c_sh, L, H, P, N, Q, L / Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_bwd<float>(p, B, s);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
