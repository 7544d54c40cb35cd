// K8b for bfloat16 x, B and C: the backward of K8 (the Mamba-2 SSD
// intra-chunk step), its products on the tensor cores.
//
// The reference has no backward kernel: its training differentiates the
// plain einsums of src/repro/models/ssd.py:ssd_chunked (the intra-chunk
// part that src/repro/kernels/ssd_scan/kernel.py:71 computes forward).
// ssd_bwd.cu keeps float32 and every shape this regime does not take;
// kernel.py's plan_bwd chooses, never by trying.  The math is ssd_bwd.cu's
// (the same names): for every (batch b, chunk c of Q tokens, head h), with
// L_ts = exp(cum_t - cum_s) for s <= t, S_ts = C_t.B_s, G_ts = dy_t.x_s,
// w_ts = S_ts L_ts dt_s, dS_ts = G_ts L_ts dt_s, A_ts = G_ts S_ts L_ts,
// r_s = exp(cum_Q - cum_s) dt_s, v_s = dcontrib B_s, u_s = x_s.v_s:
//
//   dx_s   = sum_{t>=s} w_ts dy_t + r_s v_s
//   dC_t   = sum_{s<=t} dS_ts B_s
//   dB_s   = sum_{t>=s} dS_ts C_t + r_s (dcontrib^T x_s)
//   ddt_s  = sum_{t>=s} A_ts + exp(cum_Q - cum_s) u_s
//   dcum_t = sum_{s<=t} A_ts dt_s - dt_t sum_{t'>=t} A_t't - r_t u_t
//            (+ sum_s r_s u_s + dtotal at t = Q - 1)
//   dlog_decay_j = sum_{i>=j} dcum_i
//
// Bound on an H100: at path TP's call (B 1, L 4096, Q 256, 80 heads of P
// 64, N 128) about 0.18 ms of bytes (x, dy, dcontrib and the five float32
// outputs, dB and dC a head each) against 0.06 ms of bf16 tensor-core
// operations, so bytes bound it; the float32 CUDA-core kernel ran 25x
// that, its five products on the CUDA cores.
//
// Design.  One warpgroup a block, one block a (head, batch x chunk), two
// blocks an SM (84 KB of shared memory at N 128), so one block's loads
// and conversions run under the other's products.  The block walks the
// chunk's causal triangle in 64 x 64 tiles, key tiles s outer and query
// tiles t >= s inner, and forms each tile pair's scores transposed (rows
// s, columns t), so that w^T and dS^T are already the A operands of
// dx_s += w^T dy_t and dB_s += dS^T C_t, taken from the accumulators in
// registers; dx_s and dB_s accumulate across the query tiles in
// registers.  Every operand is a 128-byte-swizzled tile of 64-column
// boxes, read K-major or MN-major as each product needs:
//  * B_s, C_t and x_s arrive by TMA (one row shared by the heads, as the
//    models pass B and C, is read through a map of one head);
//  * the float32 operands are split into bf16 parts (x = hi + mid + lo to
//    about 2^-24, hi + mid to 2^-16): dy_t in three parts, written by the
//    block into the swizzled layout; S^T = B_s C_t^T is exact (bf16 by
//    bf16, float32 sums); G^T = x_s dy_t^T takes all three parts, so A =
//    G S L, whose row and column sums feed ddt and dcum (sums of
//    cancelling terms, then a suffix sum), is built in float32 from a G as
//    good as the CUDA-core kernel's; w dy takes hi*hi + lo*hi + hi*lo of
//    two parts each, and the products by B and C two parts of dS and of
//    dcontrib (2^-16, against the 2e-2 gate in bf16);
//  * dC_t += dS B_s needs dS with rows t: dS^T's two parts are written to
//    shared memory and read as an MN-major A.  dC_t lives in the output:
//    the first key tile writes it, later ones read, add and write it back,
//    each element always by the thread that owns it in the accumulator
//    layout (no other block touches this (head, batch x chunk));
//  * dcontrib is staged in two parts over the dy and dS buffers after each
//    key tile's query tiles, for v_s and dcontrib^T x_s.
// S is formed again for each head: it is one exact product a tile pair,
// an eighth of the block's tensor-core work, where sharing it across a
// slice of heads would hold each head's dx_s and dB_s (or the chunk's S,
// 160 KB) in shared memory.  So a head's arithmetic is the same whether
// its B and C are shared or its own, and the two give the same bits.
// cum is recomputed in K8's order (chunk_cumsum), every decay is
// exp(cum_t - cum_s) with s <= t, every sum runs in one fixed order, and
// no float atomics are used: a launch gives the same bits every time.
#include "sm90.cuh"

namespace ssd_bwd_tc {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kThreads = 128;            // one warpgroup
constexpr int kRowBytes = 128;           // a box row: 64 bf16
constexpr int kBox = 64 * kRowBytes;     // a 64 x 64 box, 8,192 bytes
constexpr int kAlign = 1024;             // swizzle atom alignment
constexpr int kSeg = 32;                 // chunk_cumsum's segment
constexpr int kP = 64;                   // the head dim this regime takes
constexpr uint32_t kKLbo = 16, kKSbo = 1024;
constexpr uint32_t kMnLbo = kBox, kMnSbo = 1024;

// K-major descriptor of k-step kk of a 64-row tile whose contraction
// columns run in 64-column boxes one after another.
__device__ __forceinline__ uint64_t kmaj(uint32_t tile, int kk) {
  return desc(tile + (kk / 4) * kBox + (kk % 4) * 32, kKLbo, kKSbo);
}

// MN-major descriptor of k-step kk (rows 16 kk .. 16 kk + 15) of a tile
// whose rows are the contraction index, its columns in boxes of 64.
__device__ __forceinline__ uint64_t mnmaj(uint32_t tile, int kk) {
  return desc(tile + kk * 2048, kMnLbo, kMnSbo);
}

// Byte offset of element (r, c) in such a tile (128-byte swizzle).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c / 64) * kBox + r * kRowBytes +
         ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

__device__ __forceinline__ void st_shared2(uint32_t addr, uint32_t a,
                                           uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(a),
               "r"(b)
               : "memory");
}

// x and y as three bf16 pairs (each the bf16 rounding of what the parts
// before it left): hi + mid keeps them to about 2^-16, all three 2^-24.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

struct Args {
  const float* ld;        // (B, L, H) packed: dt * A
  const float* dt;        // (B, L, H) packed
  const float* dy;        // (B, L, H, P) packed
  const float* dcontrib;  // (B, NC, H, P, N) packed
  const float* dtotal;    // (B, NC, H) packed
  float* dx;              // (B, L, H, P) packed
  float* dld;             // (B, L, H) packed
  float* ddt;             // (B, L, H) packed
  float* db;              // (B, L, H, N) packed
  float* dc;              // (B, L, H, N) packed
  int L, H, Q, NC;
  int b_head, c_head;     // B's, C's head strides are nonzero
};

// The block's shared memory: B_s and C_t (NB boxes each), x_s, dy_t's
// three parts and dS^T's two (dcontrib's two parts reuse these five
// boxes), then cum, dt and dcum (Q floats each), the segment offsets, the
// four warps' column sums (4 x 64), a key tile's R_s (64) and their total.
int tc_smem(int nb, int Q) {
  return kAlign + (2 * nb + 6) * kBox +
         4 * (3 * Q + Q / kSeg + 4 * 64 + 64 + 1);
}

// cum[0..Q) of one (batch, chunk, head) in K8's order (chunk_cumsum): each
// 32-position segment summed in order by one thread, then the segments'
// offsets summed in order and added.  Ends with a __syncthreads().
__device__ void chunk_cumsum(float* cum, float* offs, const float* ld_chunk,
                             int H, int Q) {
  const int nseg = Q / kSeg;
  for (int seg = threadIdx.x; seg < nseg; seg += kThreads) {
    float v = 0.f;
    for (int i = seg * kSeg; i < seg * kSeg + kSeg; ++i) {
      v += ld_chunk[static_cast<long long>(i) * H];
      cum[i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int seg = 0; seg < nseg; ++seg) {
      offs[seg] = run;
      run += cum[seg * kSeg + kSeg - 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += kThreads) cum[i] += offs[i / kSeg];
  __syncthreads();
}

// NB: boxes of 64 columns of N (N = 64 NB).  Thread t of the warpgroup
// holds accumulator rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, and
// for each 8-column block j the columns 8 j + 2 (t % 4) + {0, 1}
// (sm90.cuh): registers 4 j + {0, 1} on row r0, 4 j + {2, 3} on r0 + 8.
template <int NB>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap cmap,
                      const Args a) {
  constexpr int N = 64 * NB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1u);
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bs = base, cs = bs + NB * kBox, xs = cs + NB * kBox;
  const uint32_t dyp = xs + kBox, dsp = dyp + 3 * kBox;
  const uint32_t dcp = dyp;              // dcontrib's parts, after the pairs
  const int Q = a.Q, H = a.H, nt = Q / 64;
  float* cum = reinterpret_cast<float*>(gbase + (dsp - base) + 2 * kBox);
  float* dts = cum + Q;
  float* dcum = dts + Q;
  float* offs = dcum + Q;
  float* red = offs + Q / kSeg;          // [warp][64 columns]
  float* rsv = red + 4 * 64;
  float* rtot = rsv + 64;

  const int tid = threadIdx.x, warp = tid / 32, q4 = tid % 4;
  const int r0 = 16 * warp + (tid % 32) / 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y / a.NC, c = blockIdx.y % a.NC;
  const int l0 = c * Q;
  const long long row0 = static_cast<long long>(b) * a.L + l0;
  const uint32_t barp = smem_u32(&bar);

  if (tid == 0) {
    bar_init(barp, 1);
    bar_init_fence();
    tma_prefetch(&xmap);
    tma_prefetch(&bmap);
    tma_prefetch(&cmap);
  }
  chunk_cumsum(cum, offs, a.ld + row0 * H + h, H, Q);
  for (int i = tid; i < Q; i += kThreads) {
    dts[i] = a.dt[(row0 + i) * H + h];
    dcum[i] = 0.f;
  }
  if (tid == 0) *rtot = 0.f;
  __syncthreads();
  const float last = cum[Q - 1];
  const int hb = a.b_head ? h : 0, hc = a.c_head ? h : 0;
  const long long prow = static_cast<long long>(H) * kP;   // dx, dy rows
  const long long nrow = static_cast<long long>(H) * N;    // dB, dC rows
  uint32_t phase = 0;

  for (int si = 0; si < nt; ++si) {
    const int s0 = 64 * si;
    float dxa[kP / 2], dba[N / 2], cola[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kP / 2; ++i) dxa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dba[i] = 0.f;
    float srow[2], drow[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      srow[rr] = cum[s0 + r0 + 8 * rr];
      drow[rr] = dts[s0 + r0 + 8 * rr];
    }

    for (int ti = si; ti < nt; ++ti) {
      const int t0 = 64 * ti;
      if (tid == 0) {   // C_t, and with the first query tile B_s and x_s
        const bool first = ti == si;
        bar_expect(barp, NB * kBox + (first ? NB * kBox + kBox : 0));
#pragma unroll
        for (int box = 0; box < NB; ++box)
          tma_load4(cs + box * kBox, &cmap, barp, 64 * box, hc, l0 + t0, b);
        if (first) {
#pragma unroll
          for (int box = 0; box < NB; ++box)
            tma_load4(bs + box * kBox, &bmap, barp, 64 * box, hb, l0 + s0,
                      b);
          tma_load4(xs, &xmap, barp, 0, h, l0 + s0, b);
        }
      }
      // dy_t's three parts, while the copies run: 16-byte reads, a warp
      // two rows of 256 bytes.
      const float* dyt = a.dy + (row0 + t0) * prow + static_cast<long long>(h) * kP;
#pragma unroll 4
      for (int idx = tid; idx < 64 * kP / 4; idx += kThreads) {
        const int row = idx / (kP / 4), col = 4 * (idx % (kP / 4));
        const float4 v =
            *reinterpret_cast<const float4*>(dyt + row * prow + col);
        uint32_t p[3][2];
        split3(v.x, v.y, p[0][0], p[1][0], p[2][0]);
        split3(v.z, v.w, p[0][1], p[1][1], p[2][1]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          st_shared2(dyp + k * kBox + swz(row, col), p[k][0], p[k][1]);
      }
      fence_async_smem();
      __syncthreads();
      bar_wait(barp, phase);
      phase ^= 1;

      // S^T = B_s C_t^T (exact) and G^T = x_s dy_t^T (three parts).
      float sc[32], gc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = gc[i] = 0.f;
      fence_regs(sc);
      fence_regs(gc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        mma_ss<64, 0, 0>(sc, kmaj(bs, kk), kmaj(cs, kk));
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          mma_ss<64, 0, 0>(gc, kmaj(xs, kk), kmaj(dyp + k * kBox, kk));
      wgmma_commit();
      fence_regs(sc);
      fence_regs(gc);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(gc);

      // w^T, dS^T in place of S^T, G^T; A's sums: over t (cola, this
      // thread's rows) and of A dt_s over s (csum, this thread's columns).
      float csum[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) csum[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 ct =
            *reinterpret_cast<const float2*>(cum + t0 + 8 * j + 2 * q4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, rr = e / 2;
          const int s = s0 + r0 + 8 * rr, t = t0 + 8 * j + 2 * q4 + e % 2;
          const float l = s <= t ? expf((e % 2 ? ct.y : ct.x) - srow[rr])
                                 : 0.f;
          const float ldt = l * drow[rr];
          const float av = gc[i] * sc[i] * l;
          cola[rr] += av;
          csum[2 * j + e % 2] = fmaf(av, drow[rr], csum[2 * j + e % 2]);
          sc[i] *= ldt;
          gc[i] *= ldt;
        }
      }
      // dS^T's two parts into shared memory ([s][t]), for dC's product.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t hi, lo;
          split_bf16(gc[4 * j + 2 * rr], gc[4 * j + 2 * rr + 1], hi, lo);
          const uint32_t off = swz(r0 + 8 * rr, 8 * j + 2 * q4);
          st_shared(dsp + off, hi);
          st_shared(dsp + kBox + off, lo);
        }
      // csum over the warp's 16 rows (the lanes that share t % 4), then the
      // four warps' in order below.
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float v = csum[k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (tid % 32 < 4) red[warp * 64 + 8 * (k / 2) + 2 * q4 + k % 2] = v;
      }
      fence_async_smem();
      __syncthreads();
      if (tid < 64)
        dcum[t0 + tid] += ((red[tid] + red[64 + tid]) + red[128 + tid]) +
                          red[192 + tid];

      // dx_s += w^T dy_t and dB_s += dS^T C_t, A from registers.
      {
        uint32_t wh[4][4], wl[4][4], dh[4][4], dl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          split_a(wh[kk], wl[kk], sc, kk);
          split_a(dh[kk], dl[kk], gc, kk);
        }
        fence_regs(dxa);
        fence_regs(dba);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t yh = mnmaj(dyp, kk), ym = mnmaj(dyp + kBox, kk);
          mma_rs<64, 1>(dxa, wh[kk], yh);
          mma_rs<64, 1>(dxa, wl[kk], yh);
          mma_rs<64, 1>(dxa, wh[kk], ym);
          const uint64_t cd = mnmaj(cs, kk);
          mma_rs<N, 1>(dba, dh[kk], cd);
          mma_rs<N, 1>(dba, dl[kk], cd);
        }
        wgmma_commit();
        fence_regs(dxa);
        fence_regs(dba);
        wgmma_wait<0>();
        fence_regs(dxa);
        fence_regs(dba);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(wh[kk]);
          fence_regs(wl[kk]);
          fence_regs(dh[kk]);
          fence_regs(dl[kk]);
        }
      }

      // dC_t += dS B_s: dS's parts MN-major from shared memory, the sum
      // read, added and written back by the thread that owns it.
      {
        float dca[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) dca[i] = 0.f;
        fence_regs(dca);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_ss<N, 1, 1>(dca, mnmaj(dsp + k * kBox, kk), mnmaj(bs, kk));
        wgmma_commit();
        fence_regs(dca);
        wgmma_wait<0>();
        fence_regs(dca);
        float* dcg = a.dc + (row0 + t0) * nrow + static_cast<long long>(h) * N;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float2* p = reinterpret_cast<float2*>(
                dcg + (r0 + 8 * rr) * nrow + 8 * j + 2 * q4);
            float2 v = make_float2(dca[4 * j + 2 * rr], dca[4 * j + 2 * rr + 1]);
            if (si > 0) {
              const float2 o = *p;
              v = make_float2(o.x + v.x, o.y + v.y);
            }
            *p = v;
          }
      }
      __syncthreads();   // cs, the parts and red are free for the next pair
    }

    // The contrib terms of the key tile: dcontrib in two parts ([p][n])
    // over the dy and dS buffers.
    const float* dcon = a.dcontrib +
        ((static_cast<long long>(b) * a.NC + c) * H + h) * kP * N;
#pragma unroll 4
    for (int idx = tid; idx < kP * N / 4; idx += kThreads) {
      const int row = idx / (N / 4), col = 4 * (idx % (N / 4));
      const float4 v = *reinterpret_cast<const float4*>(dcon + row * N + col);
      uint32_t hi[2], lo[2];
      split_bf16(v.x, v.y, hi[0], lo[0]);
      split_bf16(v.z, v.w, hi[1], lo[1]);
      st_shared2(dcp + swz(row, col), hi[0], hi[1]);
      st_shared2(dcp + NB * kBox + swz(row, col), lo[0], lo[1]);
    }
    fence_async_smem();
    __syncthreads();
    float rem[2], rs[2], up[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rem[rr] = expf(last - srow[rr]);
      rs[rr] = rem[rr] * drow[rr];
    }
    float* dxg = a.dx + (row0 + s0) * prow + static_cast<long long>(h) * kP;
    {   // v_s = B_s dcontrib^T: into dx_s and u_s; dx_s out.
      float va[kP / 2];
#pragma unroll
      for (int i = 0; i < kP / 2; ++i) va[i] = 0.f;
      fence_regs(va);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          mma_ss<64, 0, 0>(va, kmaj(bs, kk), kmaj(dcp + k * NB * kBox, kk));
      wgmma_commit();
      fence_regs(va);
      wgmma_wait<0>();
      fence_regs(va);
#pragma unroll
      for (int j = 0; j < kP / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = r0 + 8 * rr, col = 8 * j + 2 * q4;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
              gbase + (xs - base) + swz(row, col));
          const float2 xf = __bfloat1622float2(xv);
          const int i = 4 * j + 2 * rr;
          up[rr] = fmaf(xf.x, va[i], up[rr]);
          up[rr] = fmaf(xf.y, va[i + 1], up[rr]);
          dxa[i] = fmaf(rs[rr], va[i], dxa[i]);
          dxa[i + 1] = fmaf(rs[rr], va[i + 1], dxa[i + 1]);
          *reinterpret_cast<float2*>(dxg + row * prow + col) =
              make_float2(dxa[i], dxa[i + 1]);
        }
    }
    {   // dB_s += r_s (x_s dcontrib); dB_s out.
      float ea[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) ea[i] = 0.f;
      fence_regs(ea);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk)
          mma_ss<N, 0, 1>(ea, kmaj(xs, kk), mnmaj(dcp + k * NB * kBox, kk));
      wgmma_commit();
      fence_regs(ea);
      wgmma_wait<0>();
      fence_regs(ea);
      float* dbg = a.db + (row0 + s0) * nrow + static_cast<long long>(h) * N;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * j + 2 * rr;
          *reinterpret_cast<float2*>(dbg + (r0 + 8 * rr) * nrow + 8 * j +
                                     2 * q4) =
              make_float2(fmaf(rs[rr], ea[i], dba[i]),
                          fmaf(rs[rr], ea[i + 1], dba[i + 1]));
        }
    }
    // The rows' sums over their quad; ddt_s, R_s and dcum's column terms.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      cola[rr] += __shfl_xor_sync(0xffffffffu, cola[rr], 1);
      cola[rr] += __shfl_xor_sync(0xffffffffu, cola[rr], 2);
      up[rr] += __shfl_xor_sync(0xffffffffu, up[rr], 1);
      up[rr] += __shfl_xor_sync(0xffffffffu, up[rr], 2);
    }
    if (q4 == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int sl = r0 + 8 * rr, s = s0 + sl;
        const float r = rs[rr] * up[rr];
        a.ddt[(row0 + s) * H + h] = fmaf(rem[rr], up[rr], cola[rr]);
        dcum[s] -= fmaf(drow[rr], cola[rr], r);
        rsv[sl] = r;
      }
    }
    __syncthreads();   // rsv written; x_s, B_s and the parts are free
    if (tid == 0) {
      float v = 0.f;
      for (int sl = 0; sl < 64; ++sl) v += rsv[sl];
      *rtot += v;
    }
  }
  __syncthreads();
  if (tid == 0)
    dcum[Q - 1] += *rtot + a.dtotal[(static_cast<long long>(b) * a.NC + c) * H + h];
  __syncthreads();

  // dlog_decay: the suffix sums of dcum, 32-position segments each summed
  // from its end by one thread, then the segments' offsets from the last
  // segment down (ssd_bwd.cu's order).
  const int nseg = Q / kSeg;
  for (int seg = tid; seg < nseg; seg += kThreads) {
    float v = 0.f;
    for (int i = seg * kSeg + kSeg - 1; i >= seg * kSeg; --i) {
      v += dcum[i];
      dcum[i] = v;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int seg = nseg - 1; seg >= 0; --seg) {
      offs[seg] = run;
      run += dcum[seg * kSeg];
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += kThreads)
    a.dld[(row0 + i) * H + h] = dcum[i] + offs[i / kSeg];
}

// The rank-4 map of a (B, L, H, F) bf16 operand over (F, H, L, B) with
// element strides (sb, sl, sh), read in boxes of 64 columns by 64 rows of
// L; a head stride of 0 is described as one head (ssd_tc.cu's).
int map_blhf(CUtensorMap* map, const void* ptr, int B, int L, int H, int F,
             long long sb, long long sl, long long sh) {
  const long long dims[4] = {F, sh ? H : 1, L, B};
  const long long strides[3] = {(sh ? sh : sl) * 2, sl * 2, sb * 2};
  const int box[4] = {64, 1, 64, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NB>
int launch(const CUtensorMap& xm, const CUtensorMap& bm,
           const CUtensorMap& cm, const Args& a, int B, cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int smem = tc_smem(NB, a.Q);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_tc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid(a.H, B * a.NC);
  ssd_bwd_tc_kernel<NB><<<grid, kThreads, smem, stream>>>(xm, bm, cm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ssd_bwd_tc

// K8b in the tensor-core regime (bf16 x, B and C; the rest float32).  x,
// dy and dx are packed (B, L, H, P) with P = 64; b and c have a packed
// feature axis of N = 64 or 128 and the given element strides (each a
// multiple of 8 elements, the bases 16-byte aligned; a head stride of 0
// shares one row across the heads); log_decay, dt, dlog_decay and ddt are
// packed (B, L, H); db and dc packed (B, L, H, N); dcontrib packed
// (B, L / Q, H, P, N), dtotal (B, L / Q, H).  Q a multiple of 64 up to
// 256, L % Q == 0.  Outputs as ssd_chunk_bwd's.  device: the tensors'
// card, made current first (autograd's worker thread may not have used it
// yet, and a thread with no current context cannot launch).
extern "C" int ssd_chunk_bwd_tc(const void* x, const void* log_decay,
                                const void* dt, const void* b, const void* c,
                                const void* dy, const void* dcontrib,
                                const void* dtotal, void* dx, void* dld,
                                void* ddt, void* db, void* dc, long long b_sb,
                                long long b_sl, long long b_sh, long long c_sb,
                                long long c_sl, long long c_sh, int B, int L,
                                int H, int P, int N, int Q, int device,
                                void* stream) {
  using namespace ssd_bwd_tc;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (P != kP || (N != 64 && N != 128) || Q <= 0 || Q > 256 || Q % 64 ||
      L % Q || static_cast<long long>(B) * (L / Q) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, bm, cm;
  int rc = map_blhf(&xm, x, B, L, H, P, static_cast<long long>(L) * H * P,
                    static_cast<long long>(H) * P, P);
  if (rc == 0) rc = map_blhf(&bm, b, B, L, H, N, b_sb, b_sl, b_sh);
  if (rc == 0) rc = map_blhf(&cm, c, B, L, H, N, c_sb, c_sl, c_sh);
  if (rc != 0) return rc;
  const Args a{static_cast<const float*>(log_decay),
               static_cast<const float*>(dt), static_cast<const float*>(dy),
               static_cast<const float*>(dcontrib),
               static_cast<const float*>(dtotal), static_cast<float*>(dx),
               static_cast<float*>(dld), static_cast<float*>(ddt),
               static_cast<float*>(db), static_cast<float*>(dc),
               L, H, Q, L / Q, b_sh != 0, c_sh != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N == 64 ? launch<1>(xm, bm, cm, a, B, s)
                 : launch<2>(xm, bm, cm, a, B, s);
}

// A tensor-core launch's dynamic shared memory, to hold kernel.py's
// plan_bwd against.
extern "C" long long ssd_bwd_tc_smem_bytes(int N, int Q) {
  return ssd_bwd_tc::tc_smem(N / 64, Q);
}
