// K8 for bfloat16 x, B and C: the Mamba-2 SSD intra-chunk step, its state
// product on the tensor cores.
//
// Replaces, for bf16 at the shapes kernel.py's plan names "tensor_core",
// the TPU kernel ssd_chunk_kernel / _ssd_kernel in
// src/repro/kernels/ssd_scan/kernel.py:71 (body :30, pallas_call :89);
// ssd.cu keeps float32 and everything else (the plan chooses, never by
// trying).  The math is ssd.cu's:
//
//   y_intra[t]   = sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s
//   contrib[p,n] = sum_s exp(cum_Q - cum_s) dt_s B_s[n] x_s[p]
//   total        = cum_Q
//
// all three written in float32.
//
// Bound on an H100: the bytes of x, y_intra and contrib (B and C are one
// row shared by the heads).  The models pass B and C as one row expanded
// over the heads, so C_t.B_s is the same for every head: at path P it was
// 2/3 of the CUDA-core kernel's multiply-adds, at H 1/2.
//
// Design:
//  * ssd_intra_shared_kernel (y and nothing else) stays on the CUDA cores,
//    in the plain version's order, with C_t.B_s formed once for a slice of
//    heads that share B and C (its comment says why the tensor cores cannot
//    take it).
//  * ssd_state_tc_kernel: one block of two warpgroups per (slice of heads,
//    batch x chunk).  B's chunk is TMA-loaded once for the slice; the
//    warpgroups take alternate (head, 64-column box of P) units, so one's
//    scaling overlaps the other's products.  x's chunk arrives by TMA
//    128 keys at a time (the next step's while this one's products run),
//    is scaled by w_s = exp(cum_Q - cum_s) dt_s and split into three bf16
//    parts written in TMA's swizzled layout, and contrib = sum over the
//    parts of (x w)_part^T B runs as SS wgmma with both operands MN-major
//    (x and B are bf16 and exact in the tensor cores; three parts keep the
//    weights to about 2^-24, where two, 2^-16, missed K8's 1e-4).  The
//    block writes total.
// Both kernels compute the in-chunk cumulative sum in ssd.cu's order
// (chunk_cumsum: each 32-position segment in order, then the offsets), so
// they, the CUDA-core kernels and the plain version agree on cum to the
// bit; the decay is always exp(cum_t - cum_s), never factored.  A head gets
// the same arithmetic on the same tiles whether its slice is shared or its
// own, so shared and packed B and C give the same bits, and with no
// atomics two launches do too.
#include "sm90.cuh"

namespace ssd_tc {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kRowBytes = 128;            // a box row: 64 bf16
constexpr int kBox = 64 * kRowBytes;      // a 64-row box, 8,192 bytes
constexpr int kAlign = 1024;              // swizzle atom alignment
constexpr int kMaxSlice = 8;
constexpr int kMaxKeyTiles = 4;           // Q <= 256
constexpr int kSeg = 32;                  // chunk_cumsum's segment
constexpr uint32_t kMnLbo = kBox, kMnSbo = 1024;

// MN-major descriptor of k-step kk (rows 16 kk .. 16 kk + 15) of a tile
// laid out as [64-row group][box] with `nb` boxes a group, from box `c`.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int nb, int c,
                                            int kk) {
  return desc(tile + ((kk / 4) * nb + c) * kBox + (kk % 4) * 2048, kMnLbo,
              kMnSbo);
}

// x and y as three bf16 pairs whose sum keeps them to about 2^-24 (each
// part is the bf16 rounding of what the parts before it left; two would
// keep 2^-16).
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi,
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
  const bf16* x;     // (B, L, H, P) packed
  const bf16* b;     // (B, L, H, N), feature stride 1
  const bf16* c;
  long long b_sb, b_sl, b_sh, c_sb, c_sl, c_sh;   // element strides
  const float* ld;   // (B, L, H) packed: dt * A
  const float* dt;   // (B, L, H) packed
  float* y;          // (B, L, H, P) packed
  float* contrib;    // (B, NC, H, P, N) packed
  float* total;      // (B, NC, H) packed
  int L, H, P, N, Q, NC, slice;
};

// cum[j][0..Q) of heads h0 .. h0 + nh - 1 of one (batch, chunk) whose
// first row is `row0`, in chunk_cumsum's order, by the first NT threads
// (named barrier 1); offs holds nh * Q / 32 floats.
template <int NT>
__device__ void slice_cumsum(float* cum, float* offs, const Args& a,
                             long long row0, int h0, int nh, int tid) {
  const int nseg = a.Q / kSeg;
  for (int task = tid; task < nh * nseg; task += NT) {
    const int j = task / nseg, seg = task - j * nseg;
    const float* src = a.ld + (row0 + seg * kSeg) * a.H + h0 + j;
    float* dst = cum + j * a.Q + seg * kSeg;
    float ld[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      ld[i] = src[static_cast<long long>(i) * a.H];
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      v += ld[i];
      dst[i] = v;
    }
  }
  named_sync(1, NT);
  for (int j = tid; j < nh; j += NT) {
    float run = 0.f;
    for (int seg = 0; seg < nseg; ++seg) {
      offs[j * nseg + seg] = run;
      run += cum[j * a.Q + seg * kSeg + kSeg - 1];
    }
  }
  named_sync(1, NT);
  for (int i = tid; i < nh * a.Q; i += NT)
    cum[i] += offs[(i / a.Q) * nseg + (i % a.Q) / kSeg];
  named_sync(1, NT);
}

// The intra kernel's shared memory, in floats: C's tile and a key tile of
// B transposed (n-major), which the head loop's weights (key-major) and
// its double-buffered bf16 x tiles reuse; the scores of every key tile;
// then cum, dt and the segment offsets of the slice.
constexpr int kLdt = 68;   // a transposed tile's pitch (floats; 16-byte rows)
template <int PG>
struct IntraLayout {
  static constexpr int kXp = 64 * PG + 8;              // x row pitch (bf16)
  // A half's weights and two x tiles, for each of the two halves.
  static constexpr int kHalfFloats = 64 * kLdt + 2 * 64 * kXp / 2;
  static constexpr int kHeadFloats = 2 * kHalfFloats;
};

int intra_smem(int N, int pg, int Q, int slice) {
  const int head = pg == 1 ? IntraLayout<1>::kHeadFloats
                           : IntraLayout<2>::kHeadFloats;
  const int a = 2 * N * kLdt > head ? 2 * N * kLdt : head;
  return 4 * (a + kMaxKeyTiles * 64 * kLdt + 2 * slice * Q +
              slice * (Q / kSeg));
}

// y_intra on the CUDA cores, in the plain version's order: each score a
// chain of fmaf over n from 0, each weight (score * exp(cum_t - cum_s)) *
// dt_s, each output a chain of fmaf over the keys in order.  So y equals
// ref.ssd_chunk_ref's bit for bit, as ssd.cu's kernel does: a tensor-core
// y (wgmma sums in its own order) held 1e-4 but moved path P's
// teacher-forced logits by 2.1e-2 through 64 bf16 layers, past their gate,
// where the float32 plain version itself sits 1.9e-2 from a float64 one.
// One block of 512 threads per (64 query rows, slice of heads, batch x
// chunk), the blocks with the most key tiles launched first.  The scores
// C_t.B_s of the block's key tiles are formed once for the slice and kept
// in shared memory; then each half of the block (its own named barrier)
// takes alternate heads: for each head and key tile the weights go to
// shared memory key-major and x's tile arrives by cp.async, double-
// buffered.  A thread owns 4 rows by 4 columns of each tile (16-byte
// reads of the transposed tiles).
template <int PG>
__global__ void __launch_bounds__(512, 1)
    ssd_intra_shared_kernel(const Args a) {
  using Lay = IntraLayout<PG>;
  extern __shared__ __align__(16) float smf[];
  const int Q = a.Q, N = a.N, P = a.P;
  const int a_floats = 2 * N * kLdt > Lay::kHeadFloats ? 2 * N * kLdt
                                                        : Lay::kHeadFloats;
  const int tid = threadIdx.x, half = tid / 256;
  const int tx = tid % 16, ty = (tid % 256) / 16;
  float* ct = smf;                          // [n][64 rows]
  float* bt = smf + N * kLdt;               // [n][64 keys]
  float* wt = smf + half * Lay::kHalfFloats;   // [64 keys][64 rows]
  bf16* xb = reinterpret_cast<bf16*>(wt + 64 * kLdt);   // [2][64][kXp]
  float* sc_all = smf + a_floats;           // [key tile][64 keys][64 rows]
  float* cum = sc_all + kMaxKeyTiles * 64 * kLdt;
  float* dts = cum + a.slice * Q;
  float* offs = dts + a.slice * Q;

  const int qt = gridDim.x - 1 - blockIdx.x, t0 = 64 * qt;
  const int h0 = blockIdx.y * a.slice, nh = min(a.slice, a.H - h0);
  const int b = blockIdx.z / a.NC, c = blockIdx.z % a.NC;
  const int l0 = c * Q;
  const long long row0 = static_cast<long long>(b) * a.L + l0;
  const int nkw = qt + 1;                   // key tiles at or before t0

  slice_cumsum<512>(cum, offs, a, row0, h0, nh, tid);
  for (int i = tid; i < nh * Q; i += 512) {
    const int j = i / Q;
    dts[i] = a.dt[(row0 + i - j * Q) * a.H + h0 + j];
  }

  // A (64 x N) bf16 tile of C or B, rows r0.. of the chunk, into [n][row].
  auto load_t = [&](float* dst, const bf16* src, long long sb, long long sl,
                    long long sh, int r0) {
    const bf16* g = src + b * sb + (l0 + r0) * sl + h0 * sh;
    for (int idx = tid; idx < 64 * (N / 8); idx += 512) {
      // Rows fastest: a warp's stores of one n then fall in 32 banks.
      const int r = idx % 64, q = idx / 64;
      const uint4 v = *reinterpret_cast<const uint4*>(g + r * sl + 8 * q);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        dst[(8 * q + 2 * e) * kLdt + r] = f.x;
        dst[(8 * q + 2 * e + 1) * kLdt + r] = f.y;
      }
    }
  };
  load_t(ct, a.c, a.c_sb, a.c_sl, a.c_sh, t0);
  for (int kt = 0; kt < nkw; ++kt) {
    load_t(bt, a.b, a.b_sb, a.b_sl, a.b_sh, 64 * kt);
    __syncthreads();
    if (half == 0) {   // the scores on the first half's threads
      float sc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        const float4 cv =
            *reinterpret_cast<const float4*>(ct + n * kLdt + 4 * ty);
        const float4 bv =
            *reinterpret_cast<const float4*>(bt + n * kLdt + 4 * tx);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[i][k] = fmaf(c4[i], b4[k], sc[i][k]);
      }
      float* sct = sc_all + kt * 64 * kLdt;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<float4*>(sct + (4 * tx + k) * kLdt + 4 * ty) =
            make_float4(sc[0][k], sc[1][k], sc[2][k], sc[3][k]);
    }
    __syncthreads();   // bt is read before the next key tile replaces it
  }

  // The half's units u = (head j = half + 2 (u / nkw), key tile u % nkw);
  // x's tile of unit u goes to buffer u % 2.
  const int units = (nh - half + 1) / 2 * nkw;
  const int lt = tid % 256;
  auto load_x = [&](int u) {
    const int j = half + 2 * (u / nkw), kt = u % nkw;
    const bf16* g = a.x + ((row0 + 64 * kt) * a.H + h0 + j) * P;
    bf16* dst = xb + (u % 2) * 64 * Lay::kXp;
    for (int idx = lt; idx < 64 * (P / 8); idx += 256) {
      const int r = idx / (P / 8), q = idx % (P / 8);
      cp_async16(dst + r * Lay::kXp + 8 * q,
                 g + static_cast<long long>(r) * a.H * P + 8 * q);
    }
  };
  if (units > 0) load_x(0);
  cp_commit();
  float acc[4][4 * PG];
  for (int u = 0; u < units; ++u) {
    const int j = half + 2 * (u / nkw), kt = u % nkw;
    if (u + 1 < units) load_x(u + 1);
    cp_commit();
    cp_wait_one();
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4 * PG; ++k) acc[i][k] = 0.f;
    }
    // Weights of rows 4 ty + i, keys 4 tx + k, key-major.
    const float* cj = cum + j * Q;
    const float* dj = dts + j * Q;
    const float* sct = sc_all + kt * 64 * kLdt;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = 64 * kt + 4 * tx + k;
      const float4 sv = *reinterpret_cast<const float4*>(
          sct + (4 * tx + k) * kLdt + 4 * ty);
      const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
      float w4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        w4[i] = s <= t ? s4[i] * expf(cj[t] - cj[s]) * dj[s] : 0.f;
      }
      *reinterpret_cast<float4*>(wt + (4 * tx + k) * kLdt + 4 * ty) =
          make_float4(w4[0], w4[1], w4[2], w4[3]);
    }
    named_sync(2 + half, 256);   // the weights and x's tile are in place
    const bf16* xt = xb + (u % 2) * 64 * Lay::kXp;
#pragma unroll 4
    for (int kk = 0; kk < 64; ++kk) {
      const float4 wv =
          *reinterpret_cast<const float4*>(wt + kk * kLdt + 4 * ty);
      const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int g = 0; g < PG; ++g) {
        const uint2 xv = *reinterpret_cast<const uint2*>(
            xt + kk * Lay::kXp + 64 * g + 4 * tx);
        const float2 x01 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.x));
        const float2 x23 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.y));
        const float x4[4] = {x01.x, x01.y, x23.x, x23.y};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[i][4 * g + k] = fmaf(w4[i], x4[k], acc[i][4 * g + k]);
      }
    }
    if (kt == nkw - 1) {
      const int h = h0 + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* yrow = a.y + ((row0 + t0 + 4 * ty + i) * a.H + h) * P;
#pragma unroll
        for (int g = 0; g < PG; ++g) {
          const int col = 64 * g + 4 * tx;
          if (col < P)
            *reinterpret_cast<float4*>(yrow + col) =
                make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                            acc[i][4 * g + 2], acc[i][4 * g + 3]);
        }
      }
    }
    named_sync(2 + half, 256);   // the weights and this buffer are read
  }
}

// The state kernel's shared memory: B's chunk, then for each of its two
// warpgroups x's keys of one step (up to 128 keys of one 64-column box of
// P) and their three parts, and its w; then cum and the offsets.
constexpr int kStepGroups = 2;            // 64-key groups a step
int state_smem(int nb, int Q, int slice) {
  const int groups = Q / 64;
  return groups * nb * kBox + 2 * 4 * kStepGroups * kBox +
         4 * (2 * Q + slice * Q + slice * (Q / kSeg)) + kAlign;
}

template <int NB>
__global__ void __launch_bounds__(256, 1)
    ssd_state_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap bmap,
                        const Args a, int b_head) {
  constexpr int NW = 64 * NB;      // wgmma's N: N rounded up to 64 or 128
  constexpr int kStep = kStepGroups * kBox;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bbar, xbar[2];
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~(kAlign - 1u);
  const int groups = a.Q / 64;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  // [B's chunk][warpgroup: x's step and its three parts]
  const uint32_t bq = base;
  const uint32_t xq = bq + groups * NB * kBox + wg * 4 * kStep;
  uint8_t* xgen = smem_raw + (xq - smem_u32(smem_raw));
  float* w = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                      groups * NB * kBox + 2 * 4 * kStep) +
             wg * a.Q;
  float* cum = w - wg * a.Q + 2 * a.Q;
  float* offs = cum + a.slice * a.Q;

  const int h0 = blockIdx.x * a.slice, nh = min(a.slice, a.H - h0);
  const int b = blockIdx.y / a.NC, c = blockIdx.y % a.NC;
  const int l0 = c * a.Q;
  const long long row0 = static_cast<long long>(b) * a.L + l0;
  const int pb = (a.P + 63) / 64, units = nh * pb;   // (head, box of P)
  const int nsteps = (groups + kStepGroups - 1) / kStepGroups;
  // Warpgroup wg runs units wg, wg + 2, ...; with an odd count its last
  // pass repeats unit units - 1 and stores nothing (a bound on wg would
  // put the products on a divergent path).
  const int passes = (units + 1) / 2;
  const uint32_t xb = smem_u32(&xbar[wg]);

  // x's keys of step `st` of pass `i` into the warpgroup's buffer.
  auto load_x = [&](int i, int st) {
    const int u = min(2 * i + wg, units - 1);
    const int kg0 = st * kStepGroups, ng = min(kStepGroups, groups - kg0);
    bar_expect(xb, ng * kBox);
    for (int g = 0; g < ng; ++g)
      tma_load4(xq + g * kBox, &xmap, xb, 64 * (u % pb), h0 + u / pb,
                l0 + 64 * (kg0 + g), b);
  };

  if (threadIdx.x == 0) {
    bar_init(smem_u32(&bbar), 1);
    bar_init(smem_u32(&xbar[0]), 1);
    bar_init(smem_u32(&xbar[1]), 1);
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_prefetch(&xmap);
    tma_prefetch(&bmap);
    bar_expect(smem_u32(&bbar), groups * NB * kBox);
    for (int kg = 0; kg < groups; ++kg)
      for (int box = 0; box < NB; ++box)
        tma_load4(bq + (kg * NB + box) * kBox, &bmap, smem_u32(&bbar),
                  64 * box, b_head ? h0 : 0, l0 + 64 * kg, b);
  }
  if (t == 0) load_x(0, 0);
  slice_cumsum<256>(cum, offs, a, row0, h0, nh, threadIdx.x);
  if (threadIdx.x < nh)
    a.total[(static_cast<long long>(b) * a.NC + c) * a.H + h0 +
            threadIdx.x] = cum[threadIdx.x * a.Q + a.Q - 1];
  bar_wait(smem_u32(&bbar), 0);

  const int r0 = 16 * (t / 32) + (t % 32) / 4;   // and r0 + 8
  const int c2 = 2 * (t % 4);
  int phase = 0;
  for (int i = 0; i < passes; ++i) {
    const int u = min(2 * i + wg, units - 1);
    const int j = u / pb, ph = u % pb, h = h0 + j;
    const float last = cum[j * a.Q + a.Q - 1];
    for (int s = t; s < a.Q; s += 128)
      w[s] = __expf(last - cum[j * a.Q + s]) * a.dt[(row0 + s) * a.H + h];
    float acc[NW / 2];
#pragma unroll
    for (int k = 0; k < NW / 2; ++k) acc[k] = 0.f;
    fence_regs(acc);
    for (int st = 0; st < nsteps; ++st) {
      named_sync(2 + wg, 128);   // w is written; the last products are done
      bar_wait(xb, phase);
      phase ^= 1;
      // (x w) as three bf16 parts, each 16-byte chunk where TMA put x's:
      // a chunk holds 8 columns of one key's row.
      const int kg0 = st * kStepGroups, ng = min(kStepGroups, groups - kg0);
      for (int v = t; v < ng * kBox / 16; v += 128) {
        const int key = 64 * kg0 + v / (kRowBytes / 16);
        const uint4 xv = *reinterpret_cast<const uint4*>(xgen + 16 * v);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ws = w[key];
        uint32_t part[3][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xw[q]));
          split3_bf16(f.x * ws, f.y * ws, part[0][q], part[1][q], part[2][q]);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint4*>(xgen + (k + 1) * kStep + 16 * v) =
              make_uint4(part[k][0], part[k][1], part[k][2], part[k][3]);
      }
      fence_async_smem();
      named_sync(2 + wg, 128);   // the parts are written, x is read
      if (t == 0) {
        if (st + 1 < nsteps) load_x(i, st + 1);
        else if (i + 1 < passes) load_x(i + 1, 0);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kStepGroups; ++kk) {
        if (kk < 4 * ng) {
          const uint64_t db = mnmajor(bq, NB, 0, 4 * kg0 + kk);
#pragma unroll
          for (int k = 1; k <= 3; ++k)
            mma_ss<NW, 1, 1>(acc, mnmajor(xq + k * kStep, 1, 0, kk), db);
        }
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (2 * i + wg < units) {
      float* out = a.contrib +
                   ((static_cast<long long>(b) * a.NC + c) * a.H + h) * a.P *
                       a.N;
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        const int p = 64 * ph + r0 + 8 * rs;
        if (p >= a.P) continue;
#pragma unroll
        for (int jj = 0; jj < NW / 8; ++jj) {
          const int n = 8 * jj + c2;
          if (n < a.N)
            *reinterpret_cast<float2*>(out + static_cast<long long>(p) * a.N +
                                       n) =
                make_float2(acc[4 * jj + 2 * rs], acc[4 * jj + 2 * rs + 1]);
        }
      }
    }
  }
}

// The rank-4 map of a (B, L, H, F) bf16 operand over (F, H, L, B) with
// element strides (sb, sl, sh), read in boxes of 64 columns by `rows`
// rows of L; a head stride of 0 is described as one head.
int map_blhf(CUtensorMap* map, const void* ptr, int B, int L, int H, int F,
             long long sb, long long sl, long long sh, int rows) {
  const long long dims[4] = {F, sh ? H : 1, L, B};
  const long long strides[3] = {(sh ? sh : sl) * 2, sl * 2, sb * 2};
  const int box[4] = {64, 1, rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <auto Kernel>
cudaError_t allow_smem(int smem) {
  static int configured = 48 * 1024;
  if (smem <= configured) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) configured = smem;
  return e;
}

template <int NB, int PG>
int launch(const CUtensorMap& xm, const CUtensorMap& bm, const Args& a,
           int B, int b_head, int state_slice, cudaStream_t stream) {
  const int s1 = intra_smem(a.N, PG, a.Q, a.slice);
  cudaError_t e = allow_smem<ssd_intra_shared_kernel<PG>>(s1);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g1(a.Q / 64, (a.H + a.slice - 1) / a.slice, B * a.NC);
  ssd_intra_shared_kernel<PG><<<g1, 512, s1, stream>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  Args as = a;
  as.slice = state_slice;
  const int s2 = state_smem(NB, a.Q, state_slice);
  e = allow_smem<ssd_state_tc_kernel<NB>>(s2);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 g2((a.H + state_slice - 1) / state_slice, B * a.NC);
  ssd_state_tc_kernel<NB><<<g2, 256, s2, stream>>>(xm, bm, as, b_head);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ssd_tc

// K8 in the tensor-core regime (bf16 x, B and C).  x is a packed
// (B, L, H, P); b and c have a packed feature axis and the given element
// strides (each pitch a multiple of 8 elements, the bases 16-byte aligned;
// a head stride of 0 shares one row across the heads); log_decay and dt
// are packed float32 (B, L, H).  P and N are multiples of 16 up to 128, Q
// a multiple of 64 up to 256, L % Q == 0; a slice of more than one head
// needs B's and C's head strides 0.  Outputs as ssd_chunk's.  One call
// launches the intra kernel and the state kernel.
extern "C" int ssd_chunk_tc(const void* x, const void* log_decay,
                            const void* dt, const void* b, const void* c,
                            void* y, void* contrib, void* total,
                            long long b_sb, long long b_sl, long long b_sh,
                            long long c_sb, long long c_sl, long long c_sh,
                            int B, int L, int H, int P, int N, int Q,
                            int intra_slice, int state_slice, int device,
                            void* stream) {
  // The tensors' card first: a host thread that has not used it has no
  // current context, and a launch there fails.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  using namespace ssd_tc;
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  const bool shared = b_sh == 0 && c_sh == 0;
  if (P <= 0 || P > 128 || P % 16 || N <= 0 || N > 128 || N % 16 ||
      Q <= 0 || Q > 256 || Q % 64 || L % Q || intra_slice < 1 ||
      intra_slice > kMaxSlice || state_slice < 1 ||
      state_slice > kMaxSlice ||
      (!shared && (intra_slice > 1 || state_slice > 1)) ||
      static_cast<long long>(B) * (L / Q) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, bm;
  int rc = map_blhf(&xm, x, B, L, H, P, static_cast<long long>(L) * H * P,
                    static_cast<long long>(H) * P, P, 64);
  if (rc == 0) rc = map_blhf(&bm, b, B, L, H, N, b_sb, b_sl, b_sh, 64);
  if (rc != 0) return rc;
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(b),
               static_cast<const bf16*>(c), b_sb, b_sl, b_sh, c_sb, c_sl,
               c_sh, static_cast<const float*>(log_decay),
               static_cast<const float*>(dt), static_cast<float*>(y),
               static_cast<float*>(contrib), static_cast<float*>(total),
               L, H, P, N, Q, L / Q, intra_slice};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = b_sh != 0;
  if (N <= 64 && P <= 64) return launch<1, 1>(xm, bm, a, B, bh, state_slice, s);
  if (N <= 64) return launch<1, 2>(xm, bm, a, B, bh, state_slice, s);
  if (P <= 64) return launch<2, 1>(xm, bm, a, B, bh, state_slice, s);
  return launch<2, 2>(xm, bm, a, B, bh, state_slice, s);
}

// A tensor-core launch's dynamic shared memory, to hold kernel.py's plan
// against: kernel 0 is the intra kernel, 1 the state kernel.
extern "C" long long ssd_tc_smem_bytes(int kernel, int P, int N, int Q,
                                       int slice) {
  using namespace ssd_tc;
  return kernel == 0 ? intra_smem(N, P <= 64 ? 1 : 2, Q, slice)
                     : state_smem(N <= 64 ? 1 : 2, Q, slice);
}
