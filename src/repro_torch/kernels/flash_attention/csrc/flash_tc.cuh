// What K4's and K5's tensor-core kernels (flash_fwd_tc.cu, flash_bwd_tc.cu)
// share: the tile geometry, the rank-4 tensor maps and the launch checks.
//
// Every bf16 operand is a (B, S, H, D) tensor whose D axis is contiguous;
// its other three strides are its own (a view into a longer cache, or a
// head stride past D, needs no copy).  It is described to TMA as a rank-4
// map over (D, H, S, B) and read in boxes of 64 columns of D by 64 or 128
// rows of S, one head and one batch row: 128 bytes a row, written with the
// 128-byte swizzle into shared memory aligned to 1024 bytes (sm90.cuh).
// A tile of R rows and DP columns (DP = 64, or 128 for D of 112 and 128)
// is DP / 64 such boxes, box c holding columns 64 c .. 64 c + 63; at D 112
// the second box's columns 112-127 arrive as TMA's zeros, add nothing to
// any product, and are never stored.  Rows past S arrive as zeros too and
// are masked wherever they could reach a sum.
//
// A tile is read by wgmma in one of two ways (sm90.cuh):
//  * K-major, the contraction over D (S = Q K^T and its kin): a k-step of
//    16 columns is box kk / 4 at byte 32 (kk % 4) of its rows, 8-row
//    groups 1,024 bytes apart;
//  * MN-major, the contraction over the tile's rows (P V, dS K, P^T dO,
//    dS^T Q): a k-step of 16 rows starts 2,048 bytes further, 8-row groups
//    1,024 bytes apart, and the 64-column atoms of D lie one 64-row box,
//    8,192 bytes, apart -- the strides K7 holds on the card.  So every
//    tile read MN-major is laid out as 64-row boxes, [64-row half][box c].
#pragma once

#include "sm90.cuh"

namespace fa_tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kRowBytes = 128;             // a box row: 64 bf16
constexpr int kBox = 64 * kRowBytes;       // a 64-row box, 8,192 bytes
constexpr int kAlign = 1024;               // swizzle atom alignment
constexpr int kThreads = 384;              // two consumer warpgroups and
                                           // a producer warpgroup (the dq
                                           // kernel sets its own count)
constexpr uint32_t kKLbo = 16, kKSbo = 1024;
constexpr uint32_t kMnLbo = kBox, kMnSbo = 1024;
constexpr float kNegInf = -1e30f;          // masked scores, as the reference
constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx, flushing subnormal results to zero: 2^-22 relative).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K-major descriptor of k-step kk of a tile of `rows` rows (boxes of that
// many rows, one after another), starting `row` rows in.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row,
                                           int kk) {
  return desc(tile + (kk / 4) * rows * kRowBytes + row * kRowBytes +
                  (kk % 4) * 32,
              kKLbo, kKSbo);
}

// MN-major descriptor of k-step kk (rows 16 kk .. 16 kk + 15) of a tile
// laid out as [64-row half][box c] with `nb` boxes a half.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int nb, int kk) {
  return desc(tile + (kk / 4) * nb * kBox + (kk % 4) * 2048, kMnLbo,
              kMnSbo);
}

// The mma_rs_* A operand of k-steps 0 .. DP / 16 - 1 (over D) of the
// warpgroup's 64 rows from `row` on of a tile of `rows` rows, read from
// its swizzled boxes: the 16-byte chunk j of row r lies at chunk j ^ (r % 8)
// (the layout TMA writes with the 128-byte swizzle).
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[DP / 16][4],
                                       uint32_t tile, int rows, int row) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = row + 16 * (t / 32) + lane / 4;       // and r + 8
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t box = tile + (kk / 4) * rows * kRowBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + 8 * (i % 2), chunk = 2 * (kk % 4) + i / 2;
      a[kk][i] = ld_shared(box + rr * kRowBytes + ((chunk ^ (rr % 8)) * 16) +
                           (lane % 4) * 4);
    }
  }
}

// One (B, S, H, D) bf16 operand: its base and element strides.
struct Operand {
  const void* ptr;
  long long sb, ss, sh;
};

// The rank-4 map of `t` over (D, H, S, B), read in 64 x `rows` boxes.
inline int map_bshd(CUtensorMap* map, const Operand& t, int B, int S, int H,
                    int D, int rows) {
  const long long dims[4] = {D, H, S, B};
  const long long strides[3] = {t.sh * 2, t.ss * 2, t.sb * 2};
  const int box[4] = {64, 1, rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, t.ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Once for each kernel: allow its dynamic shared memory past 48 KB.
template <auto Kernel>
cudaError_t allow_smem(int smem) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return attr;
}

// Dynamic shared memory of a launch: kernel 0 is K4's, 1 K5's dk/dv
// kernel, 2 its dq kernel; dp is 64 or 128.
int fwd_smem_bytes(int dp);
int dkdv_smem_bytes(int dp);
int dq_smem_bytes(int dp);

}  // namespace fa_tc
