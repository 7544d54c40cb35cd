// K7's launchers, shared by the entry point (gmm.cu) and the tensor-core
// regimes (gmm_tc.cu).  Strides are in elements.  Of x's two inner axes
// (C, D) one is packed: D, or C where xt is set (x^T read in place); of
// w's (D, F), F, or D where wt is set.  out is packed.
#pragma once

#include <cuda_runtime.h>

namespace k7 {

// Regimes, as kernel.py's plan numbers them.
constexpr int kCudaCore = 0;
constexpr int kWide = 1;
constexpr int kNarrow = 2;

struct Args {
  const void* x;  // (E, C, D), strides (sxe, sxp, 1), or (sxe, 1, sxp) if xt
  const void* w;  // (E, D, F), strides (swe, swp, 1), or (swe, 1, swp) if wt
  void* out;      // (E, C, F), packed
  int E, C, D, F;
  long long sxe, sxp, swe, swp;   // expert strides and pitches
  int xt, wt;
};

// Dynamic shared memory of a tensor-core launch: the wide regime's, or
// the narrow regime's for a bucket of C rows.
long long wide_smem_bytes();
long long narrow_smem_bytes(int C);

int launch_wide(const Args& a, cudaStream_t stream);
int launch_narrow(const Args& a, cudaStream_t stream);

}  // namespace k7
