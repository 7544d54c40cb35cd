// K7's launchers, shared by the entry point (gmm.cu) and the tensor-core
// regimes (gmm_tc.cu).  Strides are in elements; every tensor's last
// dimension is contiguous.
#pragma once

#include <cuda_runtime.h>

namespace k7 {

// Regimes, as kernel.py's plan numbers them.
constexpr int kCudaCore = 0;
constexpr int kWide = 1;
constexpr int kNarrow = 2;

struct Args {
  const void* x;  // (E, C, D), strides (sxe, sxc, 1)
  const void* w;  // (E, D, F), strides (swe, swd, 1)
  void* out;      // (E, C, F), packed
  int E, C, D, F;
  long long sxe, sxc, swe, swd;
};

// Dynamic shared memory of a tensor-core launch: the wide regime's, or
// the narrow regime's for a bucket of C rows.
long long wide_smem_bytes();
long long narrow_smem_bytes(int C);

int launch_wide(const Args& a, cudaStream_t stream);
int launch_narrow(const Args& a, cudaStream_t stream);

}  // namespace k7
