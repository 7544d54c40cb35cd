"""The dense waterfill and BalancePowerCap kernels (CUDA, sm_90a)."""
