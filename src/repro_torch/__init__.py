"""CloudPowerCap's cap-only batched sweep engine in PyTorch, for CUDA.

A port of the JAX package ``repro`` (which stays the reference): the same
module layout, plain functions on ``float64`` tensors, and hand-written
CUDA kernels for the two allocation hot spots (``kernels.powercap``).
Every entry point runs on the GPU unless it is given ``device="cpu"``, in
which case the kernels' plain PyTorch versions run instead.
"""
