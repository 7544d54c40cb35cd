"""CloudPowerCap's cap-only power path in PyTorch, for CUDA.

A port of the JAX package ``repro`` (which stays the reference): the same
module layout, plain functions on ``float64`` tensors, two engines (the
batched grid engine and the vector engine with its object-plane manager),
and hand-written CUDA kernels for the allocation hot spots
(``kernels.powercap``).  Every entry point runs on the GPU unless it is
given ``device="cpu"``, in which case the kernels' plain PyTorch versions
run instead.
"""
