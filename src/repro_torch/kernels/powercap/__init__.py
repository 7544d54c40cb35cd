"""The dense waterfill, BalancePowerCap and segmented waterfill kernels
(CUDA, sm_90a), with the CSR layout the segmented one reads
(``segments.py``)."""
