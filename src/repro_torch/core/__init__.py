"""CloudPowerCap's allocation math: the power model and the cap kernels."""
