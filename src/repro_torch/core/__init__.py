"""CloudPowerCap's allocation math and protocol: the power model, the cap
kernels, and the manager with its redivvy and balance adapters."""
