"""The simulators (the vector engine and the batched grid engine) and the
scenario sweeps that drive them."""
