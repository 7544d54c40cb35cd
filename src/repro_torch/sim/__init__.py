"""Scenario sweeps and the batched (grid-at-a-time) simulator."""
