"""Runtime: the serving loop (prefill, decode steps) and the
capacity-aware request router; the training step; power-cap integration
(power-aware batch plans, straggler mitigation)."""
