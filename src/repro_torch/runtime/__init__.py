"""Runtime: the serving loop (prefill, decode steps) and the
capacity-aware request router."""
