#!/usr/bin/env python3
"""Read one GPU's name, power limit and idle power draw with nvidia-smi.

Samples ``power.draw`` every half second while nothing runs on the card and
prints one JSON line with the name, the limit, every sample and their
median: the figures behind ``repro_torch.core.power_model.H100_HOST``.
Run it first in a fresh process, before anything touches the card.

    python3 tools/h100_power.py [SAMPLES]
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def query(fields: str) -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [f.strip() for f in out.strip().splitlines()[0].split(",")]


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    name, limit = query("name,power.limit")
    draws = []
    for _ in range(n):
        draws.append(float(query("power.draw")[0].split()[0]))
        time.sleep(0.5)
    print(json.dumps({"name": name, "power_limit": limit,
                      "idle_draw_w": draws,
                      "idle_draw_median_w": statistics.median(draws)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
