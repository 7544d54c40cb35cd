"""A checkout in a temporary directory whose cells run the port's
CPU-sized models: ``BENCHMARK.json`` and data files of their own, and the
per-layer readers copied from this checkout.  Each smoke cell's file is
the committed cell's of its model, limits and checked rows with it, with
fewer requests.  Importing it puts the checkout and its ``src/`` on the
import path."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SMOKE = {
    "granite_smoke": ("granite_8b.long_prompt", {
        "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
        "norm_eps": 1e-05, "rope_theta": 10000.0, "param_dtype": "float32"}),
    "olmoe_smoke": ("olmoe_1b_7b.long_prompt", {
        "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
        "norm_eps": 1e-05, "rope_theta": 10000.0, "n_experts": 8,
        "moe_top_k": 2, "moe_capacity_factor": 1.25,
        "param_dtype": "float32"}),
}

MIX = {
    "prompt_lengths": [8, 12, 16, 20], "output_tokens": 3, "replicas": 2,
    "cap_event": {"at_fraction": 0.5, "host": "h0", "cap_factor": 0.5},
    "host": {"capacity_peak": 989e12, "power_idle_w": 74.95,
             "power_peak_w": 700.0, "memory_mb": 81920,
             "vm_demand_fraction": 0.8},
    "limits": {"routing_mismatch": 0, "cap_sum_err_w": 1e-6,
               "cap_imbalance": 0.01, "cap_range_violations": 0},
}


def make_root(tmp: Path, requests: int = 8) -> Path:
    """A checkout at ``tmp`` with cells ``granite_smoke.tiny`` and
    ``olmoe_smoke.tiny``; returns ``tmp``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = tmp / "cpcbench"
    for sub in ("configs", "traffic", "cells"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", base / "metrics", dirs_exist_ok=True)
    configs, workloads = [], []
    for name, (committed, run_as) in SMOKE.items():
        arch = committed.split(".")[0]
        path = base / "configs" / f"{name}.json"
        path.write_text(json.dumps({"arch": arch, "variant": "smoke",
                                    "run_as": run_as, "reduced": []}))
        configs.append({"name": name, "source": "smoke", "reduced": [],
                        "file": f"cpcbench/configs/{name}.json",
                        "why": "CPU-sized"})
        cell = f"{name}.tiny"
        workloads.append({"name": cell, "config": name, "traffic": "tiny",
                          "chips": 1, "why": "CPU-sized"})
        own = json.loads((HERE / "cells" / f"{committed}.json").read_text())
        (base / "cells" / f"{cell}.json").write_text(json.dumps(
            dict(own, requests_per_replica=requests)))
    (base / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    per_layer = [dict(m, workloads=[w["name"] for w in workloads])
                 if "workloads" in m else m for m in bench["per_layer"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(dict(
        bench, configs=configs, workloads=workloads, per_layer=per_layer)))
    return tmp
