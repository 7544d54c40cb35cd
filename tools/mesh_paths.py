#!/usr/bin/env python3
"""``chip_smoke.py``'s device-mesh paths alone, on one GPU.

Builds the kernel libraries and runs paths SC (grids split over two
ranks sharing the card under gloo, and on one rank under nccl, bitwise
against one process), ME (one OLMoE-1B-7B MoE layer expert-parallel over
two ranks against the dense dispatch) and TE (MiniCPM-2B at full width
and 4 layers, data parallel over two pods, resized 2 -> 1 -> 2 by
checkpoint and restore), ST (granite-8b served tensor parallel over
two ranks), TT (granite-8b at 4 layers trained tensor parallel, then
ZeRO-3, over two ranks), SQ with SM (one spawn: MiniCPM-2B and
Granite-8B served with the sequence and the cache's positions split,
Mamba2-2.7B with its mixer's heads split and Zamba2-7B under
``long_500k``'s layout) and TS (MiniCPM-2B, InternVL2-26B and
Mamba2-2.7B trained under ``train_4k``'s layouts at 512 chips), each
through ``chip_smoke``'s own function with
the same gates; prints, beside the card's name and power limit, each
path's kernel records (``chip_smoke.mesh_path_records``: each kernel
against its plain version at the path's shapes, timed), its launches and
its record (walls, the collectives' seconds, resize seconds, errors) as
one JSON line, and the paths' wall.  Two ranks share
the card and gloo moves their tensors through host memory, so the
collectives' seconds are not an interconnect's.

    python3 tools/mesh_paths.py [SC ME TE ST TT SQ TS]   (default: all)
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("mesh_paths: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    def serving_2c():
        sq, sm, info = cs.run_part2c_serving_paths()
        return {"SQ": sq, "SM": sm}, info

    paths = {"SC": cs.run_sharded_sweep_path,
             "ME": cs.run_expert_parallel_path, "TE": cs.run_elastic_path,
             "ST": cs.run_split_serving_path,
             "TT": lambda: cs.run_split_training_path("TT"),
             "SQ": serving_2c,
             "TS": lambda: cs.run_split_training_path("TS")}
    tags = [a for a in argv if a in paths] or list(paths)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"build: {cs.build_all():.2f} s", flush=True)
    t_all = time.perf_counter()
    dev = torch.device("cuda")
    for tag in tags:
        records = cs.mesh_path_records(tag, dev)
        if tag == "SQ":
            records += cs.mesh_path_records("SM", dev)
        t0 = time.perf_counter()
        launches, info = paths[tag]()
        print(json.dumps({tag: dict(wall_s=time.perf_counter() - t0,
                                    launches=launches, info=info,
                                    kernels=records)}, default=str),
              flush=True)
    print(f"paths {' '.join(tags)}: {time.perf_counter() - t_all:.1f} s on "
          f"{smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
