#!/usr/bin/env python3
"""``chip_smoke.py``'s serving paths alone, on one GPU.

Builds the kernel libraries and runs paths S (granite-8b), M
(OLMoE-1B-7B), P (Mamba2-2.7B), H (Zamba2-7B), Y (Whisper-tiny over 1,500
frames) and I (InternVL2-26B with a 256-patch prefix), each through
``chip_smoke``'s own function with the same gates (exact launch counts,
the cap event against its CPU run, teacher-forced logits against the
plain versions) and its graph phase (``chip_smoke.check_decode_graph``:
``generate``'s replayed decode steps bitwise equal to the eager ones, the
capture's, instantiation's and a replayed step's ms beside the eager
step's); prints, beside the card's name and power limit, each path's
launches and record as one JSON line, and the paths' wall.

    python3 tools/serve_paths.py [S M P H Y I]   (default: all)
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
        print("serve_paths: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda")
    paths = {"S": lambda: cs.run_serving_path(dev),
             "M": lambda: cs.run_moe_serving_path(dev),
             "P": lambda: cs.run_ssm_serving_path("P", dev),
             "H": lambda: cs.run_ssm_serving_path("H", dev),
             "Y": lambda: cs.run_encdec_serving_path(dev),
             "I": lambda: cs.run_vlm_serving_path(dev)}
    tags = [a for a in argv if a in paths] or list(paths)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"build: {cs.build_all():.2f} s", flush=True)
    t_all = time.perf_counter()
    for tag in tags:
        t0 = time.perf_counter()
        launches, info = paths[tag]()
        print(json.dumps({tag: dict(wall_s=time.perf_counter() - t0,
                                    launches=launches, info=info)},
                         default=str), flush=True)
        torch.cuda.empty_cache()
    print(f"paths {' '.join(tags)}: {time.perf_counter() - t_all:.1f} s on "
          f"{smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
