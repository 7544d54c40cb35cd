"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: a
power-capped fleet of model replicas serving closed-loop traffic.

``run.py`` runs one cell once.  Everything that belongs to one
configuration, traffic mix, cell or per-layer metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model as published and as the port runs it;
- ``traffic/<mix>.json``: prompt lengths, outputs, replicas, the cap event;
- ``cells/<workload>.json``: requests a replica a round and the limits of
  the correctness check;
- ``metrics/<metric>.py``: one reader a per-layer metric.

``counts/`` holds the operations, bytes and model FLOPs worked out from
shapes and the published peaks; ``reference/`` the plain float32 model and
fleet that decide ``correct``.  Nothing here imports ``jax`` or the JAX
package ``repro``; ``reference/`` imports nothing of ``repro_torch``.
"""
