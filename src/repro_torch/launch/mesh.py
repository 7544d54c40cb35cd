"""Device meshes over ``torch.distributed`` (the reference's
``repro.launch.mesh``) and the launcher that starts one process a rank.

Functions, not module-level constants: importing this module starts no
process and touches no device.

Single pod: 16 x 16 = 256 ranks over ``("data", "model")``.  Multi-pod:
2 x 16 x 16 = 512 ranks over ``("pod", "data", "model")``; the ``pod``
axis carries only data-parallel gradient reduction (optionally int8,
:func:`repro_torch.optim.compress.compressed_cross_pod_mean`).  Each
``make_*_mesh`` returns a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the current
process group and raises ``ValueError`` when the world size does not
fit it.  The reference's JAX-version shim (``AxisType``,
``make_mesh_compat``) has no twin: ``DeviceMesh`` takes axis names
directly and has no axis types.

**The backend and device rule** (one rule, no fallback).  Asked for the
CPU, every rank runs on the CPU under ``gloo``.  Asked for the card, rank
``r`` runs on ``cuda:{r % device_count}``: under ``nccl`` when each rank
owns its own card (world size at most the card count), under ``gloo``
when ranks share a card (NCCL refuses two ranks on one GPU).  A rank
asked for the card on a machine without one raises.

The collectives the port runs on these meshes, and the rank's device,
live in :mod:`repro_torch.runtime.sharding`, beside the sharding context
that the model and training code read: this module only builds meshes
and starts ranks.

:func:`spawn` starts the ranks with a ``spawn`` context, meets them
through a ``FileStore`` in a new temporary directory (no TCP port, so
concurrent test processes cannot collide), joins them under a timeout,
kills every rank when it runs out or when one rank fails, and raises the
failed rank's exception in the caller.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.runtime.sharding import _RANK_DEVICE, rank_device, world_size

def backend_for(device: str, world_size: int) -> str:
    """The backend the rule gives ``world_size`` ranks asked for
    ``device`` (``"cpu"`` or ``"cuda"``)."""
    if device == "cpu":
        return "gloo"
    if device != "cuda":
        raise ValueError(f"device {device!r}: use 'cuda' or 'cpu'")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("ranks asked for the card, and no CUDA device "
                           "is available: pass device='cpu'")
    return "nccl" if world_size <= n else "gloo"


def _mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks; every rank
    of the world calls it (a rank outside gets ``get_coordinate() ==
    None``)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: start the ranks "
                           "with repro_torch.launch.mesh.spawn")
    n, world = math.prod(shape), dist.get_world_size()
    if not 1 <= n <= world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks: outside "
                         f"[1, {world}] in the process group")
    return DeviceMesh(rank_device().type if _RANK_DEVICE else "cpu",
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if math.prod(shape) != world_size():
        raise ValueError(f"the production mesh {shape} needs exactly "
                         f"{math.prod(shape)} ranks, not {world_size()}")
    return _mesh(shape, axes)


def make_pod_mesh(n_pods: int) -> DeviceMesh:
    """Elastic-resize meshes: n_pods x 16 x 16 (``n_pods=1`` drops the
    axis), over the first ``n_pods * 256`` ranks."""
    if n_pods == 1:
        return _mesh((16, 16), ("data", "model"))
    return _mesh((n_pods, 16, 16), ("pod", "data", "model"))


def make_cells_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """The 1-D ``("cells",)`` mesh of the sharded sweep: the first
    ``n_devices`` ranks (``None``: every rank), coordinate ``r`` on
    world rank ``r``.  :class:`repro_torch.sim.batch.BatchedSimulator`
    splits the cells in this order by world rank and gathers over the
    world, so it needs no mesh object."""
    n = world_size() if n_devices is None else int(n_devices)
    return _mesh((n,), ("cells",))


def make_host_mesh(shape: Optional[Sequence[int]] = None,
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A small mesh over the first ``prod(shape)`` ranks (tests, examples,
    elastic meshes); ``shape=None`` puts every rank on the first axis."""
    if shape is None:
        shape = (world_size(),) + (1,) * (len(axes) - 1)
    return _mesh(shape, axes)


# ---------------------------------------------------------------- launcher
def _rank_main(r: int, world: int, device: str, backend: str,
               tmp: str, results) -> None:
    """A rank's process: join the group, run the call :func:`spawn` left
    in ``tmp``, report."""
    torch.set_num_threads(1)
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        if device == "cuda":
            dev = torch.device("cuda", r % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        _RANK_DEVICE[:] = [dev]
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=r, world_size=world)
        out = fn(*args)
        results.put((r, True, pickle.dumps(out)))
    except BaseException as exc:  # reported to the caller, which re-raises
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(repr(exc)))
        results.put((r, False, (payload, tb)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, device: str, *args,
          timeout_s: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` new ranks asked for ``device``
    (``"cuda"`` or ``"cpu"``; backend by the module's rule) and return
    each rank's result, in rank order.  ``fn`` and ``args`` must pickle
    (``fn`` by its module path); they reach the ranks through a file, so
    that no rank's start waits on another's reading its arguments.  A
    rank that raises, or dies, or a run longer than ``timeout_s`` kills
    every rank and raises in the caller: the rank's own exception, with
    its traceback added as a note."""
    backend = backend_for(device, world_size)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, device, backend, tmp, results))
             for r in range(world_size)]
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{fn.__name__} on {world_size} ranks ({backend}) "
                    f"did not finish in {timeout_s:.0f} s")
            try:
                r, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {fn.__name__} died with exit "
                        f"code {procs[dead[0]].exitcode}")
                continue
            if not ok:
                exc_bytes, tb = payload
                exc = pickle.loads(exc_bytes)
                exc.add_note(f"raised on rank {r} of {world_size} "
                             f"({backend}):\n{tb}")
                raise exc
            out[r] = pickle.loads(payload)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
