"""Carry scenarios built by the JAX reference over to the port.

For the power path the "weights" are the scenario state.  Two forms:

* the reference's ``BatchedSimulator`` packs its cells into a dict of NumPy
  arrays (``_arrays``) plus a static spec (``_static``) that shapes the
  program; :func:`from_reference_pack` builds the port's simulator over
  the very same bytes, in the cap-only or the churn regime, with or
  without a budget tree, placement rules, the migration balancer or timed
  vMotions;
* a reference ``ClusterSnapshot`` and its demand traces, the inputs of its
  ``VectorSimulator``; :func:`from_reference_snapshot` rebuilds them as the
  port's objects (a budget tree and placement rules too), and
  :func:`from_reference_config` its ``SimConfig`` (scripted power events
  and launch gates too).

For the serving path, :func:`from_reference_params` copies the model's
parameter tree, and for training :func:`from_reference_train_state` the
whole train state, either whole or as one rank's blocks of a split
layout.  They read attributes or arrays only and import nothing
of the reference, so both packages can run identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.budget_tree import BudgetTree
from repro_torch.core.kernels import (BalanceParams, DPMParams,
                                     MigrationLimits, MigrationParams,
                                     RulesMeta)
from repro_torch.core.power_model import HostPowerSpec
from repro_torch.drs import rules as rules_mod
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.sim.batch import BatchedSimulator, MigrationModel, Schedule
from repro_torch.sim.cluster import SimConfig
from repro_torch.sim.workloads import TraceSpec, spec_trace


def from_reference_pack(arrays: dict, static, device=None,
                        ) -> BatchedSimulator:
    """A port ``BatchedSimulator`` over a reference pack.

    ``arrays`` is the reference simulator's ``_arrays``; ``static`` its
    ``_static``, of which the fields ``tick_s``, ``waterfill_iters``,
    ``balance``, ``keep_timeseries``, ``n_tags``, ``churn``, ``dpm``,
    ``drs_period_s``, ``drs_first_at_s``, the power latencies and the
    migration layer's (``migration``, ``rules``, ``balancer``, ``timed``,
    ``mig_table``, ``limits``, the vMotion rate and overhead) are read.
    The churn pack's extra keys (``exists``, ``dpm``, ``bal_on``, ``vm``,
    ``migratable``, the ``ev_*`` events, the ``tree_*`` columns and the
    rule columns) come along.  Cells are named ``cell{i}`` and tags
    ``tag{g}`` in the reference's (sorted) tag order; a cell has a window
    when any tick falls inside it.
    """
    n_cells = arrays["on"].shape[0]
    migration = None
    if static.churn:
        on = bool(static.migration)
        migration = MigrationModel(
            rules=RulesMeta(*static.rules) if on else RulesMeta(),
            balancer=(MigrationParams(*static.balancer) if on
                      else MigrationParams(max_moves=0)),
            timed=bool(static.timed), mig_table=int(static.mig_table),
            limits=MigrationLimits(*static.limits),
            vmotion_rate_mb_s=static.vmotion_rate_mb_s,
            vmotion_overhead_mhz=static.vmotion_overhead_mhz)
    return BatchedSimulator.from_pack(
        arrays, names=[f"cell{i}" for i in range(n_cells)],
        tag_names=[f"tag{g}" for g in range(static.n_tags)],
        has_window=np.asarray(arrays["win_mask"]).any(axis=0),
        tick_s=static.tick_s,
        balance=BalanceParams(**static.balance._asdict()),
        waterfill_iters=static.waterfill_iters,
        keep_timeseries=static.keep_timeseries, device=device,
        migration=migration, dpm=DPMParams(**static.dpm._asdict()),
        schedule=Schedule(static.drs_period_s, static.drs_first_at_s,
                          static.power_on_latency_s,
                          static.power_off_latency_s))


def _fields(obj, cls) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def from_reference_snapshot(snapshot, traces: dict
                            ) -> tuple[ClusterSnapshot, dict]:
    """The port's ``(ClusterSnapshot, traces)`` for a reference snapshot and
    its traces.

    Hosts, host specs and VMs are copied field by field, placement rules as
    the port's rules of the same class and fields
    (:mod:`repro_torch.drs.rules`), and a budget tree as the port's
    :class:`~repro_torch.core.budget_tree.BudgetTree` of the same parents,
    limits and host nodes.  A trace with a declarative ``.spec`` becomes
    the port's :func:`~repro_torch.sim.workloads.spec_trace` of the same
    segments and period, which is what the vector engines evaluate; a
    trace without one is carried as the callable it is.  The scripted
    ``power_events`` live in the ``SimConfig``, which the caller builds.
    """
    hosts = [Host(**dict(_fields(h, Host),
                         spec=HostPowerSpec(**_fields(h.spec, HostPowerSpec))))
             for h in snapshot.hosts.values()]
    vms = [VirtualMachine(**_fields(v, VirtualMachine))
           for v in snapshot.vms.values()]
    tree = getattr(snapshot, "budget_tree", None)
    if tree is not None:
        tree = BudgetTree(tree.parent, tree.limit, tree.host_node)
    rules = [getattr(rules_mod, type(r).__name__)(**_fields(
        r, getattr(rules_mod, type(r).__name__))) for r in snapshot.rules]
    snap = ClusterSnapshot(hosts, vms, power_budget=snapshot.power_budget,
                           rules=rules, budget_tree=tree)
    out = {}
    for vm_id, trace in traces.items():
        spec = getattr(trace, "spec", None)
        out[vm_id] = trace if spec is None else spec_trace(TraceSpec(
            segments=tuple(tuple(seg) for seg in spec.segments),
            period=spec.period))
    return snap, out


def from_reference_config(config) -> SimConfig:
    """The port's ``SimConfig`` with the reference config's fields (its
    time grid, latencies, migration model and ``power_events``)."""
    return SimConfig(**_fields(config, SimConfig))


def _param_tensor(a, dtype, dev) -> torch.Tensor:
    """One reference parameter (a NumPy array; bfloat16 as ``ml_dtypes``'
    type) as a tensor of ``dtype`` (``None``: its own), bit for bit (a
    copy: arrays that JAX hands out are read-only)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"parameter of {t.dtype}, the config says {dtype}")
    return t.to(dev)


def from_reference_params(params, cfg, device=None, mesh=None,
                          rules=None) -> dict:
    """The reference's parameter tree (nested mappings of NumPy arrays, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives them) as the
    port's, in the same layout and dtype, on ``device`` (``None``: the
    GPU).  Every leaf of :func:`repro_torch.models.transformer.
    param_specs` must be there, with its shape, and nothing else.  With
    ``mesh`` and ``rules``, each leaf is this rank's block
    (:func:`repro_torch.launch.shardspecs.local_params`)."""
    if mesh is not None:
        from repro_torch.launch.shardspecs import local_params
        return local_params(from_reference_params(params, cfg, device),
                            cfg, mesh, rules)
    from repro_torch.models.transformer import param_specs

    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def walk(specs, node, path):
        if set(node) != set(specs):
            raise ValueError(f"{'/'.join(path) or 'params'}: keys "
                             f"{sorted(node)}, expected {sorted(specs)}")
        out = {}
        for name, spec in specs.items():
            if isinstance(spec, dict):
                out[name] = walk(spec, node[name], path + (name,))
                continue
            t = _param_tensor(node[name], dtype, dev)
            if tuple(t.shape) != tuple(spec[0]):
                raise ValueError(f"{'/'.join(path + (name,))}: shape "
                                 f"{tuple(t.shape)}, expected {spec[0]}")
            out[name] = t
        return out

    return walk(param_specs(cfg), params, ())


def from_reference_train_state(state, cfg, device=None, mesh=None,
                               rules=None):
    """The reference's ``TrainState`` (params, AdamW's ``m``, ``v`` and
    ``count``, ``step`` and the compression residual when there is one),
    its leaves as NumPy arrays (``jax.tree_util.tree_map(np.asarray,
    state)``), as the port's on ``device`` (``None``: the GPU).  The
    parameters require grad; the moments keep their dtype (bfloat16 bit
    for bit through an int16 view); ``count`` stays an int32 tensor and
    ``step`` becomes a host ``int``.  With ``mesh`` and ``rules``, each
    leaf is this rank's block
    (:func:`repro_torch.launch.shardspecs.local_train_state`)."""
    if mesh is not None:
        from repro_torch.launch.shardspecs import local_train_state
        return local_train_state(from_reference_train_state(state, cfg,
                                                            device),
                                 cfg, mesh, rules)
    from repro_torch.optim.adamw import OptState
    from repro_torch.runtime.train_loop import TrainState
    from repro_torch.tree import leaves, map_tree

    dev = resolve_device(device)
    params = from_reference_params(state.params, cfg, dev)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = state.opt_state

    def like(tree):
        """A tree of ``params``' structure, each leaf in its own dtype."""
        return map_tree(lambda p, a: _param_tensor(a, None, dev), params,
                        tree)

    residual = state.compress_residual
    return TrainState(
        params=params,
        opt_state=OptState(m=like(opt.m), v=like(opt.v),
                           count=torch.as_tensor(np.array(opt.count),
                                                 dtype=torch.int32,
                                                 device=dev)),
        step=int(np.asarray(state.step)),
        compress_residual=None if residual is None else like(residual))
