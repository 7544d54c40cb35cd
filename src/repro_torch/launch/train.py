"""Training driver: CloudPowerCap-managed multi-pod training (the
reference's ``repro.launch.train``).

The pods are CloudPowerCap hosts (``H100_HOST`` by default) with one job
shard VM each; their power caps become per-pod batch shares (a weight mask
over the fixed global batch).  Two events drive the power plane: a budget
cut (``--power-budget-drop-at``: 20% of the budget lost and pod0 capped
hard, then one manager invocation, BalancePowerCap on kernel K2 and its
note on K3, the migration balancer's waterfills on K1) and a straggler
(``--straggler-at``: pod1 reported 45% slow until the mitigator's patience
runs out, then BalancePowerCap toward it).  Every step runs the model's
forward attention on kernel K4 and its backward on K5.  The weights are
random, from a seeded ``torch.Generator``; a checkpoint is written at the
end, as the reference writes one.  As the reference's driver, its batches
carry no frontend inputs: a VLM trains on text alone, and an
encoder-decoder raises ``ValueError`` at its first step for want of
frames (the reference's raises ``KeyError``; ROADMAP fault F4).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b \
      --smoke --device cpu --steps 20 --power-budget-drop-at 5

Without ``--device`` it runs on the GPU and raises where there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.backend import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.power_model import H100_HOST, HostPowerSpec
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule
from repro_torch.runtime.power_integration import (PowerAwareBatchScheduler,
                                                   StragglerMitigator,
                                                   StragglerReport)
from repro_torch.runtime.train_loop import (TrainState, init_train_state,
                                            make_train_step)


@dataclasses.dataclass
class TrainReport:
    """What one run of :func:`main` did."""

    plans: list            # (step, examples per pod): the initial plan first
    caps: list             # (step, event, Watts per pod) after each event
    losses: list           # per step, float
    tokens: list           # per step, the weights' sum
    grad_norms: list       # per step
    seconds: float         # host wall of the steps, synced
    checkpoint_path: str
    checkpoint_s: float    # host wall of the final save
    cfg: object
    state: TrainState


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--initial-cap-frac", type=float, default=0.85,
                    help="initial per-pod cap as a fraction of peak "
                         "(leaves headroom for cap-first mitigation)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["cosine", "wsd"],
                    default="cosine")
    ap.add_argument("--power-budget-drop-at", type=int, default=-1,
                    help="step at which 20%% of the power budget is lost "
                         "(demonstrates cap redistribution -> batch replan)")
    ap.add_argument("--straggler-at", type=int, default=-1,
                    help="step at which pod1 starts running 45%% slow "
                         "(demonstrates cap-first straggler mitigation)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap


def build_power_plane(n_pods: int, host_spec: HostPowerSpec,
                      cap_watts: Optional[float] = None, device=None):
    """Pods as CloudPowerCap hosts; one job shard VM per pod demanding 90%
    of its host's peak capacity."""
    cap = cap_watts or host_spec.power_peak
    hosts = [Host(f"pod{i}", host_spec, power_cap=cap)
             for i in range(n_pods)]
    vms = [VirtualMachine(vm_id=f"shard{i}", host_id=f"pod{i}",
                          demand=host_spec.capacity_peak * 0.9,
                          mem_demand=1024.0)
           for i in range(n_pods)]
    snap = ClusterSnapshot(hosts, vms, power_budget=cap * n_pods)
    manager = CloudPowerCapManager(ManagerConfig(dpm_enabled=False), device)
    return snap, manager


def _caps(snap: ClusterSnapshot) -> list:
    return [round(h.power_cap) for h in snap.hosts.values()]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[list] = None,
         host_spec: HostPowerSpec = H100_HOST) -> TrainReport:
    """Run the driver with ``argv`` (default: the command line);
    ``host_spec`` describes every pod."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    sched = (wsd_schedule(args.lr, 10, int(args.steps * 0.7),
                          max(args.steps // 5, 1))
             if args.schedule == "wsd" or args.arch == "minicpm_2b"
             else cosine_schedule(args.lr, 10, args.steps))
    opt = AdamW(learning_rate=sched, state_dtype=cfg.optimizer_state_dtype)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                           global_batch=args.global_batch, device=dev)
    ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(
        prefix="repro_torch_ckpt_")
    ckpt = Checkpointer(ckpt_dir)
    state = init_train_state(cfg, opt,
                             torch.Generator(device=dev).manual_seed(0), dev)
    if args.resume and ckpt.latest_step() is not None:
        step0 = ckpt.latest_step()
        state = ckpt.restore(step0, state)
        data.load_state_dict(ckpt.metadata(step0)["data"])
        print(f"resumed from step {step0}")

    snap, manager = build_power_plane(
        args.pods, host_spec, args.initial_cap_frac * host_spec.power_peak,
        dev)
    scheduler = PowerAwareBatchScheduler(
        args.global_batch, [[f"pod{i}"] for i in range(args.pods)])
    mitigator = StragglerMitigator(device=dev)
    train_step = make_train_step(cfg, opt)

    plan = scheduler.plan(snap)
    plans = [(state.step, plan.examples_per_pod.tolist())]
    caps = []
    print(f"initial batch plan: {plan.examples_per_pod.tolist()} "
          f"(shares {np.round(plan.shares, 3).tolist()})", flush=True)

    metrics_log = []
    straggler_at = args.straggler_at
    _sync(dev)
    t0 = t_last = time.perf_counter()
    while state.step < args.steps:
        step = state.step
        if step == args.power_budget_drop_at:
            snap.power_budget *= 0.8
            snap.hosts["pod0"].power_cap *= 0.6  # operator caps pod0 hard
            snap = manager.run_invocation(snap).snapshot
            plan = scheduler.plan(snap)
            plans.append((step, plan.examples_per_pod.tolist()))
            caps.append((step, "budget cut", _caps(snap)))
            print(f"step {step}: budget cut; caps={_caps(snap)} "
                  f"-> plan {plan.examples_per_pod.tolist()}", flush=True)
        if straggler_at >= 0 and step >= straggler_at:
            # Simulated telemetry: pod1 persistently 45% slow.  Move Watts
            # first; re-plan the batch only if Watts run out.
            report = StragglerReport(step_times={
                h.host_id: (1.45 if h.host_id == "pod1" else 1.0)
                for h in snap.powered_on_hosts()})
            if mitigator.detect(report):
                balanced = mitigator.mitigate(snap.clone(), report)
                if balanced is not None:
                    snap = balanced
                    plan = scheduler.plan(snap)
                    print(f"step {step}: straggler pod1 -> caps "
                          f"{_caps(snap)} -> plan "
                          f"{plan.examples_per_pod.tolist()}", flush=True)
                else:
                    plan = scheduler.plan(snap)
                    print(f"step {step}: straggler pod1, caps exhausted -> "
                          f"batch replan {plan.examples_per_pod.tolist()}",
                          flush=True)
                plans.append((step, plan.examples_per_pod.tolist()))
                caps.append((step, "straggler", _caps(snap)))
                straggler_at = -1  # handled
        b = data.next_batch()
        batch = scheduler.apply(
            {"tokens": b.tokens, "labels": b.labels, "weights": b.weights},
            plan)
        state, metrics = train_step(state, batch)
        metrics_log.append(metrics)
        if step % 10 == 0:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"tokens {int(metrics['tokens'])} "
                  f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.1f}s)",
                  flush=True)
        if args.checkpoint_every and step and \
                step % args.checkpoint_every == 0:
            ckpt.save_async(step, state, {"data": data.state_dict()})
    _sync(dev)
    seconds = time.perf_counter() - t0
    t_save = time.perf_counter()
    path = ckpt.save(state.step, state, {"data": data.state_dict()})
    checkpoint_s = time.perf_counter() - t_save
    print(f"done at step {state.step}; checkpoints in {ckpt_dir}",
          flush=True)
    read = {k: [float(m[k]) for m in metrics_log]
            for k in ("loss", "tokens", "grad_norm")}
    return TrainReport(plans=plans, caps=caps, losses=read["loss"],
                       tokens=read["tokens"], grad_norms=read["grad_norm"],
                       seconds=seconds, checkpoint_path=path,
                       checkpoint_s=checkpoint_s, cfg=cfg, state=state)


if __name__ == "__main__":
    main()
