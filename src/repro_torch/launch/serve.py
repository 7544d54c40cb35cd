"""Serving driver: a CloudPowerCap-managed fleet of replica hosts.

Each replica is a model instance on one host; the CloudPowerCap manager
owns the fleet's power budget, and the router follows the power-capped
capacities.  The driver routes the requests, decodes every replica's batch
(prefill on kernel K4, decode steps on K6; an MoE model's expert FFN on
K7; a Mamba2 or Zamba2 model's SSD scan on K8 at prefill, Zamba2's shared
attention on K4 and K6), then halves host ``h0``'s cap, runs one manager invocation
(BalancePowerCap on K2, its note on K3, the migration balancer's
entitlement waterfills on K1) and routes again.  The weights are random, from a seeded
``torch.Generator``.  As the reference's driver, it passes no frontend
inputs: a VLM (``internvl2_26b``) serves its text prompts alone, and an
encoder-decoder (``whisper_tiny``) raises ``ValueError`` for want of
frames (the reference's raises ``KeyError``; ROADMAP fault F4).  Serving
with a patch prefix or frames goes through
:func:`repro_torch.runtime.serve_loop.generate`'s ``extras``, with
:mod:`repro_torch.launch.inputs` for their shapes.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \
      --smoke --device cpu --requests 32 --decode-steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b \
      --smoke --device cpu --requests 32 --decode-steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \
      --smoke --device cpu --requests 32 --decode-steps 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \
      --smoke --device cpu --requests 32 --decode-steps 8

Without ``--device`` it runs on the GPU and raises where there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.backend import resolve_device
from repro_torch.core.manager import CloudPowerCapManager, ManagerConfig
from repro_torch.core.power_model import H100_HOST, HostPowerSpec
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.models import transformer as tfm
from repro_torch.runtime import tracing
from repro_torch.runtime.serve_loop import (CapacityAwareRouter, Replica,
                                            generate)


@dataclasses.dataclass
class ServeReport:
    """What one run of :func:`main` did."""

    routing: dict                 # replica -> requests, before the event
    caps: list                    # Watts per host, before the event
    routing_after: dict
    caps_after: list
    notes: list                   # the manager invocation's notes
    cap_changes: int
    migrations: int
    tokens: int                   # tokens decoded
    seconds: float                # host wall of the decoding, synced
    batches: dict                 # replica -> (prompts, tokens, logits)
    cfg: object
    params: dict


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--cap-frac", type=float, nargs="*", default=None,
                    help="initial per-replica cap fractions of peak")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap


def _count(assigned: list) -> dict:
    by_rep: dict[str, int] = {}
    for r in assigned:
        by_rep[r] = by_rep.get(r, 0) + 1
    return by_rep


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_fleet(host_spec: HostPowerSpec, n_replicas: int,
               cap_frac: Optional[list] = None):
    """``(snapshot, router)``: one host and one replica VM per replica,
    each VM demanding 80% of its host's peak capacity, the budget the sum
    of the initial caps (fractions ``cap_frac`` of peak, default all 1)."""
    fracs = cap_frac or [1.0] * n_replicas
    hosts = [Host(f"h{i}", host_spec,
                  power_cap=fracs[i % len(fracs)] * host_spec.power_peak)
             for i in range(n_replicas)]
    vms = [VirtualMachine(vm_id=f"rep{i}", host_id=f"h{i}",
                          demand=host_spec.capacity_peak * 0.8)
           for i in range(n_replicas)]
    snap = ClusterSnapshot(
        hosts, vms, power_budget=sum(h.power_cap for h in hosts))
    router = CapacityAwareRouter(
        [Replica(f"rep{i}", f"h{i}") for i in range(n_replicas)])
    router.sync_capacities(snap)
    return snap, router


def power_event(snap: ClusterSnapshot, router: CapacityAwareRouter,
                n_requests: int, device=None):
    """Halve host ``h0``'s cap, run one manager invocation on ``device``
    and route ``n_requests`` again; returns ``(routing, caps, result)``.
    Under a ``torch.profiler`` session it records the span
    ``repro_torch.power.event`` with the children ``.power.invocation``
    (the manager's, which returns its caps on the host) and
    ``.power.route`` (the router's sync and routing)."""
    with tracing.span("repro_torch.power.event"):
        snap.hosts["h0"].power_cap *= 0.5
        manager = CloudPowerCapManager(ManagerConfig(dpm_enabled=False),
                                       device=device)
        with tracing.span("repro_torch.power.invocation"):
            result = manager.run_invocation(snap)
        with tracing.span("repro_torch.power.route"):
            router.sync_capacities(result.snapshot)
            routing = _count(router.route(n_requests))
        caps = [round(h.power_cap) for h in result.snapshot.hosts.values()]
    return routing, caps, result


def main(argv: Optional[list] = None,
         host_spec: HostPowerSpec = H100_HOST) -> ServeReport:
    """Run the driver with ``argv`` (default: the command line);
    ``host_spec`` describes every replica host."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    snap, router = make_fleet(host_spec, args.replicas, args.cap_frac)

    routing = _count(router.route(args.requests))
    caps = [round(h.power_cap) for h in snap.hosts.values()]
    print(f"routing {args.requests} requests over {args.replicas} replicas "
          f"(caps {caps} W): {routing}", flush=True)

    # Serve each replica's batch; every replica gets the prompts of one
    # seed, as the reference draws them from one key.
    _sync(dev)
    t0 = time.perf_counter()
    total_tokens = 0
    batches = {}
    for rep_id, n in routing.items():
        prompts = torch.randint(
            0, cfg.vocab_size, (n, args.prompt_len),
            generator=torch.Generator(device=dev).manual_seed(1),
            device=dev)
        toks, logits = generate(cfg, params, prompts, args.decode_steps,
                                args.max_len)
        total_tokens += toks.numel()
        batches[rep_id] = (prompts, toks, logits)
        for _ in range(n):
            router.complete(rep_id)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"decoded {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.0f} tok/s on {dev.type})", flush=True)

    # Power event: rebalance caps, watch routing follow.
    routing_after, caps_after, result = power_event(snap, router,
                                                    args.requests, dev)
    print(f"after cap event (caps {caps_after} W): {routing_after}; "
          f"notes {result.notes}", flush=True)
    return ServeReport(routing=routing, caps=caps,
                       routing_after=routing_after, caps_after=caps_after,
                       notes=list(result.notes),
                       cap_changes=result.cap_changes,
                       migrations=result.migrations, tokens=total_tokens,
                       seconds=dt, batches=batches, cfg=cfg, params=params)


if __name__ == "__main__":
    main()
