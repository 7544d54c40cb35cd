"""The plain reference against the port at the port's CPU-sized widths,
in float32: the test imports both; the reference imports nothing of the
port."""

import dataclasses
import random

import smoke_root  # noqa: F401  (the import path)
import numpy as np
import pytest
import torch

from cpcbench import gen
from cpcbench.reference import fleet, model
from cpcbench.weights import make_weights
from repro_torch import configs
from repro_torch.core.power_model import HostPowerSpec
from repro_torch.drs.snapshot import ClusterSnapshot, Host, VirtualMachine
from repro_torch.models import moe as port_moe
from repro_torch.models import transformer as tfm
from repro_torch.runtime.serve_loop import (CapacityAwareRouter, Replica,
                                            generate)

HOST = {"capacity_peak": 989e12, "power_idle_w": 74.95, "power_peak_w": 700.0,
        "memory_mb": 81920, "vm_demand_fraction": 0.8}
SPEC = HostPowerSpec(capacity_peak=989e12, power_idle=74.95, power_peak=700.0)


def run_as(arch: str, **changes) -> dict:
    cfg = dataclasses.replace(configs.get_smoke(arch), **changes)
    return {k: getattr(cfg, k) for k in (
        "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
        "d_ff", "vocab_size", "norm_eps", "rope_theta", "tie_embeddings",
        "n_experts", "moe_top_k", "moe_capacity_factor")}


@pytest.mark.parametrize("arch, changes", [
    ("granite_8b", {}), ("olmoe_1b_7b", {}),
    ("granite_8b", {"rope_theta": 1e7, "tie_embeddings": True})])
def test_reference_follows_generate(arch, changes):
    """Teacher forced on the port's greedy tokens, the reference gives the
    logits ``generate`` returned (prefill and decode steps), routing the
    prompt as one group and each decode position as one; with the head
    tied to the embedding too."""
    cfg = dataclasses.replace(configs.get_smoke(arch), **changes)
    params = make_weights(tfm.param_specs(cfg), 11, torch.float32, "cpu")
    assert ("unembed" in params) != cfg.tie_embeddings
    n, s, steps = 5, 13, 6
    prompt = gen.prompts(11, 0, 0, n, s, cfg.vocab_size, "cpu")
    tokens, logits = generate(cfg, params, prompt, steps, s + steps)
    seq = torch.cat([prompt, tokens[:, :-1]], 1)
    ref = model.logits(params, run_as(arch, **changes), seq, s, steps)
    assert torch.allclose(ref, logits, rtol=1e-4, atol=1e-4)
    assert torch.equal(ref.argmax(-1), tokens)


@pytest.mark.parametrize("factor", [1.25, 0.3])
def test_moe_drops_as_the_port(factor):
    """Pairs past an expert's capacity are dropped as the port drops them
    (0.3 drops many)."""
    cfg = dataclasses.replace(configs.get_smoke("olmoe_1b_7b"),
                              moe_capacity_factor=factor)
    m = dict(run_as("olmoe_1b_7b"), moe_capacity_factor=factor)
    g = torch.Generator().manual_seed(3)
    blk = {k: torch.randn(shape[1:], generator=g) / shape[-2] ** 0.5
           for k, shape in ((k, v[0]) for k, v in
                            tfm._stack(port_moe.moe_param_specs(cfg),
                                       1).items())}
    x = torch.randn(3, 10, cfg.d_model, generator=g)
    want, _ = port_moe.moe_ffn(blk, x, cfg)
    got = model.moe(x, blk, m, [(0, 10)], fp8=False)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    _, _, keep = model.route(x.reshape(30, -1), blk["router"], m, False)
    assert bool(keep.all()) == (factor == 1.25)


def test_capacity_is_the_ports():
    cfg = configs.get("olmoe_1b_7b")
    m = {"moe_top_k": 8, "moe_capacity_factor": 1.25, "n_experts": 64}
    for t in (1, 7, 32, 36, 2176 * 32, 3968 * 36):
        assert model.capacity(t, m) == port_moe.expert_capacity(t, cfg)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q = model.to_fp8(x)
    scale = x.abs().max() / model.F8_MAX
    assert torch.equal(model.to_fp8(q), q)
    big = x.abs() > 64 * scale          # normal range, 2^-4 relative
    assert ((q - x).abs()[big] <= x.abs()[big] * 2 ** -4).all()
    assert not torch.equal(q, x)


@pytest.mark.parametrize("caps", [[700.0, 700.0], [350.0, 700.0],
                                  [466.3, 583.7], [74.95, 120.0]])
def test_fleet_capacity_and_imbalance_are_the_ports(caps):
    hosts = [Host(f"h{i}", SPEC, power_cap=c) for i, c in enumerate(caps)]
    vms = [VirtualMachine(vm_id=f"rep{i}", host_id=f"h{i}",
                          demand=SPEC.capacity_peak * 0.8)
           for i in range(len(caps))]
    snap = ClusterSnapshot(hosts, vms, power_budget=sum(caps))
    for h, c in zip(hosts, caps):
        assert fleet.managed_capacity(c, HOST) == h.managed_capacity
    assert fleet.imbalance(caps, HOST) == pytest.approx(
        snap.imbalance("cpu"), abs=1e-12)


def test_route_is_the_routers():
    rng = random.Random(5)
    for _ in range(50):
        caps = [rng.choice([0.0, 1.0, rng.uniform(0.1, 2.0)])
                for _ in range(rng.randint(1, 4))]
        if not any(caps):
            continue
        router = CapacityAwareRouter([Replica(f"r{i}", f"h{i}")
                                      for i in range(len(caps))])
        router.capacity = {f"r{i}": c for i, c in enumerate(caps)}
        n = rng.randint(1, 80)
        got = router.route(n)
        assert fleet.route(caps, n) == [got.count(f"r{i}")
                                        for i in range(len(caps))]


def test_imbalance_of_equal_entitlements_is_zero():
    assert fleet.imbalance([700.0, 700.0], HOST) == 0.0
    assert np.isclose(fleet.imbalance([350.0, 700.0], HOST), 0.1)
