"""The port's serving path against the JAX reference's, on the CPU.

The reference's parameters (``init_params(PRNGKey(0), granite_8b.smoke())``)
are carried across with ``convert.from_reference_params``; the same
prompts, drawn with NumPy, go through both packages' ``decoder_forward``
and ``greedy_generate`` (the port's on the plain versions of kernels K4 and
K6).  Float32: hidden states within 1e-5, greedy tokens identical and
logits within 1e-4.  Bfloat16: logits within the reference's bfloat16
tolerance (2e-2) with the reference's own tokens fed back to both; token
identity is reported, not required.  Then ``launch.serve``'s driver with
the reference's host spec carried across: the routing before and after
its cap event, the caps and the manager's note must equal the
reference's, and the migration balancer must make the reference's moves
(none after the cap event).
"""

import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.manager import CloudPowerCapManager as RefManager
from repro.core.manager import ManagerConfig as RefManagerConfig
from repro.core.power_model import PAPER_HOST as REF_PAPER_HOST
from repro.core.power_model import TPU_V5E_HOST
from repro.drs import balancer as ref_balancer
from repro.drs import snapshot as ref_snapshot
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tfm
from repro.runtime import serve_loop as ref_loop
from repro_torch import configs
from repro_torch.convert import from_reference_params
from repro_torch.core.power_model import PAPER_HOST, HostPowerSpec
from repro_torch.drs import balancer
from repro_torch.drs import snapshot
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.runtime import serve_loop

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _spec(ref_spec) -> HostPowerSpec:
    """A reference host spec carried across field by field."""
    return HostPowerSpec(**{f.name: getattr(ref_spec, f.name)
                            for f in dataclasses.fields(HostPowerSpec)})


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, port cfg) at the smoke size."""
    rcfg = ref_configs.get_smoke("granite_8b")
    return rcfg, ref_tfm.init_params(jax.random.PRNGKey(0), rcfg), \
        configs.get_smoke("granite_8b")


def _port_params(rparams, cfg):
    return from_reference_params(jax.tree_util.tree_map(np.asarray, rparams),
                                 cfg, device="cpu")


def _ref_generate(rcfg, rparams, prompt, steps, max_len, forced=None):
    """The reference's ``greedy_generate``, keeping the logits; with
    ``forced``, step ``i + 1`` is fed ``forced[:, i]``."""
    prefill = ref_loop.make_prefill_step(rcfg, max_len)
    decode = jax.jit(ref_loop.make_decode_step(rcfg))
    logits, state = prefill(rparams, jnp.asarray(prompt))
    out, seen = [jnp.argmax(logits, -1)], [logits]
    for i in range(steps - 1):
        fed = out[-1] if forced is None else jnp.asarray(forced[:, i])
        logits, state = decode(rparams, state, fed)
        out.append(jnp.argmax(logits, -1))
        seen.append(logits)
    return np.asarray(jnp.stack(out, 1)), np.asarray(jnp.stack(seen, 1),
                                                     np.float32)


def test_convert_carries_every_parameter_bit_for_bit(smoke):
    rcfg, rparams, cfg = smoke
    params = _port_params(rparams, cfg)
    flat = jax.tree_util.tree_leaves_with_path(rparams)
    assert len(flat) == len(jax.tree_util.tree_leaves(
        tfm.param_specs(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    for path, leaf in flat:
        t = params
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.float32
        assert np.array_equal(t.numpy(), np.asarray(leaf))
    with pytest.raises(ValueError, match="keys"):
        from_reference_params({"embed": {}}, cfg, device="cpu")


def test_decoder_forward_matches_reference(smoke):
    rcfg, rparams, cfg = smoke
    params = _port_params(rparams, cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    ref = ref_tfm.decoder_forward(rparams, jnp.asarray(tokens), rcfg)
    res = tfm.decoder_forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(res.hidden.numpy(), np.asarray(ref.hidden),
                               rtol=1e-5, atol=1e-5)
    module = tfm.DecoderLM(cfg, params)
    assert torch.equal(module(torch.from_numpy(tokens)).hidden, res.hidden)


@pytest.mark.parametrize("prompt_len", [8, 24])
def test_greedy_generate_matches_reference(smoke, prompt_len):
    """Prompt 8 takes the reference's one-block attention branch in
    prefill, 24 its scan over blocks; the port runs K4's plain version for
    both and K6's for every decode step."""
    rcfg, rparams, cfg = smoke
    params = _port_params(rparams, cfg)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (3, prompt_len))
    steps, max_len = 6, 48
    ref_tokens = np.asarray(ref_loop.greedy_generate(
        rcfg, rparams, jnp.asarray(prompt), steps=steps, max_len=max_len))
    want_tokens, want_logits = _ref_generate(rcfg, rparams, prompt, steps,
                                             max_len)
    assert np.array_equal(ref_tokens, want_tokens)
    tokens = serve_loop.greedy_generate(cfg, params, prompt, steps, max_len,
                                        device="cpu")
    assert np.array_equal(tokens.numpy(), ref_tokens)
    got_tokens, got_logits = serve_loop.generate(
        cfg, params, torch.from_numpy(prompt), steps, max_len)
    assert np.array_equal(got_tokens.numpy(), ref_tokens)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("prompt_len", [8, 24])
def test_bfloat16_logits_match_reference(smoke, prompt_len):
    rcfg = dataclasses.replace(smoke[0], param_dtype="bfloat16")
    cfg = dataclasses.replace(smoke[2], param_dtype="bfloat16")
    rparams = ref_tfm.init_params(jax.random.PRNGKey(0), rcfg)
    params = _port_params(rparams, cfg)
    assert params["blocks"]["wq"].dtype == torch.bfloat16
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (3, prompt_len))
    ref_tokens, ref_logits = _ref_generate(rcfg, rparams, prompt, 6, 48)
    tokens, logits = serve_loop.generate(
        cfg, params, torch.from_numpy(prompt), 6, 48,
        forced=torch.tensor(ref_tokens))
    np.testing.assert_allclose(logits.numpy(), ref_logits, **BF16_TOL)
    free_tokens, _ = serve_loop.generate(cfg, params,
                                         torch.from_numpy(prompt), 6, 48)
    same = float((free_tokens.numpy() == ref_tokens).mean())
    print(f"bfloat16 greedy tokens equal to the reference's: {same:.3f}")


def test_init_params_follows_the_reference_scheme():
    cfg = configs.get_smoke("granite_8b")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    again = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = params["blocks"]["w_gate"]
    assert w.shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    std = 1.0 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2.0 * std
    assert abs(float(w.std()) / std - 0.88) < 0.05    # truncated at 2 sd
    # Ones only for 1-D scales: a stacked (n_layers, d) scale is drawn with
    # fan_in = n_layers, as the reference draws it.
    assert torch.equal(params["final_norm"]["scale"], torch.ones(cfg.d_model))
    ln1 = params["blocks"]["ln1"]
    assert float(ln1.abs().max()) <= 2.0 / np.sqrt(cfg.n_layers)
    assert torch.equal(w, again["blocks"]["w_gate"])
    assert sum(p.numel() for grp in params.values()
               for p in grp.values()) == cfg.param_count() + (
        (2 * cfg.n_layers + 1) * cfg.d_model)


# ------------------------------------------------------------ the driver
def _argv(arch: str) -> list[str]:
    return ["--arch", arch, "--smoke", "--requests", "32",
            "--decode-steps", "8"]


def _ref_main_lines(arch: str) -> list[str]:
    """What the reference's driver prints for ``_argv(arch)``."""
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["serve"] + _argv(arch)
    try:
        with contextlib.redirect_stdout(buf):
            ref_serve.main()
    finally:
        sys.argv = argv
    return buf.getvalue().splitlines()


def _ref_cap_event_notes() -> list[str]:
    """The reference driver's cap event rebuilt from its own classes,
    for the manager's notes (the driver does not print them)."""
    spec = TPU_V5E_HOST
    hosts = [ref_snapshot.Host(f"h{i}", spec, power_cap=spec.power_peak)
             for i in range(2)]
    vms = [ref_snapshot.VirtualMachine(vm_id=f"rep{i}", host_id=f"h{i}",
                                       demand=spec.capacity_peak * 0.8)
           for i in range(2)]
    snap = ref_snapshot.ClusterSnapshot(
        hosts, vms, power_budget=sum(h.power_cap for h in hosts))
    snap.hosts["h0"].power_cap *= 0.5
    res = RefManager(RefManagerConfig(dpm_enabled=False)).run_invocation(
        snap)
    return res.notes


@pytest.mark.parametrize("arch", ["granite_8b", "olmoe_1b_7b"])
def test_serve_driver_matches_reference_routing_caps_and_note(capsys, arch):
    """The dense model and the MoE model (its expert FFN on K7's plain
    version) behind the same router and cap event."""
    report = serve.main(_argv(arch) + ["--device", "cpu"],
                        host_spec=_spec(TPU_V5E_HOST))
    assert report.cfg.family == ("moe" if arch == "olmoe_1b_7b" else "dense")
    lines = capsys.readouterr().out.splitlines()
    ref_lines = _ref_main_lines(arch)
    assert lines[0] == ref_lines[0]
    assert lines[2].startswith(ref_lines[2] + "; notes")
    assert report.routing == {"rep0": 16, "rep1": 16}
    assert report.routing_after == {"rep1": 21, "rep0": 11}
    assert list(report.routing_after) == ["rep1", "rep0"]
    assert report.caps_after == [552, 768]
    assert report.notes == _ref_cap_event_notes() == [
        "powercap-balance: 2 cap changes, imbalance 0.100->0.008"]
    assert report.cap_changes == 2 and report.migrations == 0
    assert report.tokens == 32 * 8
    for rep, (prompts, tokens, logits) in report.batches.items():
        n = report.routing[rep]
        assert prompts.shape == (n, 8) and tokens.shape == (n, 8)
        assert logits.shape == (n, 8, 256) and torch.isfinite(logits).all()
        assert torch.equal(tokens, logits.argmax(-1))


# ------------------------------------------------- the balancer's exit
def _serving_snapshots():
    """The serving cap event after BalancePowerCap, in both packages."""
    out = []
    for mod, spec in ((ref_snapshot, TPU_V5E_HOST),
                      (snapshot, _spec(TPU_V5E_HOST))):
        hosts = [mod.Host(f"h{i}", spec, power_cap=c)
                 for i, c in enumerate((552.0, 768.0))]
        vms = [mod.VirtualMachine(vm_id=f"rep{i}", host_id=f"h{i}",
                                  demand=spec.capacity_peak * 0.8)
               for i in range(2)]
        out.append(mod.ClusterSnapshot(hosts, vms, power_budget=1320.0))
    return out


def _cluster(loads, hot_host=None):
    """Three paper hosts at 250 W with VMs of the given demands, placed
    round robin (or all on ``hot_host``), in both packages."""
    out = []
    for mod, spec in ((ref_snapshot, REF_PAPER_HOST),
                      (snapshot, PAPER_HOST)):
        hosts = [mod.Host(f"host{i}", spec, power_cap=250.0)
                 for i in range(3)]
        vms = [mod.VirtualMachine(
            vm_id=f"vm{i}", demand=d, mem_demand=2048.0,
            host_id=hot_host or f"host{i % 3}") for i, d in enumerate(loads)]
        out.append(mod.ClusterSnapshot(hosts, vms, power_budget=750.0))
    return out


@pytest.mark.parametrize("case", ["serving", "unstrained", "balanced"])
def test_balancer_returns_nothing_where_the_reference_stops(case):
    """The serving cap event (imbalance under the threshold), a cluster
    with no strained host, and a strained but even cluster."""
    if case == "serving":
        ref_snap, snap = _serving_snapshots()
    elif case == "unstrained":
        ref_snap, snap = _cluster([1500.0] * 9)
    else:
        ref_snap, snap = _cluster([6800.0] * 9)
    cfg = balancer.BalancerConfig()
    assert ref_balancer.balance(ref_snap, ref_balancer.BalancerConfig()) \
        == []
    assert balancer.balance(snap, cfg, device="cpu") == []


def test_balancer_raises_where_the_reference_moves_a_vm():
    """Everything piled on one host (``tests/test_migration_parity.py``'s
    contended scenario): the port's search makes the reference's moves, and
    leaves both snapshots with the same placement."""
    loads = np.random.RandomState(3).uniform(1500, 2500, 18)
    ref_snap, snap = _cluster(list(loads), hot_host="host0")
    want = ref_balancer.balance(ref_snap, ref_balancer.BalancerConfig())
    assert len(want) > 0
    assert balancer.balance(snap, balancer.BalancerConfig(),
                            device="cpu") == want
    assert ({v.vm_id: v.host_id for v in snap.vms.values()}
            == {v.vm_id: v.host_id for v in ref_snap.vms.values()})
    assert balancer.balance(snap, balancer.BalancerConfig(max_moves=0),
                            device="cpu") == []


def test_normalized_entitlements_match_the_reference_balancer():
    """The balancer's one-cell dense layout (``_DenseCell``) and its
    entitlement waterfill (K1's plain version, 100 trips) give the
    reference balancer's normalized entitlements."""
    from repro.core import kernels as ref_kernels
    from repro.core.migration_core import _DenseCell as RefDenseCell
    from repro import backend as ref_backend
    from repro_torch.core import kernels
    from repro_torch.core.migration_core import _DenseCell
    from repro_torch.drs.entitlement import waterfill_dense

    loads = np.random.RandomState(4).uniform(500, 9000, 12)
    ref_snap, snap = _cluster(list(loads))
    ref_cell = RefDenseCell(ref_snap, extra_slots=1)
    w = ref_cell.work
    managed = ref_kernels.managed_capacity(np, ref_cell.hosts, ref_cell.caps)
    act = w["occ"] & ref_cell.hosts.on[..., None]
    alloc = ref_kernels.waterfill_dense(
        np, ref_backend.NUMPY.fori, managed,
        np.where(act, np.minimum(w["reservation"], w["limit"]), 0.0),
        np.where(act, np.clip(w["cpu"], w["reservation"], w["limit"]), 0.0),
        w["weights"], ref_kernels.MIGRATION_WATERFILL_ITERS, active=act)
    want = np.where(managed > 0, (alloc * act).sum(-1) / managed, 0.0)[0]

    cell = _DenseCell(snap, extra_slots=1)
    w = cell.work
    managed = kernels.managed_capacity(cell.hosts, cell.caps)
    act = w["occ"] & cell.hosts.on[..., None]
    alloc = waterfill_dense(
        managed,
        torch.where(act, torch.minimum(w["reservation"], w["limit"]), 0.0),
        torch.where(act, kernels.clip(w["cpu"], w["reservation"],
                                      w["limit"]), 0.0),
        w["weights"], kernels.MIGRATION_WATERFILL_ITERS, active=act)
    got = torch.where(managed > 0, (alloc * act).sum(-1) / managed, 0.0)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert cell.hosts.on.all()