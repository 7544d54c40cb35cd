"""The counts, the trace arithmetic and the percentile against
hand-worked cases."""

import smoke_root  # noqa: F401  (the import path)
import pytest

from cpcbench import counts, harness
from cpcbench import trace as tr

DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 10}
MOE = dict(DENSE, family="moe", n_experts=5, moe_top_k=2, d_ff=3)


def test_k4_call_by_hand():
    m = {"n_heads": 2, "n_kv_heads": 1, "head_dim": 8}
    # 10 causal pairs of 4 positions; 2 products of 2 x 8 a pair-head.
    ops, nbytes = counts.k4_call(m, 2, 4)
    assert ops == 4 * 2 * 2 * 8 * 10
    # q and o 2*4*2*8 each, k and v 2*4*1*8 each, 2 B; lse 2*2*4 x 4 B.
    assert nbytes == (2 * 128 + 2 * 64) * 2 + 64


def test_k7_calls_by_hand():
    m = {"moe_top_k": 2, "d_model": 4, "d_ff": 3, "n_experts": 5}
    calls = counts.k7_calls(m, 6)
    assert calls == [(288.0, 288.0)] * 3     # 12 rows: 2*12*4*3 ops;
    # (12*4 + 5*4*3 + 12*3) * 2 bytes


def test_active_params_by_hand():
    attn = 8 * 8 * 2 + 8 * 4 * 2
    assert counts.active_params(DENSE) == 2 * (attn + 3 * 8 * 16)
    assert counts.active_params(MOE) == 2 * (attn + 8 * 5 + 2 * 3 * 8 * 3)


def test_model_flops_by_hand():
    n, s, steps = 3, 5, 4
    linear = 2 * counts.active_params(DENSE) * n * (s + steps - 1)
    attn = 4 * n * 8 * 15 + sum(4 * n * 8 * (s + j) for j in (1, 2, 3))
    head = 2 * 8 * 10 * n * steps
    assert counts.model_flops(DENSE, (n, s, steps)) == \
        linear + 2 * attn + head


def test_bound_is_the_larger_term():
    p = {"bf16_flops_per_s": 10.0, "hbm_bytes_per_s": 2.0}
    assert counts.bound_s(100.0, 4.0, p) == 10.0
    assert counts.bound_s(10.0, 40.0, p) == 20.0


def test_busy_is_the_union():
    assert tr.busy_ns([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17


def test_short_name():
    assert tr.short_name("void (anonymous namespace)::flash_fwd_tc_kernel"
                         "<128, true>(CUtensorMap, int)") == \
        "flash_fwd_tc_kernel"


def test_gaps_named_by_the_innermost_op():
    ops = [(0, 100, "outer"), (10, 40, "inner"), (50, 60, "late")]
    got = tr._gap_names([(20, 30), (42, 46), (70, 80), (200, 210)], ops)
    assert got == pytest.approx({"inner": 10e-9, "outer": 14e-9,
                                 "(no host op)": 10e-9})


def test_p95_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0] * 16 + [5.0]) == 5.0
    assert harness.p95([2.0]) == 2.0


class _Event:
    """A kineto event of a torch whose events do not state their kind."""

    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        return self._device


@pytest.mark.parametrize("name,device,kind", [
    ("cpcbench.traced", "CPU", "user_annotation"),
    ("cpcbench.round", "CUDA", "gpu_user_annotation"),
    ("void flash_fwd_tc_kernel<128>(CUtensorMap)", "CUDA", "kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "CUDA", "gpu_memcpy"),
    ("Memset (Device)", "CUDA", "gpu_memset"),
    ("cudaLaunchKernel", "CPU", "cuda_runtime"),
    ("cuLaunchKernelEx", "CPU", "cuda_driver"),
    ("aten::mm", "CPU", "cpu_op"),
])
def test_kind_from_device_and_name(name, device, kind):
    from torch.autograd import DeviceType
    assert tr.kind(_Event(name, getattr(DeviceType, device))) == kind
