"""``k7_roofline_pct``: the summed bound of the traced rounds' K7 calls
(three a MoE layer a forward: the prefill's over the prompts' tokens, each
decode step's over one token a request; :func:`cpcbench.counts.k7_calls`)
over K7's device time in the trace, in percent.  Nothing for a model
without experts, or where the trace lost K7 kernels or the calls counted
differ from the wrapper's launches."""

from cpcbench import counts

KERNELS = ("gmm_wide_kernel", "gmm_narrow_kernel", "gmm_kernel")


def read(run):
    m = run.model
    if m["family"] != "moe":
        return None
    calls = []
    for n, s, steps in run.batches:
        for tokens in [n * s] + [n] * (steps - 1):
            calls += counts.k7_calls(m, tokens) * m["n_layers"]
    seen, device_s = run.summary.kernel_time(*KERNELS)
    if not calls or seen != len(calls) or run.launches["k7"] != len(calls):
        return None
    return 100.0 * sum(counts.bound_s(*c) for c in calls) / device_s
