"""``k4_roofline_pct``: the summed bound of the traced rounds' K4 calls
(one a layer a prefill, :func:`cpcbench.counts.k4_call`) over K4's device
time in the trace, in percent.  Nothing where the trace lost K4 kernels or
the calls counted differ from the wrapper's launches."""

from cpcbench import counts

KERNELS = ("flash_fwd_tc_kernel", "flash_fwd_kernel")


def read(run):
    m = run.model
    calls = [counts.k4_call(m, n, s) for n, s, _ in run.batches
             for _ in range(m["n_layers"])]
    seen, device_s = run.summary.kernel_time(*KERNELS)
    if not calls or seen != len(calls) or run.launches["k4"] != len(calls):
        return None
    return 100.0 * sum(counts.bound_s(*c) for c in calls) / device_s
