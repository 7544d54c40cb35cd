"""``cap_invocation_ms``: the host's time of the traced rounds' one
manager invocation (the port's ``repro_torch.power.invocation`` span
inside ``launch.serve.power_event``: the balancer and the cap note on
K1-K3, its caps returned to the host), in ms.  Nothing where the program
records no such span or lost any (:mod:`cpcbench.spans`)."""

from cpcbench import spans


def read(run):
    found = spans.named(run, spans.INVOCATION)
    return found[0].host_ms if found else None
