"""``cap_event_ms``: the harness's clock around the window's one
``launch.serve.power_event`` (h0's cap halved, one manager invocation on
the card, the router re-synced), synced: the power plane's time."""


def read(run):
    return run.cap_event_ms
