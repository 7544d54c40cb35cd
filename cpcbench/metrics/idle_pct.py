"""``idle_pct``: the share of the traced rounds' window in which no
kernel, copy or memset ran on the card, in percent."""


def read(run):
    if not run.summary.window_s:
        return None
    return 100.0 * (1.0 - run.summary.busy_s / run.summary.window_s)
