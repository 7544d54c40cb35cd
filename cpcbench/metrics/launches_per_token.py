"""``launches_per_token``: host-side kernel launch calls in the traced
rounds over the output tokens served in them: the eager serve loop's
launch path."""


def read(run):
    if not run.tokens or not run.summary.launch_calls:
        return None
    return run.summary.launch_calls / run.tokens
