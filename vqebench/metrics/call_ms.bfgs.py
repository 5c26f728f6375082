"""Median milliseconds of one energy_and_grad call on the host clock (the
call ends in the gradient's copy to the host)."""

import statistics


def read(run):
    w = run.window
    if not w.calls or w.grads[0] is None:
        return None
    return 1e3 * statistics.median(b - a for a, b in w.calls)
