"""90th percentile, in milliseconds, of the window's energy_and_grad calls
on the host clock."""

import statistics


def read(run):
    w = run.window
    if len(w.calls) < 2 or w.grads[0] is None:
        return None
    return 1e3 * statistics.quantiles([b - a for a, b in w.calls],
                                      n=10)[8]
