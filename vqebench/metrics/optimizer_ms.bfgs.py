"""Milliseconds a call of window time outside the objective's calls: the
host's optimiser (scipy BFGS's update and line search) between calls."""


def read(run):
    w = run.window
    if not w.calls or w.grads[0] is None:
        return None
    inside = sum(b - a for a, b in w.calls)
    return 1e3 * (w.seconds - inside) / len(w.calls)
