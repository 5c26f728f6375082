"""Milliseconds a call: the whole window over its energy-only calls."""


def read(run):
    w = run.window
    if not w.calls or w.grads[0] is not None:
        return None
    return 1e3 * w.seconds / len(w.calls)
