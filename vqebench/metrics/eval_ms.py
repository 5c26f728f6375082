"""Milliseconds a call: the whole window over its energy-and-gradient
calls (the host's optimiser step included)."""


def read(run):
    w = run.window
    if not w.calls or w.grads[0] is None:
        return None
    return 1e3 * w.seconds / len(w.calls)
