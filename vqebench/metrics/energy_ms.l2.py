"""Milliseconds a call: the whole window over its energy-only calls, in a
cell whose state stays in the L2 cache (its own bound: the host's share of
a call is larger there)."""


def read(run):
    w = run.window
    if not w.calls or w.grads[0] is not None:
        return None
    return 1e3 * w.seconds / len(w.calls)
