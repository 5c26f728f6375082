"""The arithmetic that the device metrics' readers share, and the
per-function shares that a traced run prints on standard error."""

from vqebench import traces, work

# the kernels of each function of a call, by the start of their names; a
# row reduction finishes the adjoint in an energy-and-gradient call and
# the expectation in an energy-only one.  Only printed, never a metric.
FUNCTIONS = {
    True: {"sweep": ("rot_",), "hpass": ("ham_",),
           "adjoint": ("adjoint_", "row_reduce")},
    False: {"sweep": ("rot_",), "expect": ("expect_", "row_reduce")},
}


def traced(run, kind):
    """The trace, if the run was traced and its calls are of ``kind``
    (True: energy and gradient, False: energy only)."""
    t = run.trace
    w = run.window
    if t is None or not t.calls or t.window_s <= 0 or run.work is None:
        return None
    if (w.grads[0] is not None) != kind:
        return None
    return t


def least_seconds(run, function):
    """The least time of ``function``'s work (``vqebench/work.py``) on the
    run's chips: the work of the whole ideal call, which the cell's c chips
    share, at c chips' peaks; None where the table has no peaks for the
    device.  The count stays the ideal call's whatever implements it, so
    work done twice across ranks and the exchanges lower the share."""
    least = work.least_seconds(run.work[function], run.device_kind)
    return None if least is None else least / int(run.spec.cell["chips"])


def call_roofline(run, kind):
    """Per cent of a whole call's least time over the device's busy time
    (rank 0's, on a cell over several chips)."""
    t = traced(run, kind)
    if t is None or t.busy_s <= 0:
        return None
    least = least_seconds(run, "energy_and_grad" if kind else "energy")
    return None if least is None else 100.0 * t.calls * least / t.busy_s


def idle(run, kind):
    t = traced(run, kind)
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def function_lines(run):
    """One line a function of the traced calls: its least time a call
    (``vqebench/work.py``), its kernels' time a call and the share."""
    kind = run.window.grads[0] is not None
    t = traced(run, kind)
    if t is None:
        return []
    lines = []
    for fn, heads in FUNCTIONS[kind].items():
        least = least_seconds(run, fn)
        spent = sum(d for name, d in t.kernels
                    if traces.short(name).startswith(heads))
        if least is None or spent <= 0:
            lines.append(f"function {fn}: no kernel of it in the trace")
            continue
        lines.append(
            f"function {fn}: least {1e3 * least!r} ms a call, its kernels "
            f"{1e3 * spent / t.calls!r} ms a call, "
            f"{100.0 * t.calls * least / spent!r} % of its roofline")
    return lines
