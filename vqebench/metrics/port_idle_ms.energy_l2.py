"""Median over the traced stretch's energy-only calls of the device's idle
time inside the port's call, in ms: the call's host time less the device
time of its stages (``port_idle_ms`` of the port's per-call records,
``openvqe_tpu_torch.utils.run_logger.calls``)."""

import statistics


def read(run):
    from openvqe_tpu_torch.utils import run_logger
    if not hasattr(run_logger, "calls"):
        return None             # a port without per-call records
    vals = [r["port_idle_ms"]
            for r in run_logger.calls("energy", run.window.t0)
            if r["port_idle_ms"] is not None]
    return statistics.median(vals) if vals else None
