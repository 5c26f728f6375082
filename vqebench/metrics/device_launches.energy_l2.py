"""Median over the traced stretch's energy-only calls of the port's kernels
put on the device in one call (the deltas of the ``device_launches.*``
counters: a run's launches, a graph's kernel nodes), from the port's per-
call records (``openvqe_tpu_torch.utils.run_logger.calls``)."""

import statistics


def read(run):
    from openvqe_tpu_torch.utils import run_logger
    if not hasattr(run_logger, "calls"):
        return None             # a port without per-call records
    vals = [sum(v for k, v in r["counts"].items()
                if k.startswith("device_launches."))
            for r in run_logger.calls("energy", run.window.t0)]
    return statistics.median(vals) if vals else None
