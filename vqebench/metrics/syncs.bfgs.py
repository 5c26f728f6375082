"""Median over the traced stretch's energy-and-gradient calls of the host's
waits on the device in one call (the ``syncs`` counter's delta: the
blocking angle uploads and the readbacks), from the port's per-call records
(``openvqe_tpu_torch.utils.run_logger.calls``)."""

import statistics


def read(run):
    from openvqe_tpu_torch.utils import run_logger
    if not hasattr(run_logger, "calls"):
        return None             # a port without per-call records
    vals = [r["counts"].get("syncs", 0)
            for r in run_logger.calls("energy_and_grad", run.window.t0)]
    return statistics.median(vals) if vals else None
