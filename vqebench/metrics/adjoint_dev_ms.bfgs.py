"""Median over the traced stretch's energy-and-gradient calls of the device
time of the adjoint sweep (stage ``ovqe.adjoint``, CUDA events around its
launches), in ms, from the port's per-call records
(``openvqe_tpu_torch.utils.run_logger.calls``)."""

import statistics


def read(run):
    from openvqe_tpu_torch.utils import run_logger
    if not hasattr(run_logger, "calls"):
        return None             # a port without per-call records
    vals = [r["device_ms"]["ovqe.adjoint"]
            for r in run_logger.calls("energy_and_grad", run.window.t0)
            if "ovqe.adjoint" in r["device_ms"]]
    return statistics.median(vals) if vals else None
