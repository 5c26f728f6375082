"""scipy's ``minimize`` with ``method`` and ``tol`` over the objective's
``scipy_fun_jac`` (one energy-and-gradient call a point).

Every seed runs the same trajectory: the first start is ``theta0`` plus a
normal draw of ``perturb_sd`` radians an angle from the stream
``[start_seed, 1]``, and when the optimiser stops it starts again from
``[start_seed, 2]``, and so on.  So every seed's window holds the same
iterations, line searches and host updates; the seed draws the answers
that are compared (``generator.check_indices``).  The iteration boundaries
are the start of each run and scipy's callback after each iteration.
"""

import time

from vqebench import generator

CALL = "energy_and_grad"


class _Stop(Exception):
    pass


def run(objective, theta0, traffic, seed, seconds, boundary, span, agree):
    import scipy.optimize

    w = generator.start(seconds, agree)
    inner = objective.energy_and_grad

    def timed(x):
        with span("vqebench.call"):
            a = time.perf_counter()
            e, g = inner(x)
            b = time.perf_counter()
        w.record(a, b, x, e, g)
        if w.over(b):
            raise _Stop
        return e, g

    def iteration(*_):
        w.iterations += 1
        boundary(time.perf_counter())

    objective.energy_and_grad = timed
    try:
        while True:
            fun, jac = objective.scipy_fun_jac()
            x0 = generator.point(theta0, traffic["perturb_sd"],
                                 traffic["start_seed"], 1 + w.restarts)
            boundary(time.perf_counter())
            try:
                scipy.optimize.minimize(
                    fun, x0, method=traffic["method"], jac=jac,
                    tol=float(traffic["tol"]), callback=iteration,
                    options={"maxiter": 50000, "disp": False})
            except _Stop:
                return w
            w.restarts += 1
    finally:
        del objective.energy_and_grad
