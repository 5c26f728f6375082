"""L-BFGS with a zoom line search and a plateau stop, as a host loop.

Counterpart of ``openvqe_tpu/optim/minimize.py``, which runs optax's
L-BFGS inside one jitted ``while_loop``.  Here the same algorithm runs as a
Python loop over torch tensors: the direction is optax's two-loop recursion
(``scale_by_lbfgs``: memory 10, the first step scaled by min(1, 1/|g|),
later ones by <dw, du> / <du, du>) and the step comes from optax's zoom
line search (``zoom_linesearch``, the settings of ``optax.lbfgs``: 20
steps, initial guess 1, slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol
1e-6, increase_factor 2, stepsize precision 1e-5), which differs from
``torch.optim.LBFGS``'s.  Parameters and the optimizer's vectors are
float64 on the CPU; ``fun`` may run anywhere and in any precision: it gets
the float64 parameters and returns a 0-dim tensor that autograd
differentiates (through a custom backward where the caller has one, as
``statevector.adjoint_energy``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

MEMORY_SIZE = 10
LS_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5

ValueAndGrad = Callable[[torch.Tensor], Tuple[float, torch.Tensor]]


def _value_and_grad(fun: Callable) -> ValueAndGrad:
    """(value, gradient) of a scalar ``fun`` by autograd, at float64 CPU
    parameters."""
    def vg(x: torch.Tensor) -> Tuple[float, torch.Tensor]:
        x = x.detach().clone().requires_grad_(True)
        v = fun(x)
        (g,) = torch.autograd.grad(v, x)
        return float(v.detach()), g.detach().to("cpu", torch.float64)
    return vg


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.dot(a, b))


def _nan_to_inf(v: float) -> float:
    return math.inf if math.isnan(v) else v


def _cubicmin(a, fa, fpa, b, fb, c, fc) -> float:
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none)."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb, c, fc = map(np.float64, (a, fa, fpa, b, fb, c, fc))
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r1, r2 = fb - fa - fpa * db, fc - fa - fpa * dc
        A = (dc ** 2 * r1 - db ** 2 * r2) / denom
        B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
        radical = B * B - 3.0 * A * fpa
        return float(a + (-B + np.sqrt(radical)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb) -> float:
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb = map(np.float64, (a, fa, fpa, b, fb))
        db = b - a
        B = (fb - fa - fpa * db) / (db ** 2)
        return float(a - fpa / (2.0 * B))


class _LineSearch:
    """optax's ``zoom_linesearch`` (interval search, then zoom; the safe
    step with sufficient decrease when it fails) for one direction."""

    def __init__(self, vg: ValueAndGrad, params, updates, value, grad):
        self.vg, self.params, self.updates = vg, params, updates
        slope = _dot(updates, grad)
        self.value_init, self.slope_init = value, slope
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = 0.0, value, grad, slope
        self.interval_found = self.done = self.failed = False
        self.low = self.high = self.cubic_ref = 0.0
        self.value_low = self.value_high = self.value_cubic_ref = value
        self.slope_low = self.slope_high = slope
        self.safe_stepsize, self.safe_value, self.safe_grad = 0.0, value, grad
        self.decrease_error = math.inf

    def _on_line(self, stepsize: float):
        value, grad = self.vg(self.params + stepsize * self.updates)
        return value, grad, _dot(grad, self.updates)

    def _errors(self, stepsize, value, slope) -> Tuple[float, float]:
        """(decrease error, curvature error); NaN counts as +inf (max and
        min propagate NaN, as jnp's do)."""
        dec = value - self.value_init - SLOPE_RTOL * stepsize * self.slope_init
        approx = slope - (2 * SLOPE_RTOL - 1.0) * self.slope_init
        delta = value - self.value_init - APPROX_DEC_RTOL * abs(
            self.value_init)
        dec = np.maximum(np.minimum(np.maximum(approx, delta), dec), 0.0)
        curv = np.maximum(abs(slope) - CURV_RTOL * abs(self.slope_init), 0.0)
        return _nan_to_inf(float(dec)), _nan_to_inf(float(curv))

    def _search_interval(self):
        new = self.stepsize_guess if self.count == 0 \
            else INCREASE_FACTOR * self.stepsize
        value, grad, slope = self._on_line(new)
        dec, curv = self._errors(new, value, slope)
        error = max(dec, curv)
        if dec <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                new, value, grad)
        set_high = dec > 0.0 or (value >= self.value and self.count > 0)
        set_low = slope >= 0.0 and not set_high
        prev = (self.stepsize, self.value, self.slope)
        if set_low:
            (self.low, self.value_low, self.slope_low) = (new, value, slope)
            (self.high, self.value_high, self.slope_high) = prev
        else:
            (self.low, self.value_low, self.slope_low) = prev
            (self.high, self.value_high, self.slope_high) = (new, value,
                                                             slope)
        self.interval_found = set_high or set_low or error <= 0.0
        self.done = error <= 0.0
        self.failed = self.count + 1 >= LS_STEPS and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.stepsize, self.value, self.grad, self.slope = (new, value, grad,
                                                            slope)
        self.decrease_error = dec

    def _zoom(self):
        low, high = self.low, self.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic = _cubicmin(low, self.value_low, self.slope_low, high,
                          self.value_high, self.cubic_ref,
                          self.value_cubic_ref)
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        else:
            quad = _quadmin(low, self.value_low, self.slope_low, high,
                            self.value_high)
            if left + 0.1 * delta < quad < right - 0.1 * delta:
                middle = quad
            else:
                middle = (low + high) / 2.0
        value, grad, slope = self._on_line(middle)
        dec, curv = self._errors(middle, value, slope)
        error = max(dec, curv)
        if dec <= 0.0 and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                middle, value, grad)
        self.done = error <= 0.0
        set_high_mid = dec > 0.0 or value >= self.value_low
        set_high_low = slope * (high - low) >= 0.0 and not set_high_mid
        old_low = (low, self.value_low, self.slope_low)
        old_high = (high, self.value_high)
        if set_high_mid:
            (self.high, self.value_high, self.slope_high) = (middle, value,
                                                             slope)
        if set_high_low:
            (self.high, self.value_high, self.slope_high) = old_low
        if not set_high_mid:
            (self.low, self.value_low, self.slope_low) = (middle, value,
                                                          slope)
        if set_high_mid or set_high_low:
            self.cubic_ref, self.value_cubic_ref = old_high
        else:
            self.cubic_ref, self.value_cubic_ref = old_low[:2]
        too_small = delta <= STEPSIZE_PRECISION
        failed = (self.count + 1 >= LS_STEPS
                  or (too_small and self.safe_stepsize > 0.0))
        self.failed = failed and not self.done
        self.stepsize, self.value, self.grad, self.slope = (middle, value,
                                                            grad, slope)
        self.decrease_error = dec

    def run(self) -> Tuple[float, float, torch.Tensor]:
        """(stepsize, value, gradient) at the accepted step."""
        self.stepsize_guess = 1.0
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom()
            else:
                self._search_interval()
            self.count += 1
            if self.failed and (self.safe_stepsize > 0.0
                                or math.isinf(self.decrease_error)):
                self.stepsize, self.value, self.grad = (
                    self.safe_stepsize, self.safe_value, self.safe_grad)
        return self.stepsize, self.value, self.grad


class _LBFGSDirection:
    """optax's ``scale_by_lbfgs``: the memory of parameter and gradient
    differences and the two-loop product P_k g."""

    def __init__(self, size: int, memory_size: int):
        self.m = memory_size
        self.count = 0
        self.params = torch.zeros(size, dtype=torch.float64)
        self.updates = torch.zeros(size, dtype=torch.float64)
        self.dw = torch.zeros((memory_size, size), dtype=torch.float64)
        self.du = torch.zeros((memory_size, size), dtype=torch.float64)
        self.rho = [0.0] * memory_size

    def __call__(self, grad: torch.Tensor, params: torch.Tensor
                 ) -> torch.Tensor:
        m = self.m
        idx, prev = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dw, du = params - self.params, grad - self.updates
            vdot = _dot(du, dw)
            rho = 0.0 if vdot == 0.0 else 1.0 / vdot
        else:
            dw = du = torch.zeros_like(params)
            rho = 0.0
        self.dw[prev], self.du[prev], self.rho[prev] = dw, du, rho
        if self.count > 0:
            den = _dot(du, du)
            scale = _dot(du, dw) / den if den > 0.0 else 1.0
        else:
            gnorm = float(torch.linalg.vector_norm(grad))
            scale = min(1.0, 1.0 / gnorm) if gnorm > 0.0 else 1.0
        order = [(idx + i) % m for i in range(m)]
        vec = grad.clone()
        alphas: List[float] = [0.0] * m
        for pos in range(m - 1, -1, -1):
            i = order[pos]
            alphas[pos] = self.rho[i] * _dot(self.dw[i], vec)
            vec = vec - alphas[pos] * self.du[i]
        vec = scale * vec
        for pos in range(m):
            i = order[pos]
            beta = self.rho[i] * _dot(self.du[i], vec)
            vec = vec + (alphas[pos] - beta) * self.dw[i]
        self.count += 1
        self.params, self.updates = params, grad
        return vec


def lbfgs_minimize(fun: Callable, x0, tol: float = 1e-8,
                   maxiter: int = 500, memory_size: int = MEMORY_SIZE,
                   patience: Optional[int] = None, ftol: float = 1e-6
                   ) -> Tuple[torch.Tensor, float, int]:
    """Minimize a scalar ``fun(x)`` from x0; returns (x_opt, value,
    n_iters) with x_opt a float64 CPU tensor.

    The loop runs while the iteration count is below ``maxiter`` and the
    gradient norm at the current point is at least ``tol`` (the first
    iteration always runs).  ``patience`` adds the plateau stop: quit after
    that many consecutive iterations without the value improving by more
    than ``ftol`` (on float32 objectives the gradient norm can sit at a
    rounding floor above ``tol`` after the energy has converged).  The
    result is the best-seen iterate, not the last: after a plateau stop the
    last iterate can sit up to about patience * ftol above the best."""
    vg = _value_and_grad(fun)
    x = torch.as_tensor(np.array(x0, dtype=np.float64)
                        if not isinstance(x0, torch.Tensor)
                        else x0.detach().to("cpu", torch.float64)
                        ).reshape(-1).clone()
    direction = _LBFGSDirection(x.numel(), memory_size)
    best_x, best, since = x, math.inf, 0
    value = grad = None        # the line search's value and gradient at x
    while True:
        if direction.count > 0 and not (
                direction.count < maxiter
                and float(torch.linalg.vector_norm(grad)) >= tol):
            break
        if patience is not None and since >= patience:
            break
        if value is None or math.isinf(value) or math.isnan(value):
            value, grad = vg(x)
        if value < best:
            best_x = x
        improved = value < best - ftol
        best = min(best, value)
        since = 0 if improved else since + 1
        updates = -direction(grad, x)
        step, value, grad = _LineSearch(vg, x, updates, value, grad).run()
        x = x + step * updates
    with torch.no_grad():
        v_final = float(fun(x))
    if v_final <= best:
        return x, v_final, direction.count
    return best_x, best, direction.count


def make_jitted_minimizer(fun: Callable, tol: float = 1e-8,
                          maxiter: int = 500,
                          memory_size: int = MEMORY_SIZE):
    """x0 -> (x_opt, value, iters) for a fixed objective (the JAX package
    jit-compiles this closure; here it is a plain one)."""
    def run(x0):
        return lbfgs_minimize(fun, x0, tol=tol, maxiter=maxiter,
                              memory_size=memory_size)
    return run
