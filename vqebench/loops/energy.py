"""Energy-only calls back to back, each at ``theta0`` plus a fresh normal
draw of ``perturb_sd`` radians an angle from the seed's stream 0: the call
stream of gradient-free optimisers and of energy scans.  Each call is an
iteration of its own."""

import time

import numpy as np

from vqebench import generator

CALL = "energy"


def run(objective, theta0, traffic, seed, seconds, boundary, span, agree):
    rng = np.random.default_rng([seed, 0])
    sd = float(traffic["perturb_sd"])
    w = generator.start(seconds, agree)
    while True:
        th = theta0 + sd * rng.standard_normal(theta0.shape)
        boundary(time.perf_counter())
        with span("vqebench.call"):
            a = time.perf_counter()
            e = objective.energy(th)
            b = time.perf_counter()
        w.record(a, b, th, e)
        w.iterations += 1
        if w.over(b):
            return w
