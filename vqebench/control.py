"""The control of the benchmark's comparison, and its readings.

The configurations state float32; the control is the plain reference put in
the program's place and computed in bfloat16, the next precision below.
For a cell it runs the cell's own loop (``generator.py``, the cell's
traffic and check sample) over the bfloat16 reference for a short window on
each seed, then compares the sampled answers with the float64 reference
exactly as a run does (``harness.compare``), and prints one JSON line a
seed with each number's reading: the upper readings the limits are set
below.  The benchmark's own runs never run it.

    python3 vqebench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "vqebench":
    sys.path[0] = str(ROOT)


class Stand:
    """A reference in the program's place: the calls the loop makes."""

    def __init__(self, ref):
        self.ref = ref

    def energy(self, theta) -> float:
        return self.ref.energy(theta)

    def energy_and_grad(self, theta):
        return self.ref.energy_and_grad(theta)

    def scipy_fun_jac(self):
        cache = {}

        def evaluate(x):
            key = np.asarray(x, dtype=float).tobytes()
            if key not in cache:
                cache.clear()
                cache[key] = self.energy_and_grad(x)
            return cache[key]

        return (lambda x: evaluate(x)[0]), (lambda x: evaluate(x)[1])


def readings(name: str, seeds, seconds: float, device="cuda", bench=None):
    """One dict a seed: the seed, the calls made and each number's
    reading, for the bfloat16 reference in the program's place."""
    import torch

    from vqebench import generator, harness
    sp = harness.spec(name, bench)
    mod = harness.reference_module(sp.config["reference"])
    ref = mod.build(sp.config, device, torch.float64)
    low = mod.build(sp.config, device, torch.bfloat16)
    theta0 = ref.mp2_guess()
    out = []
    for seed in seeds:
        w = generator.run(Stand(low), theta0, sp.traffic, seed, seconds)
        picks = generator.check_indices(w, sp.traffic, seed)
        checks, failed = harness.compare(sp, w, picks, ref)
        out.append({"seed": seed, "calls": len(w.calls), "failed": failed,
                    **{k: c["value"] for k, c in checks.items()}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    t0 = time.perf_counter()
    seeds = [int(s) for s in args.seeds.split(",")]
    for row in readings(args.workload, seeds, args.seconds, args.device):
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    print(f"control: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
