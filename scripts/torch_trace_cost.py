#!/usr/bin/env python3
"""The cost of the port's spans and counters with tracing off, on the CPU:
two checkouts in turns on a tiny objective, and the off path alone.

    python3 scripts/torch_trace_cost.py --trees PARENT CHANGE \\
        [--pairs 20] [--calls 400]

Each tree is a checkout of the repository (for example unpacked with
``git archive``).  Each turn of a pair starts a child process with that
tree's port, which binds an odd-Y ansatz of six generators to a small H at
n = 8 on the streaming route (``chunk_bits`` 3, the plain versions, one
torch thread), warms up, and times ``calls`` energy-and-gradient calls
and as many energy calls (median of 5 blocks, microseconds a call).  The
pairs alternate which tree runs first.  Then, in the change tree, the off
path alone, timed with ``timeit``: an off span, and what the uploads and
readbacks add over the bare copies (a span and the counters), times what
one call of each kind makes of them (read from one traced call).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

PROBLEM = r"""
import json, statistics, sys, time, timeit
import numpy as np
import torch
torch.set_num_threads(1)
from openvqe_tpu_torch.ops.pauli import PauliSum
from openvqe_tpu_torch.sim.objective import VQEObjective
N = 8
rng = np.random.default_rng(3)
def term(c, odd_y):
    while True:
        s = rng.choice(np.array(list("IXYZ")), size=N)
        s[rng.integers(N)] = "X"
        if not odd_y or int(np.sum(s == "Y")) % 2:
            break
    q = [i for i, p in enumerate(s) if p != "I"]
    return PauliSum.from_term(N, c, "".join(s[q]), q)
ham = PauliSum.identity(N, 0.2)
for _ in range(8):
    ham = ham + term(float(rng.normal()), False)
gens = [term(1.0, True) for _ in range(6)]
b = VQEObjective(ham, device="cpu", stream=True, chunk_bits=3).bind(gens, 5)
theta = 0.1 * np.arange(1, 7)
"""

TIMED = PROBLEM + r"""
CALLS = int(sys.argv[1])
out = {}
for kind in ("energy_and_grad", "energy"):
    f = getattr(b, kind)
    for _ in range(50):
        f(theta)
    blocks = []
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(CALLS // 5):
            f(theta)
        blocks.append((time.perf_counter() - t) / (CALLS // 5) * 1e6)
    out[kind] = statistics.median(blocks)
print(json.dumps(out))
"""

OFF = PROBLEM + r"""
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.utils import run_logger as rl
rl.enable()
b.energy_and_grad(theta)
b.energy(theta)
rl.enable(False)
recs = rl.calls()
a, s0, s1 = np.zeros(16), torch.zeros(()), torch.zeros(16)
dev = torch.device("cuda")
g = dict(globals())
n = 100000

def t(stmt):
    return min(timeit.repeat(stmt, number=n, repeat=7, globals=g)) / n * 1e6

t_span = t("with rl.stage('ovqe.sweep', dev): pass")
up = t("gr.upload(a, torch.float64, 'cpu')") - t(
    "torch.as_tensor(a, dtype=torch.float64, device='cpu')")
rb0 = t("gr.readback(s0)") - t("s0.item()")
rb1 = t("gr.readback(s1)") - t("s1.detach().cpu()")
res = {"span_us": t_span, "upload_us": up, "readback_scalar_us": rb0,
       "readback_tensor_us": rb1}
for r in recs:
    names = [x[0] for x in r["spans"]]
    plain = sum(x != "ovqe.readback" for x in names)
    grad = r["kind"] == "energy_and_grad"
    off = (plain * t_span + names.count("ovqe.angles") * up + rb0
           + (rb1 if grad else 0.0))
    res[r["kind"]] = {"spans": len(names), "off_us": off}
print(json.dumps(res))
"""


def child(tree: str, code: str, *args) -> dict:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=tree,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, required=True)
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--calls", type=int, default=400)
    args = ap.parse_args()
    parent, change = args.trees
    runs = {parent: [], change: []}
    for i in range(args.pairs):
        order = (parent, change) if i % 2 == 0 else (change, parent)
        for tree in order:
            runs[tree].append(child(tree, TIMED, str(args.calls)))
    res = {}
    for kind in ("energy_and_grad", "energy"):
        p = [r[kind] for r in runs[parent]]
        c = [r[kind] for r in runs[change]]
        d = [b - a for a, b in zip(p, c)]
        res[kind] = {"parent_us": statistics.median(p),
                     "change_us": statistics.median(c),
                     "diff_us_quartiles": statistics.quantiles(d, n=4),
                     "diff_us_median": statistics.median(d),
                     "change_slower_in": sum(x > 0 for x in d)}
    res["off_path"] = child(change, OFF)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
