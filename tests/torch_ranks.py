"""Run a function on the ranks of a ``torch.distributed`` gloo group, one
``sys.executable`` process per rank.  Not a test module.

    results = run_ranks(world, "torch_sharded_jobs:h4_job", payload, tmp)

Each rank imports the function (``module:function``, importable from this
directory or the repo root), calls it with the payload, and pickles its
return value; ``run_ranks`` returns the values in rank order.
``launch_ranks`` starts the ranks and returns at once (``Launch.wait``
collects them), so a test module can compute its references meanwhile.
The group meets through a ``FileStore`` under ``tmp`` (no port), every
collective times out after ``collective_timeout`` seconds, the whole
launch after ``timeout``, and a rank that fails ends the launch at once
(the others are killed), so a fault cannot hang a test run.  A rank runs
torch on one thread (``tests/torch_threads.py`` explains why) and imports
neither JAX nor pytest.
"""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BOOT = ("import sys; sys.path[:0] = [{!r}, {!r}]; import torch_ranks; "
        "sys.exit(torch_ranks.rank_main())").format(str(HERE), str(ROOT))


class Launch:
    """Ranks started by ``launch_ranks``; ``wait`` collects them."""

    def __init__(self, world, job, tmp, procs, timeout):
        self.world, self.job, self.tmp, self.procs = world, job, tmp, procs
        self.deadline = time.time() + timeout
        self._results = None

    def wait(self):
        if self._results is None:
            self._results = self._collect()
        return self._results

    def _collect(self):
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) \
                        or time.time() > self.deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            logs = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + (self.tmp / f"log_{r}.txt").read_text()[-4000:]
                for r, c in enumerate(codes))
            raise RuntimeError(f"{self.job} on {self.world} ranks failed "
                               f"(exit -9: killed at the time limit or "
                               f"after another rank failed):\n{logs}")
        return [pickle.loads((self.tmp / f"result_{r}.pkl").read_bytes())
                for r in range(self.world)]


def launch_ranks(world: int, job: str, payload, tmp, timeout: float = 240,
                 collective_timeout: float = 60) -> Launch:
    """Start ``job`` on ``world`` ranks and return at once."""
    tmp = Path(tmp) / f"ranks_{world}_{job.replace(':', '_')}"
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "payload.pkl").write_bytes(pickle.dumps(payload))
    env = dict(os.environ, OVQE_RANKS_DIR=str(tmp), OVQE_WORLD=str(world),
               OVQE_JOB=job,
               OVQE_COLLECTIVE_TIMEOUT=str(collective_timeout),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = []
    for r in range(world):
        with open(tmp / f"log_{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", BOOT], cwd=str(ROOT),
                env=dict(env, OVQE_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
    return Launch(world, job, tmp, procs, timeout)


def run_ranks(world: int, job: str, payload, tmp, **kw):
    """``launch_ranks(...).wait()``: the job's values in rank order."""
    return launch_ranks(world, job, payload, tmp, **kw).wait()


def rank_main() -> int:
    """One rank: join the group, run the job, write the result."""
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    tmp = Path(os.environ["OVQE_RANKS_DIR"])
    rank, world = int(os.environ["OVQE_RANK"]), int(os.environ["OVQE_WORLD"])
    dist.init_process_group(
        "gloo", rank=rank, world_size=world,
        store=dist.FileStore(str(tmp / "store"), world),
        timeout=datetime.timedelta(
            seconds=float(os.environ["OVQE_COLLECTIVE_TIMEOUT"])))
    try:
        mod, fn = os.environ["OVQE_JOB"].split(":")
        payload = pickle.loads((tmp / "payload.pkl").read_bytes())
        out = getattr(importlib.import_module(mod), fn)(payload)
        (tmp / f"result_{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0
