"""A cell over c > 1 chips: one process a rank, one rank a card.

``run.py`` calls ``launch`` for a cell whose ``chips`` is above 1.  It
starts c ``sys.executable`` processes from the checkout, which inherit its
environment (``run.py`` has cleared ``OVQE_*`` and fixed the BLAS threads)
plus ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets them.
Each rank joins one process group through a ``FileStore`` in a temporary
folder (no port), runs on its own device, builds the port's mesh
(``parallel.sharded.make_mesh``) and runs ``harness.run`` on the same seed
and traffic, so every rank makes the same collective calls.  A gloo group
beside it carries the harness's own host traffic: rank 0's decision that
the window is over, and after the window each rank's peak and the hash of
its answers.  Then the group is destroyed, ranks other than 0 exit 0, and
rank 0 alone runs the plain reference and writes the result, which
``launch`` hands back for ``run.py`` to print.

Nothing hangs: the rendezvous and every collective time out after
``collective_timeout`` seconds and the whole launch after ``timeout``.  A
rank that raises, dies, or holds ``jax``, ``jaxlib``, ``flax`` or
``openvqe_tpu`` at its end exits non-zero; ``launch`` then kills the other
ranks, prints each rank's last lines on standard error and returns no
result.  A rank dies with the launcher, even one killed outright.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import importlib.util
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TIMEOUT_S = 180.0
# the first run of a cell in a checkout builds the port's libraries
LAUNCH_TIMEOUT_S = 1150.0
BOOT = ("import sys; sys.path.insert(0, {root!r}); "
        "from vqebench import ranks; "
        "sys.exit(ranks.rank_main(sys.argv[1], int(sys.argv[2])))")


class Group:
    """This rank's view of the cell's ranks: the port's mesh, and a gloo
    group of the harness's own for what the host decides and gathers."""

    def __init__(self, mesh, host):
        self.mesh = mesh
        self.host = host
        self.rank = mesh.rank
        self.size = mesh.size
        self.window = None       # the rank's window, once it has closed

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop``, on every rank."""
        import torch
        import torch.distributed as dist
        flag = torch.tensor([int(stop)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.host)
        return bool(flag.item())

    def settle(self, peak: int, digest: str) -> List[tuple]:
        """Every rank's (peak bytes, answers' hash) in rank order; then the
        ranks' groups are destroyed."""
        import torch.distributed as dist
        rows: List[Optional[tuple]] = [None] * self.size
        dist.all_gather_object(rows, (int(peak), str(digest)),
                               group=self.host)
        dist.destroy_process_group()
        return rows


def _load(path: str, function: str):
    mod_spec = importlib.util.spec_from_file_location(
        "vqebench_prelude", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return getattr(mod, function)


def _die_with_launcher(launcher: int) -> None:
    """Have the kernel kill this rank when its launcher ends
    (``PR_SET_PDEATHSIG``), and end now if it already has."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != launcher:
        os._exit(1)


def rank_main(folder: str, rank: int) -> int:
    """One rank: join the group, run the cell, leave rank 0's result."""
    folder = Path(folder)
    job = json.loads((folder / "job.json").read_text())
    _die_with_launcher(job["launcher"])

    import torch
    import torch.distributed as dist

    from openvqe_tpu_torch.parallel.sharded import make_mesh
    from vqebench import harness

    world = len(job["devices"])
    timeout = datetime.timedelta(seconds=float(job["collective_timeout"]))
    device = torch.device(job["devices"][rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(str(folder / "store"), world)
    store.set_timeout(timeout)
    # an exception leaves the group as it is: the launch kills the ranks
    dist.init_process_group(job["backend"], store=store, rank=rank,
                            world_size=world, timeout=timeout)
    if job["prelude"]:
        _load(*job["prelude"])(rank)
    host = (dist.new_group(backend="gloo", timeout=timeout)
            if job["backend"] != "gloo" else dist.group.WORLD)
    group = Group(make_mesh(world, device=device), host)
    result, code = harness.run(
        job["name"], job["seed"], job["seconds"], job["trace"], device,
        t_start=job["t_start"], bench=job["bench"], group=group)
    if rank == 0 and code == 0:
        if job["answers"]:
            (folder / "window.pkl").write_bytes(pickle.dumps(
                dataclasses.replace(group.window, agree=bool)))
        (folder / "result.json").write_text(json.dumps(result))
    return code


def launch(name: str, seed: int, seconds: float, trace: bool, backend: str,
           devices: Sequence[str], t_start: Optional[float] = None,
           bench: Optional[dict] = None,
           collective_timeout: float = COLLECTIVE_TIMEOUT_S,
           timeout: float = LAUNCH_TIMEOUT_S, prelude=None,
           answers: bool = False):
    """(result, exit code, window): the cell ``name`` on ``len(devices)``
    ranks of a ``backend`` group (``nccl``, or ``gloo`` for the CPU or
    ranks that share a card), rank r on ``devices[r]``.  The result is
    rank 0's, or None where the run may not print one; the window is rank
    0's where ``answers`` asks for it (else None).  ``prelude`` names a
    function (file, name) that each rank calls with its rank once the
    group is up (the tests plant faults with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    world = len(devices)
    with tempfile.TemporaryDirectory(prefix="vqebench_ranks_") as tmp:
        folder = Path(tmp)
        (folder / "job.json").write_text(json.dumps({
            "name": name, "seed": int(seed), "seconds": float(seconds),
            "trace": bool(trace), "backend": backend,
            "devices": [str(d) for d in devices], "t_start": t_start,
            "bench": bench, "collective_timeout": float(collective_timeout),
            "prelude": list(prelude) if prelude else None,
            "answers": bool(answers), "launcher": os.getpid()}))
        # NCCL's watchdog ends a rank whose collective times out, and
        # neither writes its flight recorder to a fixed path under /tmp
        # nor waits a minute for that dump first
        env = dict(os.environ, WORLD_SIZE=str(world),
                   TORCH_NCCL_ASYNC_ERROR_HANDLING="1",
                   TORCH_NCCL_DUMP_ON_TIMEOUT="0",
                   TORCH_NCCL_WAIT_TIMEOUT_DUMP_MILSEC="1000")
        procs, logs = [], []
        try:
            for r in range(world):
                log = open(folder / f"log_{r}.txt", "w")
                logs.append(log)
                # rank 0's standard error is the run's: its last lines
                # are the numbers compared
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", BOOT.format(root=str(ROOT)),
                     tmp, str(r)], cwd=str(ROOT),
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=None if r == 0 else log))
            late = _wait(procs, time.monotonic() + float(timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        if late or any(codes):
            why = (f"the launch passed its {timeout:g} s" if late else
                   "a rank failed")
            print(f"vqebench: {why}; exit codes by rank {codes} (-9: "
                  f"killed)", file=sys.stderr)
            for r in range(world):
                tail = (folder / f"log_{r}.txt").read_text()[-3000:]
                print(f"--- rank {r} (exit {codes[r]}) ---\n{tail}",
                      file=sys.stderr)
            code = 124 if late else next((c for c in codes if c > 0), 1)
            return None, code, None
        result = json.loads((folder / "result.json").read_text())
        window = (pickle.loads((folder / "window.pkl").read_bytes())
                  if answers else None)
    return result, 0, window


def _wait(procs, deadline: float) -> bool:
    """Wait until every rank has exited, one has failed, or the deadline
    has passed (True)."""
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes) or any(codes):
            return False
        if time.monotonic() > deadline:
            return True
        time.sleep(0.05)
