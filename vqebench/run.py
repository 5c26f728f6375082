"""Run one cell of the port's benchmark once and print its result line.

    python3 vqebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (``openvqe_tpu_torch``), on
a machine with as many CUDA devices as the cell asks for.  The last line of
standard output is the result; the numbers compared with the plain
reference are the last lines of standard error.  A cell on one chip runs in
this process on ``cuda:0``; a cell on c > 1 chips runs as c ranks on one
NCCL group, rank r on ``cuda:r`` (``vqebench/ranks.py``), and this process
prints rank 0's result.  The port's nvcc and g++
libraries build into the checkout's ``build/`` (the first run of a cell in
a checkout builds them; later runs load them), and every other cache a run
may write is kept under ``build/`` too.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout, not this folder, heads the import path: the port and
# ``vqebench`` import from it, and no module here shadows a library's
if sys.path and Path(sys.path[0]).resolve() == ROOT / "vqebench":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
# few host threads, the same on every host: scipy's BFGS update (two dense
# n x n products an iteration) is the host's share of the BFGS cell
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "4"
for var in [v for v in os.environ if v.startswith("OVQE_")]:
    del os.environ[var]          # the objective's default route


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from vqebench import harness

    chips = int(harness.spec(args.workload).cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vqebench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    import openvqe_tpu_torch
    if ROOT not in Path(openvqe_tpu_torch.__file__).resolve().parents:
        print("vqebench: openvqe_tpu_torch is not the checkout's own",
              file=sys.stderr)
        return 2
    if chips == 1:
        result, code = harness.run(args.workload, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0),
                                   t_start=T_START)
    else:
        import signal

        from vqebench import ranks

        # a launcher told to stop kills its ranks on the way out
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        result, code, _ = ranks.launch(
            args.workload, args.seed, args.seconds, bool(args.trace), "nccl",
            [f"cuda:{r}" for r in range(chips)], t_start=T_START)
        bad = harness.forbidden_modules()
        if bad:
            print(f"vqebench: the launcher loaded {', '.join(bad)}",
                  file=sys.stderr)
            return 3
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
