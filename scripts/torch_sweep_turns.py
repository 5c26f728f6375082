#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: the fused sweeps (A3
``rot_fused``, C9 ``adjoint_fused``), the bucketed H-apply and
expectation (B6 ``ham_bucketed``, D12 ``expect_bucketed``), the hoisted
expectation (D13 ``expect_hoisted``), the per-group streaming adjoint (C8
``adjoint_stream``) and the paths that run them.

    python3 scripts/torch_sweep_turns.py --trees PARENT CHANGE \\
        [--h16 PICKLE] [--quick]

Each tree is a checkout of the repository (for example unpacked with
``git archive``) that holds ``chip_smoke.py`` and ``openvqe_tpu_torch``.
The turns run parent, change, change, parent; in each a child process
(at most 900 s) measures, with that tree's modules and kernels (built
into the tree's own ``build/``):

* A3 and C9 at H10's shapes (the UCCSD runs of ``chip_smoke.py`` phase 5
  at theta1), B6 over both K classes of H10's H and each class alone, D12
  with ``herm`` over both classes, D13 over the hoisted off-diagonal
  classes of OVQE_EXP_HOIST=1 (and its value), C8 on the reversed UCCSD
  groups of the OVQE_STREAM_FUSE=0 objective at theta1, from that route's
  forward state and lambda (and SHA-256s of the p and lambda it returns
  and of its gradient entries): CUDA events over 20 calls after 3
  warm-ups;
* the H10 fused ``energy_and_grad`` and the OVQE_STREAM_FUSE=0 one at
  theta0 (host clock, median of 20 calls, each returning host numbers),
  and each one's energy and gradient at theta0 and theta1 (the gradient
  as a SHA-256 of its float64 entries), which the table compares across
  the turns bit for bit;
* unless ``--quick``, the H10 fermionic ADAPT run of ``chip_smoke.py``
  phase 10 (3 outer iterations, the float32 Lanczos reference included;
  host clock);
* unless ``--quick``, with ``--h16`` (a pickle written by
  ``chip_smoke.py --h16-setup PATH``): the 30-qubit entry point on H16
  tapered to 30 qubits at the MP2 guess,
  the in-place A3 sweep, the expectation (D12 ``herm``) and the
  expectation of OVQE_EXP_HOIST=1 (D13 and D12) on the same state, timed
  apart (host clock, each ending in a device sync), with their values.

The card's name and power limit come first, then one ``TURN`` JSON line
per child and a table of the turns.  Needs one CUDA card.
"""

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace


def median(ts):
    return sorted(ts)[len(ts) // 2]


def sha256(a) -> str:
    """SHA-256 of an array's float64 values (a tensor is read back)."""
    import numpy as np
    if hasattr(a, "detach"):
        a = a.detach().double().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.float64)
                          .tobytes()).hexdigest()


def measure(tree: Path, h16: str, quick: bool) -> dict:
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    K.build()
    K._load()
    out = {"tree": str(tree), "card": cs.card_line()}
    ref10 = json.loads((tree / "tests" / "torch_h10_reference.json"
                        ).read_text())
    ref_adapt = json.loads((tree / "tests" / "torch_adapt_reference.json"
                            ).read_text())
    with contextlib.redirect_stdout(io.StringIO()):
        h10 = cs.h10_problem()
    obj = VQEObjective(h10.ham, device="cuda")
    b = obj.bind(h10.gens, h10.hf)
    pts = ref10["points"]
    theta0 = np.asarray(pts["theta0"]["theta"])
    theta1 = np.asarray(pts["theta1"]["theta"])
    psi = cs.rand_state(h10.n, 11, torch.device("cuda"))
    fwd, adj, fm = b._fwd, b._adj, b._fmode
    af = st.bucket_angles(fwd, theta1, torch.float32, psi.device)
    aa = st.bucket_angles(adj, theta1, torch.float32, psi.device)
    lam = None
    for hc in obj.hclasses:
        lam = K.ham_bucketed(psi, lam, hc)
    out["a3_ms"] = cs.cuda_ms(lambda: K.rot_fused(psi, af, fwd, fm))
    out["c9_ms"] = cs.cuda_ms(lambda: K.adjoint_fused(psi, lam, aa, adj,
                                                      fm))

    def ham(classes):
        acc = None
        for hc in classes:
            acc = K.ham_bucketed(psi, acc, hc)
        return acc

    out["b6_ms"] = cs.cuda_ms(lambda: ham(obj.hclasses))
    for hc in obj.hclasses:
        out[f"b6_k{hc.K}_ms"] = cs.cuda_ms(lambda: ham([hc]))
    out["d12_herm_ms"] = cs.cuda_ms(
        lambda: [K.expect_bucketed(psi, hc, True) for hc in obj.hclasses])
    hoisted = [o for h, o in st.expect_operands(
        st.ham_view(obj.gham, h10.n), obj.chunk_bits, psi.device,
        torch.float32, True) if h]
    out["d13_h10_ms"] = cs.cuda_ms(
        lambda: [K.expect_hoisted(psi, ho) for ho in hoisted])
    out["d13_h10_value"] = sum(float(K.expect_hoisted(psi, ho))
                               for ho in hoisted)

    with cs.env_vars(OVQE_STREAM_FUSE="0"):
        obj0 = VQEObjective(h10.ham, device="cuda")
        b0 = obj0.bind(h10.gens, h10.hf)
    adj0 = b0._adj
    psi1 = b0.forward(theta1)
    _, lam1 = obj0._energy_and_lam(psi1)
    aa0 = st.group_angles(adj0, theta1, torch.float32, psi.device)
    out["c8_ms"] = cs.cuda_ms(
        lambda: K.adjoint_stream(psi1, lam1, aa0, adj0, b0._fmode))
    p1, l1, gts1 = K.adjoint_stream(psi1, lam1, aa0, adj0, b0._fmode)
    out["c8_theta1_state_sha256"] = sha256(torch.cat([p1, l1]))
    out["c8_theta1_grad_sha256"] = sha256(gts1)

    for tag, ba in (("", b), ("fuse0_", b0)):
        ba.energy_and_grad(theta0)
        torch.cuda.synchronize()
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            e, g = ba.energy_and_grad(theta0)
            ts.append(time.perf_counter() - t)
        out[f"h10_{tag}energy_and_grad_ms"] = 1e3 * median(ts)
        e1, g1 = ba.energy_and_grad(theta1)
        for name, (en, gr) in (("theta0", (e, g)), ("theta1", (e1, g1))):
            out[f"h10_{tag}energy_{name}"] = en
            out[f"h10_{tag}grad_{name}_sha256"] = sha256(gr)
    if quick:
        return out

    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t = time.time()
        it, idx, _ = cs.run_adapt(h10, ref_adapt["h10"]["FCI"], Path(tmp),
                                  "turn")
        torch.cuda.synchronize()
        out["h10_adapt_s"] = time.time() - t
    out["h10_adapt_indices"] = [int(i) for i in idx]
    out["h10_adapt_energies"] = [float(v) for v in it["energies"]]

    if h16:
        with open(h16, "rb") as f:
            h = SimpleNamespace(**pickle.load(f))
        energy = st.build_streaming_energy_xl_fn(h.gseq, h.gham, h.hf)
        with cs.env_vars(OVQE_EXP_HOIST="1"):
            energy_h = st.build_streaming_energy_xl_fn(h.gseq, h.gham, h.hf)
        psi16, t_fwd = cs.timed(energy.forward, h.theta0)
        e16, t_exp = cs.timed(energy.expectation, psi16)
        e13, t_13 = cs.timed(energy_h.expectation, psi16)
        del psi16
        out.update(h16_sweep_s=t_fwd, h16_expectation_s=t_exp,
                   h16_energy_s=t_fwd + t_exp, h16_energy=e16,
                   h16_hoist_expectation_s=t_13,
                   h16_hoist_energy_s=t_fwd + t_13, h16_hoist_energy=e13,
                   h16_runs=int(st.build_seq_buckets(st.stream_seq_data(
                       h.gseq, st.chunk_bits_for(h.n))).B))
    return out


ORDER = (0, 1, 1, 0)    # the turns: indices into --trees
CHILD_TIMEOUT_S = 900.0

METRICS = ("a3_ms", "c9_ms", "b6_ms", "b6_k8_ms", "b6_k64_ms", "d12_herm_ms",
           "d13_h10_ms", "c8_ms", "h10_energy_and_grad_ms",
           "h10_fuse0_energy_and_grad_ms", "h10_adapt_s", "h16_sweep_s",
           "h16_expectation_s", "h16_energy_s", "h16_hoist_expectation_s",
           "h16_hoist_energy_s")
VALUES = ("d13_h10_value", "h10_energy_theta0", "h10_energy_theta1",
          "h10_fuse0_energy_theta0", "h10_fuse0_energy_theta1", "h16_energy",
          "h16_hoist_energy")
SAME = ("h10_grad_theta0_sha256", "h10_grad_theta1_sha256",
        "h10_fuse0_grad_theta0_sha256", "h10_fuse0_grad_theta1_sha256",
        "c8_theta1_state_sha256", "c8_theta1_grad_sha256",
        "h10_adapt_indices", "h10_adapt_energies")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("PARENT", "CHANGE"),
                    help="the two checkouts")
    ap.add_argument("--h16", default="", help="H16 set-up pickle")
    ap.add_argument("--measure", default="", help=argparse.SUPPRESS)
    ap.add_argument("--quick", action="store_true",
                    help="the kernels and energy_and_grad only")
    args = ap.parse_args()
    if args.measure:
        print("TURN " + json.dumps(measure(Path(args.measure).resolve(),
                                           args.h16, args.quick)),
              flush=True)
        return 0
    if not args.trees:
        ap.error("--trees PARENT CHANGE is required")
    trees = [Path(t).resolve() for t in args.trees]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    h16 = str(Path(args.h16).resolve()) if args.h16 else ""
    turns = []
    for i in ORDER:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
               str(trees[i])] + (["--h16", h16] if h16 else []) \
            + (["--quick"] if args.quick else [])
        t = time.time()
        proc = subprocess.run(cmd, cwd=str(trees[i]), capture_output=True,
                              text=True, timeout=CHILD_TIMEOUT_S)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"turn of tree {i} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        rec = json.loads(lines[-1][5:])
        rec.update(index=i, wall_s=time.time() - t)
        turns.append(rec)
        print("TURN " + json.dumps(rec), flush=True)
    print("metric " + " ".join(f"tree{r['index']}" for r in turns))
    for m in METRICS + VALUES:
        if all(m in r for r in turns):
            print(f"{m} " + " ".join(f"{r[m]!r}" if m in VALUES
                                     else f"{r[m]:.6g}" for r in turns))
    for m in SAME:
        if all(m in r for r in turns):
            print(f"{m} the same in every turn: "
                  f"{all(r[m] == turns[0][m] for r in turns)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
