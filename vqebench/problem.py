"""The system under test: a configuration's VQE problem built by the port.

The recipe of ``openvqe_tpu_torch.algorithms.energy_ucc.EnergyUCC._minimize``
on the configuration's molecule: ``chem.frontend.compute_molecule`` on its
atom list, the spin-orbital integrals and ``to_spin`` of
``ops.hamiltonian``, then the ansatz builder that the configuration names
(``vqebench/ansatze/<builder>.py``), and
``sim.objective.VQEObjective(hamiltonian).bind(generators, hf_init)`` on
the objective's default route.  On a mesh of ranks the objective is the
one ``algorithms.energy_ucc._objective`` gives a mesh (the port's
``parallel.sharded_stream.make_sharded_objective``), bound the same way.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Problem:
    hamiltonian: object          # the port's PauliSum
    generators: List[object]     # the port's PauliSums
    theta0: np.ndarray           # the ansatz's starting angles
    hf_init: int
    n_qubits: int
    chem_s: float


def geometry(molecule: dict):
    """The configuration's atoms as ``[(symbol, (x, y, z)), ...]`` in
    angstrom."""
    if molecule["unit"] != "angstrom":
        raise ValueError(f"atoms in {molecule['unit']!r}, not angstrom")
    return [(sym, tuple(float(c) for c in xyz))
            for sym, xyz in molecule["atoms"]]


def build(config: dict) -> Problem:
    from openvqe_tpu_torch.chem.frontend import compute_molecule
    from openvqe_tpu_torch.ops.hamiltonian import (
        ElectronicStructureHamiltonian, convert_to_h_integrals)

    ansatz = importlib.import_module(
        f"vqebench.ansatze.{config['ansatz']['builder']}")
    t0 = time.perf_counter()
    m = config["molecule"]
    md = compute_molecule(geometry(m), m["basis"], m["spin"], m["charge"],
                          run_fci_flag=False)
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    ham = ElectronicStructureHamiltonian(
        hpq, hpqrs, md.nuclear_repulsion).to_spin(config["mapping"])
    n = ham.nbqbits
    gens, theta0, hf_init = ansatz.build(config, md, hpqrs, n)
    return Problem(ham, gens, theta0, hf_init, n, time.perf_counter() - t0)


def bind(problem: Problem, device, mesh=None):
    """(objective, bound ansatz) on ``device``, the port's default route,
    or on ``mesh`` (a ``parallel.sharded.Mesh``), this rank's part of the
    port's sharded objective."""
    if mesh is None:
        from openvqe_tpu_torch.sim.objective import VQEObjective
        obj = VQEObjective(problem.hamiltonian, device=device)
    else:
        from openvqe_tpu_torch.algorithms.energy_ucc import _objective
        obj = _objective(problem.hamiltonian, mesh)
    return obj, obj.bind(problem.generators, problem.hf_init)
