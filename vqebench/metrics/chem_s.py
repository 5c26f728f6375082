"""Seconds of the chemistry and host preparation: SCF, integrals, the
spin-orbital Hamiltonian and its Jordan-Wigner image, the cluster operators
and the MP2 guess (``vqebench/problem.py::build``)."""


def read(run):
    return run.chem_s
