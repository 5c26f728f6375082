"""The port's QUCCSD (openvqe_tpu_torch/algorithms/{quccsd,energy_qucc}.py,
mains/main_quccsd*.py) on the CPU in float64: H4 ``execute()``, non-active
and active, against the JAX package's run on the same chemistry
(tests/torch_quccsd_reference.json, made by
tests/torch_quccsd_reference.py) to 1e-8; the generators are odd-Y, so the
grouped route runs them; the mains with ``get_energies`` stubbed, as
tests/test_mains.py runs the JAX package's."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

from openvqe_tpu.algorithms.energy_qucc import EnergyUCC as JEnergyQUCC
from openvqe_tpu.models.molecule_factory import MoleculeFactory as JFactory
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim.compile import compile_op_sequence as jcompile_seq
from openvqe_tpu_torch.algorithms.energy_qucc import EnergyUCC
from openvqe_tpu_torch.models.molecule_factory import MoleculeFactory
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim.compile import compile_op_sequence
from openvqe_tpu_torch.vqe import VQE
from torch_threads import one_torch_thread  # noqa: F401

REF = json.loads((Path(__file__).parent
                  / "torch_quccsd_reference.json").read_text())["quccsd"]


@pytest.mark.parametrize("active", [False, True])
def test_quccsd_h4_matches_jax(active):
    with contextlib.redirect_stdout(io.StringIO()):
        _, res = VQE.algorithm("quccsd", "H4", "QUCCSD", "JW", active,
                               {"device": "cpu"}).execute()
    want = REF["H4_active" if active else "H4"]
    for k in ("energies1_substracted_from_FCI",
              "energies2_substracted_from_FCI"):
        assert abs(res[k] - want[k]) < 1e-8, k
    for k in ("len_op1", "len_op2", "CNOT1", "CNOT2"):
        assert res[k] == want[k], k
    assert [len(res["energies_1"]), len(res["energies_2"])] \
        == want["objective_calls"]


def test_quccsd_generators_are_odd_y_and_counted():
    """JW(T) * 1j groups on the grouped engine, in both packages, and the
    Yordanov counts agree."""
    with contextlib.redirect_stdout(io.StringIO()):
        _, ham_sp, *_ = MoleculeFactory().generate_hamiltonian(
            "H4", display=False)
        ops = MoleculeFactory().generate_cluster_ops("H4", "QUCCSD", "JW")
        jops = JFactory().generate_cluster_ops("H4", "QUCCSD", "JW")
    n = ham_sp.nbqbits
    gens = EnergyUCC._generators(ops[1])
    assert gr.group_op_sequence(compile_op_sequence(gens, n)) is not None
    jgens = JEnergyQUCC._generators(jops[1])
    assert jgr.group_op_sequence(jcompile_seq(jgens, n)) is not None
    assert EnergyUCC._excitation_indices(ops[1]) \
        == JEnergyQUCC._excitation_indices(jops[1])
    assert [dict(g._terms) for g in gens] == [dict(g._terms) for g in jgens]
    # the MP2 guess up to orbital signs (the port fixes them, see
    # chem/scf.py::fix_mo_phases)
    assert np.allclose(np.abs(ops[3]), np.abs(jops[3]))


@pytest.mark.parametrize("active,pool", [(False, 26), (True, 8)])
def test_main_quccsd(monkeypatch, capsys, active, pool):
    monkeypatch.setattr(EnergyUCC, "get_energies",
                        lambda self, *a, **k: ({}, {}))
    if active:
        from openvqe_tpu_torch.mains.main_quccsd_active_space import main
    else:
        from openvqe_tpu_torch.mains.main_quccsd import main
    main({"device": "cpu"})
    out = capsys.readouterr().out
    assert ("Running in the active case:" in out) == active
    assert f"Pool size:  {pool}" in out
