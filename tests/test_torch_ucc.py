"""UCC end to end: VQE.algorithm("ucc", "H2", "sUPCCGSD", "JW", False)
on the port (CPU, float64) and on the JAX package give the same result.

H2/6-31G has 36 cluster generators and an 18-entry pool, and the driver
sizes theta by the pool, so this pins the JAX package's index clamp (the
generators past theta's end rotate by theta[-1]) and its dropped gradient
entries, which the port reproduces on purpose.

Both packages get the same chemistry: the port fixes orbital signs
(chem.scf.fix_mo_phases) and the JAX package's are whatever its eigensolver
returns, and through the clamp the result depends on those signs, so the JAX
MoleculeFactory is handed the port's molecular data.  The chemistry itself
is held against the JAX package's in tests/test_torch_chem.py.
"""

import contextlib
import io

import pytest

from openvqe_tpu.chem import frontend as jax_frontend
from openvqe_tpu.models.molecule_factory import MoleculeFactory
from openvqe_tpu.vqe import VQE
from openvqe_tpu_torch.models.molecule_factory import (
    MoleculeFactory as TMoleculeFactory,
)
from openvqe_tpu_torch.vqe import VQE as TVQE
from torch_threads import one_torch_thread  # noqa: F401

KEYS_EXACT = ("len_op1", "len_op2", "CNOT1", "CNOT2")
KEYS_ENERGY = ("energies1_substracted_from_FCI",
               "energies2_substracted_from_FCI")


@pytest.fixture
def jax_on_port_chemistry(monkeypatch):
    port = TMoleculeFactory()

    def get_molecular_data(self, symbol):
        return jax_frontend.MolecularData(
            **vars(port.get_molecular_data(symbol)))

    monkeypatch.setattr(MoleculeFactory, "get_molecular_data",
                        get_molecular_data)


@pytest.mark.parametrize("taper", [False, True])
def test_ucc_h2_matches_jax(jax_on_port_chemistry, taper):
    opts = {"taper": taper}
    with contextlib.redirect_stdout(io.StringIO()):
        _, ref = VQE.algorithm("ucc", "H2", "sUPCCGSD", "JW", False,
                               dict(opts)).execute()
        _, res = TVQE.algorithm("ucc", "H2", "sUPCCGSD", "JW", False,
                                dict(opts, device="cpu")).execute()
    assert ref["len_op1"] == 18
    for k in KEYS_EXACT:
        assert res[k] == ref[k], k
    for k in KEYS_ENERGY:
        assert abs(res[k] - ref[k]) <= 1e-7, (k, res[k], ref[k])
    assert len(res["energies_1"]) > 1 and len(res["energies_2"]) > 1
