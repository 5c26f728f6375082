"""The port's VQEObjective / BoundAnsatz against the JAX package's on the
CPU in float64: H4 sUPCCGSD, operands carried across by
openvqe_tpu_torch/sim/convert.py.  Energy, gradient and state agree to
1e-10.  Also pins the device policy and what the slice leaves out."""

import numpy as np
import pytest
import torch

from openvqe_tpu.models.molecule_factory import MoleculeFactory
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim import statevector as jsv
from openvqe_tpu.sim.compile import compile_op_sequence
from openvqe_tpu.sim.objective import VQEObjective
from openvqe_tpu_torch.ops.pauli import PauliSum as TPauliSum
from openvqe_tpu_torch.sim import statevector as tsv
from openvqe_tpu_torch.sim.objective import VQEObjective as TVQEObjective
from torch_threads import one_torch_thread  # noqa: F401


def port_ps(ps):
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


@pytest.fixture(scope="module")
def h4_supccgsd():
    mf = MoleculeFactory()
    ham, hsp, n_elec, noons, orb_e, info = mf.generate_hamiltonian(
        "H4", display=False)
    gens = [op * 1j for op in
            mf.generate_cluster_ops("H4", "sUPCCGSD", "JW")[2]]
    hf = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf, hsp.nbqbits, "JW")
    jobj = VQEObjective(hsp)
    return hsp, gens, hf_sp, info, jobj, jobj.bind(gens, hf_sp)


def _thetas(n_ops):
    rng = np.random.default_rng(11)
    # full length, and shorter than the ansatz (the UCC driver's clamp)
    return [rng.normal(scale=0.3, size=n_ops),
            rng.normal(scale=0.3, size=n_ops // 2)]


def test_objective_matches_jax_through_convert(h4_supccgsd):
    hsp, gens, hf_sp, _, jobj, jb = h4_supccgsd
    n = hsp.nbqbits
    tobj = TVQEObjective.from_grouped(jobj.gham, device="cpu")
    # the JAX bind pads to a bucket with x = 0 identity groups; the port
    # drops them
    gseq = jgr.group_op_sequence(compile_op_sequence(gens, n))
    G, K = gseq.z.shape
    padded = jgr.pad_grouped_sequence(gseq, jsv.bucket_size(G), max(K, 8))
    assert padded.n_groups > G
    tb = tobj.bind_grouped(padded, hf_sp)
    assert len(tb._ops.x) == G
    for theta in _thetas(len(gens)):
        je, jg = jb.energy_and_grad(theta)
        te, tg = tb.energy_and_grad(theta)
        assert abs(je - te) < 1e-10
        np.testing.assert_allclose(tg, jg, atol=1e-10)
        assert abs(jb.energy(theta) - tb.energy(theta)) < 1e-10
        np.testing.assert_allclose(tb.forward(theta).numpy(),
                                   np.asarray(jb.forward(theta)), atol=1e-10)


def test_objective_services_match_jax(h4_supccgsd):
    hsp, gens, hf_sp, info, jobj, jb = h4_supccgsd
    tobj = TVQEObjective(port_ps(hsp), device="cpu")
    tb = tobj.bind([port_ps(g) for g in gens], hf_sp)
    assert tobj.dtype == torch.float64
    theta = _thetas(len(gens))[0]
    psi = np.asarray(jb.forward(theta))
    np.testing.assert_allclose(tobj.ham_apply(psi).numpy(),
                               np.asarray(jobj.ham_apply(psi)), atol=1e-10)
    assert abs(tobj.expectation(psi) - jobj.expectation(psi)) < 1e-10
    # at theta = 0 the ansatz state is |HF>
    assert abs(tb.energy(np.zeros(len(gens))) - info["HF"]) < 1e-10
    fun, jac = tb.scipy_fun_jac()
    e, g = jb.energy_and_grad(theta)
    assert abs(fun(theta) - e) < 1e-10
    np.testing.assert_allclose(jac(theta), g, atol=1e-10)


def test_cuda_requested_without_cuda_raises(h4_supccgsd):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    hsp = port_ps(h4_supccgsd[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        TVQEObjective(hsp)                      # the default is CUDA
    with pytest.raises(RuntimeError, match="CUDA"):
        TVQEObjective(hsp, device="cuda")


def test_float64_on_cuda_is_not_implemented():
    with pytest.raises(NotImplementedError):
        tsv.resolve_dtype(torch.device("cuda"), torch.float64)
    assert tsv.resolve_dtype(torch.device("cuda")) == torch.float32
    assert tsv.resolve_dtype(torch.device("cpu")) == torch.float64


def test_out_of_slice_paths_raise(h4_supccgsd):
    hsp = port_ps(h4_supccgsd[0])
    n = hsp.nbqbits
    tobj = TVQEObjective(hsp, device="cpu")
    even_y = TPauliSum.from_term(n, 1.0, "XX", [0, 1])   # not odd-Y
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tobj.bind([even_y], 0)
    from openvqe_tpu_torch.algorithms.energy_ucc import build_vqe_objective
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_vqe_objective(hsp, [], 0, mesh=object(), device="cpu")
    from openvqe_tpu_torch.vqe import VQE
    with pytest.raises(KeyError, match="ROADMAP"):
        VQE.algorithm("quccsd", "H4", "spin_complement_gsd", "JW", False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VQE.algorithm("ucc", "H2", "sUPCCGSD", "JW", False,
                      {"mesh_devices": 2}).build_mesh()
