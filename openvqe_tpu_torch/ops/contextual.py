"""Contextual-subspace VQE machinery (noncontextual splits, classical
noncontextual ground states, stabilizer-subspace projection).

Native equivalent of the symmer pipeline the reference's battery
application drives from a notebook (contextual_subspace.ipynb cells 35-36:
``ContextualSubspace(ham, ...).project_onto_subspace()``), built directly
on the symplectic Pauli IR.

Noncontextual structure (Kirby & Love, PRL 123, 200501): a term set S is
noncontextual when, after removing Z^bar (the terms commuting with all of
S), commutation on the remainder is an equivalence relation — the remainder
splits into cliques that mutually commute inside and pairwise anticommute
across.  The classical model assigns

    <P> = sign_P * prod_i q_i^{e_Pi}            for P in the Z^bar closure
    <m> = <d_m> * r_j       with  m = d_m * C_j for clique-j members

where the G_i are independent generators of the abelian group generated by
Z^bar and the clique-internal quotients d_m, q in {+-1}^k, and r a unit
vector over cliques; minimizing in r gives the Kirby-Love closed form

    E(q) = sum_{Z^bar} a_P <P>  -  sqrt( sum_j ( sum_{m in C_j} a_m <d_m> )^2 )

All generator decompositions carry exact +-1 phases (Hermitian Pauli
products tracked on the symplectic masks — validated against dense
diagonalization: the classical optimum EQUALS the true ground energy of the
noncontextual sub-Hamiltonian, tests/test_contextual.py).

The CONTEXTUAL SUBSPACE projection enforces chosen generators as
stabilizers at their optimal q values: each is Clifford-rotated onto a
single-qubit X (ops/tapering.py machinery), anticommuting terms are dropped
(the controlled approximation), commuting terms get the eigenvalue
substituted and the qubit removed.  Enforcing zero stabilizers is exact and
the projected ground energy is variational (a restriction of H to a
subspace).

Delta vs symmer (documented): clique operators are not re-stabilized via
unitary partitioning — only the abelian generators are enforced.  The
battery application's shipped Hamiltonians (derived with the full symmer
pipeline) are unaffected; this module is the framework's own derivation
capability, exercised on the molecular stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pauli import PauliSum, _popcount
from .tapering import clifford_conjugate


Key = Tuple[int, int]


def _commutes(a: Key, b: Key) -> bool:
    return (_popcount(a[0] & b[1]) + _popcount(a[1] & b[0])) % 2 == 0


def _hermitian_coeff(key: Key, c_xz: complex) -> float:
    """Coefficient of the Hermitian unit Pauli i^{nY} X^x Z^z."""
    ny = _popcount(key[0] & key[1]) % 4
    return float(np.real(c_xz * (-1j) ** ny))


def _herm_mul(a: Key, b: Key) -> Tuple[Key, float]:
    """Product of two Hermitian unit Paulis: A_hat B_hat = phase * M_hat.
    For commuting operands the phase is +-1 (real)."""
    x, z = a[0] ^ b[0], a[1] ^ b[1]
    ny = (_popcount(a[0] & a[1]) + _popcount(b[0] & b[1])
          - _popcount(x & z)) % 4
    phase = (1j) ** ny * (-1.0) ** (_popcount(a[1] & b[0]) % 2)
    return (x, z), complex(phase)


def is_noncontextual(keys: Sequence[Key]) -> bool:
    """General Kirby-Love test."""
    keys = list(keys)
    zbar = [k for k in keys if all(_commutes(k, o) for o in keys)]
    rest = [k for k in keys if k not in zbar]
    cliques: List[List[Key]] = []
    for k in rest:
        home = None
        for cl in cliques:
            if _commutes(k, cl[0]):
                home = cl
                break
        if home is not None:
            if not all(_commutes(k, m) for m in home):
                return False
            home.append(k)
        else:
            cliques.append([k])
    for i, ci in enumerate(cliques):
        for cj in cliques[i + 1:]:
            for a in ci:
                for b in cj:
                    if _commutes(a, b):
                        return False
    return True


class AbelianBasis:
    """Phase-tracked GF(2) basis of an abelian Pauli group: decomposes any
    group element into generator exponents with an exact +-1 sign."""

    def __init__(self):
        self.gens: List[Key] = []        # pivot-reduced Hermitian units

    def _reduce(self, key: Key) -> Tuple[Key, float, int]:
        """Multiply out generators in strictly descending pivot order
        (each generator's top symplectic bit is unique by construction, so
        the residual's top bit strictly decreases and the loop terminates).
        Returns (residual, sign, exponent mask)."""
        sign = 1.0
        mask = 0
        by_pivot = {self._pivot(g): i for i, g in enumerate(self.gens)}
        while key != (0, 0):
            i = by_pivot.get(self._pivot(key))
            if i is None:
                break
            key, ph = _herm_mul(key, self.gens[i])
            assert abs(ph.imag) < 1e-12, "non-abelian product"
            sign *= ph.real
            mask ^= 1 << i
        return key, sign, mask

    @staticmethod
    def _pivot(key: Key) -> int:
        v = key[0] | (key[1] << 64)
        return v.bit_length() - 1

    def decompose(self, key: Key) -> Optional[Tuple[int, float]]:
        """(exponent mask, sign) if key is in the group, else None (the
        basis is NOT extended)."""
        res, sign, mask = self._reduce(key)
        if res == (0, 0):
            return mask, sign
        return None

    def add(self, key: Key) -> Optional[Tuple[int, float]]:
        """Decompose key, extending the basis when independent; returns the
        (mask, sign) decomposition, or None if key does not commute with the
        existing generators (non-abelian extension refused)."""
        if any(not _commutes(key, g) for g in self.gens):
            return None
        res, sign, mask = self._reduce(key)
        if res == (0, 0):
            return mask, sign
        self.gens.append(res)
        return mask | (1 << (len(self.gens) - 1)), sign


@dataclass
class NoncontextualStructure:
    """Kirby-Love structure with generator-decomposed terms."""
    basis: AbelianBasis
    # Z^bar terms: (exponent mask, sign, hermitian coeff)
    zbar: List[Tuple[int, float, float]]
    # cliques: representative key + members as (mask, sign, coeff)
    reps: List[Key]
    cliques: List[List[Tuple[int, float, float]]]
    selected: List[Key]
    remainder: List[Key]

    @property
    def n_generators(self) -> int:
        return len(self.basis.gens)


def noncontextual_split(ps: PauliSum, max_generators: int = 22
                        ) -> NoncontextualStructure:
    """Greedy noncontextual selection by decreasing |coefficient| under the
    general Kirby-Love test, restricted to sets whose (Z^bar + clique
    quotient) group stays abelian and within ``max_generators`` (the
    classical solver enumerates 2^k configurations)."""
    items = sorted(ps, key=lambda kv: -abs(kv[1]))
    selected: List[Key] = []
    remainder: List[Key] = []
    for k, _ in items:
        if is_noncontextual(selected + [k]):
            selected.append(k)
        else:
            remainder.append(k)

    # classify the final set
    zbar_keys = [k for k in selected
                 if all(_commutes(k, o) for o in selected)]
    rest = [k for k in selected if k not in zbar_keys]
    clique_keys: List[List[Key]] = []
    for k in rest:
        for cl in clique_keys:
            if _commutes(k, cl[0]):
                cl.append(k)
                break
        else:
            clique_keys.append([k])

    basis = AbelianBasis()
    zbar: List[Tuple[int, float, float]] = []
    dropped: List[Key] = []
    for k in zbar_keys:
        dec = basis.add(k)
        if dec is None or len(basis.gens) > max_generators:
            dropped.append(k)
            continue
        zbar.append((dec[0], dec[1], _hermitian_coeff(k, ps._terms[k])))
    reps: List[Key] = []
    cliques: List[List[Tuple[int, float, float]]] = []
    for cl in clique_keys:
        rep = cl[0]
        members: List[Tuple[int, float, float]] = []
        ok = True
        for k in cl:
            d, ph = _herm_mul(k, rep)      # k_hat = ph^-1 ... d * rep
            if abs(ph.imag) > 1e-12:
                ok = False
                break
            dec = basis.add(d)
            if dec is None or len(basis.gens) > max_generators:
                ok = False
                break
            members.append((dec[0], dec[1] * ph.real,
                            _hermitian_coeff(k, ps._terms[k])))
        if ok:
            reps.append(rep)
            cliques.append(members)
        else:
            dropped.extend(cl)
    if dropped:
        remainder = remainder + dropped
        selected = [k for k in selected if k not in dropped]
    return NoncontextualStructure(basis=basis, zbar=zbar, reps=reps,
                                  cliques=cliques, selected=selected,
                                  remainder=remainder)


@dataclass
class NoncontextualSolution:
    energy: float
    q: np.ndarray                    # optimal generator eigenvalues (+-1)
    flip_costs: np.ndarray           # penalty of flipping each generator
    structure: NoncontextualStructure
    r: Optional[np.ndarray] = None   # optimal clique unit vector at the
    #                                  optimum (<C_j_hat> = r_j); None when
    #                                  there are no cliques or the clique
    #                                  weight vanishes at the optimum


def noncontextual_energy(ps: PauliSum,
                         structure: Optional[NoncontextualStructure] = None
                         ) -> NoncontextualSolution:
    """Classical optimum over generator assignments q (exhaustive) and the
    clique unit vector r (closed form: E = sum zbar - |w|, attained at
    r = -w / |w| where w_j = sum_{m in C_j} a_m <d_m>)."""
    if structure is None:
        structure = noncontextual_split(ps)
    k = structure.n_generators
    cfg = np.arange(1 << k, dtype=np.int64)

    def val(mask, sign):
        return sign * (1.0 - 2.0 * (np.bitwise_count(
            cfg & np.int64(mask)) % 2).astype(np.float64))

    e = np.full(1 << k, float(np.real(ps.constant_coeff)))
    for mask, sign, a in structure.zbar:
        e += a * val(mask, sign)
    w2 = np.zeros(1 << k)
    w_cols = []
    for members in structure.cliques:
        wj = np.zeros(1 << k)
        for mask, sign, a in members:
            wj += a * val(mask, sign)
        w_cols.append(wj)
        w2 += wj * wj
    e = e - np.sqrt(w2)
    best = int(np.argmin(e))
    e_best = float(e[best])
    flips = np.array([float(e[best ^ (1 << i)]) - e_best for i in range(k)])
    q = 1.0 - 2.0 * ((best >> np.arange(k)) & 1)
    r = None
    if w_cols:
        w_best = np.array([float(wj[best]) for wj in w_cols])
        nrm = float(np.linalg.norm(w_best))
        if nrm > 1e-12:
            r = -w_best / nrm
    return NoncontextualSolution(energy=e_best, q=q, flip_costs=flips,
                                 structure=structure, r=r)


# -------------------------------------------------- stabilizer projection

def _herm_unit(n: int, key: Key, scale: float = 1.0) -> PauliSum:
    """1-term PauliSum of scale * the Hermitian unit Pauli i^{nY} X^x Z^z."""
    return PauliSum(n, {key: scale * (1j) ** (_popcount(key[0] & key[1])
                                              % 4)})


@dataclass
class ContextualSubspace:
    """Enforce noncontextual generators as stabilizers and project
    (reference analog: symmer ContextualSubspace.project_onto_subspace,
    driven at contextual_subspace.ipynb cell 36).

    ``clique_strategy``:

    * ``"none"`` — enforce abelian symmetry generators only (stabilizer
      projection).
    * ``"lcu"`` — symmer's ``unitary_partitioning_method='LCU'``
      (notebook cell 36): ALSO enforce the noncontextual clique operator
      A(r) = sum_j r_j C_j_hat (pairwise-anticommuting Hermitian unit
      cliques, A^2 = I, <A> = +1 at the classical optimum) by first
      conjugating H with the exact LCU rotation

          R = (I + s C_w_hat A) / sqrt(2 (1 + s r_w)),   s = sign(r_w),
          R A R^dag = s C_w_hat            (w = argmax_j |r_j|)

      and then enforcing s*C_w_hat as the FIRST stabilizer.  This is the
      channel for the noncontextual correlation energy the
      stabilizer-only projection leaves out.
    """
    ps: PauliSum
    solution: NoncontextualSolution
    clique_strategy: str = "none"

    @classmethod
    def build(cls, ps: PauliSum,
              clique_strategy: str = "none") -> "ContextualSubspace":
        if clique_strategy not in ("none", "lcu"):
            raise ValueError(f"unknown clique_strategy {clique_strategy!r}")
        return cls(ps=ps, solution=noncontextual_energy(ps),
                   clique_strategy=clique_strategy)

    def _enforced(self, n_target: int) -> List[Tuple[Key, float]]:
        """(generator key, sector) pairs in enforcement order (decreasing
        flip cost), in the ORIGINAL qubit indexing."""
        n = self.ps.nbqbits
        gens = self.solution.structure.basis.gens
        if not 0 < n_target <= n:
            raise ValueError(f"n_target must be in (0, {n}]")
        budget = n - n_target
        if self.clique_strategy == "lcu" and self._clique() is not None:
            budget -= 1                  # the clique stabilizer goes first
        n_enforce = min(max(budget, 0), len(gens))
        order = np.argsort(-self.solution.flip_costs)
        return [(gens[int(i)], float(self.solution.q[int(i)]))
                for i in order[:n_enforce]]

    def _clique(self) -> Optional[Tuple[PauliSum, Key, float]]:
        """(R, C_w key, sector s) of the LCU unitary-partitioning rotation,
        or None when the noncontextual solution has no clique weight.
        Cached: solution/strategy are fixed after build(), and the
        O(n_cliques^2) products + unitarity self-checks would otherwise
        rerun 2-3x per projection and once per target in derivation
        loops."""
        if not hasattr(self, "_clique_cache"):
            self._clique_cache = self._build_clique()
        return self._clique_cache

    def _build_clique(self) -> Optional[Tuple[PauliSum, Key, float]]:
        sol = self.solution
        reps = sol.structure.reps
        if sol.r is None or not reps:
            return None
        n = self.ps.nbqbits
        w = int(np.argmax(np.abs(sol.r)))
        s = 1.0 if sol.r[w] >= 0 else -1.0
        a_op = PauliSum(n)
        for rj, rep in zip(sol.r, reps):
            a_op = a_op + _herm_unit(n, rep, float(rj))
        r_lcu = (_herm_unit(n, reps[w], s) * a_op + 1.0) \
            / float(np.sqrt(2.0 * (1.0 + s * sol.r[w])))
        # exact algebraic self-checks (cheap: n_cliques^2 terms):
        # R is unitary and R A R^dag = s C_w_hat
        unit = (r_lcu * r_lcu.dagger()).prune(1e-10)
        assert len(unit) == 0 and abs(unit.constant_coeff - 1.0) < 1e-9, \
            "LCU rotation is not unitary"
        rot_a = (r_lcu * a_op * r_lcu.dagger()).prune(1e-10)
        tgt = _herm_unit(n, reps[w], s)
        assert len((rot_a - tgt).prune(1e-9)) == 0, \
            "LCU rotation failed to map A onto its clique representative"
        return r_lcu, reps[w], s

    def project_onto_subspace(self, n_target: int) -> PauliSum:
        """CS Hamiltonian on n_target qubits (fewer reductions if the
        stabilizer pool runs out): rotate each enforced stabilizer onto a
        single-qubit Pauli, drop anticommuting terms, substitute the
        eigenvalue, remove the qubit.

        Every pending stabilizer is carried through each rotation +
        qubit-removal step IN THE CURRENT INDEXING (conjugation preserves
        the commutation structure, so later stabilizers stay single-Pauli
        and pivot-compatible).  The result equals the dense restriction
        P H P of H to the joint stabilizer eigenspace
        (tests/test_contextual.py::test_projection_equals_dense_restriction).
        """
        h = self.ps
        n = self.ps.nbqbits
        # pending stabilizers as 1-term PauliSums P with <P> = +1 enforced
        pending: List[PauliSum] = []
        if self.clique_strategy == "lcu" and n_target < n:
            cl = self._clique()
            if cl is not None:
                r_lcu, rep_w, s = cl
                # R H R^dag depends only on (ps, solution) — cache it so
                # derivation loops over many n_target don't redo the
                # full 3-factor PauliSum conjugation per target
                if not hasattr(self, "_rotated_h_cache"):
                    self._rotated_h_cache = (
                        r_lcu * h * r_lcu.dagger()).prune(1e-12)
                h = self._rotated_h_cache
                # abelian generators commute with every clique rep, hence
                # with R: they are invariant under this conjugation
                pending.append(_herm_unit(n, rep_w, s))
        for gkey, qval in self._enforced(n_target):
            pending.append(_herm_unit(n, gkey, qval))

        while pending:
            p_ps = pending.pop(0)
            ((x, z), coeff), = list(p_ps)
            sector = _hermitian_coeff((x, z), coeff)
            assert abs(abs(sector) - 1.0) < 1e-9, "stabilizer lost unit norm"
            gkey = (x, z)
            if z:                       # a Y/Z site: target X_piv there
                piv = (z & -z).bit_length() - 1
                target = (1 << piv, 0)
            else:                       # pure-X generator: target Z_piv
                piv = (x & -x).bit_length() - 1
                target = (0, 1 << piv)
            if gkey != target:
                # A ~ i G_hat T_hat (Hermitian, anticommutes with both):
                # exp(+-i pi/4 A) maps G -> +-T
                (ax, az), _ = _herm_mul(gkey, target)
                rot = clifford_conjugate(_herm_unit(h.nbqbits, gkey),
                                         ax, az)
                ((rx, rz), rc), = list(rot)
                assert (rx, rz) == target, "stabilizer rotation failed"
                h = clifford_conjugate(h, ax, az)
                pending = [clifford_conjugate(p, ax, az) for p in pending]
                sector = sector * float(np.sign(rc.real))
            axis = "x" if target[0] else "z"
            h = _project_pauli(h, piv, sector, axis)
            nxt: List[PauliSum] = []
            for p in pending:
                q = _project_pauli(p, piv, sector, axis)
                items = list(q)
                assert len(items) == 1, \
                    "dependent stabilizer eliminated by projection"
                nxt.append(q)
            pending = nxt
        return h

    def project_state_energy(self, n_target: int) -> float:
        import numpy.linalg as la
        h = self.project_onto_subspace(n_target)
        return float(la.eigvalsh(h.to_matrix())[0])


def _project_pauli(ps: PauliSum, q: int, sector: float,
                   axis: str) -> PauliSum:
    """Project onto the sector of X_q (axis='x') or Z_q (axis='z'): drop
    anticommuting terms, substitute the eigenvalue, remove qubit q."""
    n = ps.nbqbits
    keep = [qq for qq in range(n) if qq != q]
    pos = {qq: i for i, qq in enumerate(keep)}
    out = PauliSum(n - 1, {}, ps.constant_coeff)
    bit = 1 << q
    for (x, z), c in ps:
        anti = (z & bit) if axis == "x" else (x & bit)
        if anti:
            continue
        hit = (x & bit) if axis == "x" else (z & bit)
        coeff = c * (sector if hit else 1.0)
        nx = nz = 0
        for qq in keep:
            b = 1 << qq
            if x & b:
                nx |= 1 << pos[qq]
            if z & b:
                nz |= 1 << pos[qq]
        if nx == 0 and nz == 0:
            out.constant_coeff += coeff
        else:
            out._iadd_term((nx, nz), coeff)
    return out


def _project_x(ps: PauliSum, q: int, sector: float) -> PauliSum:
    return _project_pauli(ps, q, sector, "x")


def _project_z(ps: PauliSum, q: int, sector: float) -> PauliSum:
    return _project_pauli(ps, q, sector, "z")


def derive_contextual_hamiltonians(ps: PauliSum,
                                   qubit_counts: Sequence[int]
                                   ) -> Dict[int, PauliSum]:
    """CS Hamiltonians for a range of target qubit counts — the shape of
    the reference's derivation loop (contextual_subspace.ipynb cell 36)."""
    cs = ContextualSubspace.build(ps)
    return {int(q): cs.project_onto_subspace(int(q)) for q in qubit_counts}
