"""Typed run configuration.

The reference scatters configuration across positional args, per-algorithm
default dicts, and hard-coded constants (SURVEY.md §5 'Config / flag
system').  This single dataclass covers molecule, generator, transform,
pool, optimizer, device/mesh and auxiliary options, and dispatches through
the same ``VQE`` registry.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional


@dataclass
class VQEConfig:
    # problem
    algorithm: str = "ucc"               # ucc | quccsd | fermionic_adapt | qubit_adapt
    molecule: str = "H2"
    generator: str = "sUPCCGSD"
    transform: str = "JW"                # JW | Bravyi-Kitaev | parity
    active: bool = False

    # pools
    pool_condition: str = "reduced_without_Z"   # UCC qubit pool
    qubit_pool_type: str = "random"             # qubit-ADAPT pool
    pool_seed: Optional[int] = None

    # optimization
    optimizer: Optional[str] = None      # per-algorithm default when None
    tolerance: Optional[float] = None
    n_max_grads: int = 1
    max_external_iterations: Optional[int] = None
    threshold_needed: Optional[float] = None

    # runtime
    taper: bool = False                  # exact ansatz-compatible Z2 taper
    mesh_devices: Optional[int] = None   # shard the state over a device mesh
    checkpoint_path: Optional[str] = None
    log_path: Optional[str] = None
    fidelity_max_qubits: int = 20

    extra_opts: Dict[str, Any] = field(default_factory=dict)

    def to_opts(self) -> Dict[str, Any]:
        opts: Dict[str, Any] = dict(self.extra_opts)
        for key in ("optimizer", "tolerance", "max_external_iterations",
                    "threshold_needed"):
            val = getattr(self, key)
            if val is not None:
                opts[key] = val
        opts["n_max_grads"] = self.n_max_grads
        if self.pool_seed is not None:
            opts["pool_seed"] = self.pool_seed
        if self.taper:
            opts["taper"] = True
        if self.mesh_devices:
            opts["mesh_devices"] = self.mesh_devices
        if self.checkpoint_path:
            opts["checkpoint_path"] = self.checkpoint_path
        if self.log_path:
            opts["log_path"] = self.log_path
        return opts

    def build(self):
        from .vqe import VQE
        return VQE.algorithm(self.algorithm, self.molecule, self.generator,
                             self.transform, self.active, self.to_opts())

    def run(self):
        return self.build().execute()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VQEConfig":
        known = {f for f in cls.__dataclass_fields__}
        extra = {k: v for k, v in d.items() if k not in known}
        base = {k: v for k, v in d.items() if k in known}
        cfg = cls(**base)
        cfg.extra_opts.update(extra)
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)
