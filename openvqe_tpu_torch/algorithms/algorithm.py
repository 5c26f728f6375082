"""Algorithm base class: configuration, banners, factory wrappers, plots.

API-parity rebuild of reference ``openvqe/algorithms/algorithm.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class Algorithm:

    def __init__(self, molecule_symbol: str, type_of_generator: str,
                 transform: str, active: bool, opts: Optional[Dict] = None):
        self.molecule_symbol = molecule_symbol
        self.type_of_generator = type_of_generator
        self.transform = transform
        self.active = active
        self.opts = dict(opts) if opts else {}
        self.info: Dict = {}
        self.iterations: Dict = {}
        self.result: Dict = {}

    # ---------------------------------------------------------------- flow
    def build_mesh(self):
        """``parallel.sharded.Mesh`` of opts["mesh_devices"] ranks (the
        process group ``torchrun`` starts; on opts["device"] if given);
        None = single device."""
        nd = self.opts.get("mesh_devices")
        if not nd:
            return None
        from ..parallel.sharded import make_mesh
        return make_mesh(int(nd), device=self.opts.get("device"))

    def presentation(self, molecule_factory):
        r, geometry, charge, spin, basis = molecule_factory.get_parameters(
            self.molecule_symbol)
        print(" --------------------------------------------------------------------------")
        if self.active:
            print("Running in the active case: ")
        else:
            print("Running in the non active case: ")
        print("molecule symbol: %s " % self.molecule_symbol)
        print("molecule basis: %s " % basis)
        print("type of generator: %s " % self.type_of_generator)
        print("transform: %s " % self.transform)
        print("options: %s " % self.opts)
        print(" --------------------------------------------------------------------------")

    def generate_hamiltonian(self, molecule_factory):
        print(" --------------------------------------------------------------------------")
        print("                      Generate Hamiltonians and Properties from :")
        print(" --------------------------------------------------------------------------")
        res = molecule_factory.generate_hamiltonian(
            self.molecule_symbol, active=self.active, transform=self.transform)
        print(f"Hamiltonian info {res[-1]}")
        return res

    def generate_cluster_ops(self, molecule_factory):
        print(" --------------------------------------------------------------------------")
        print("                      Generate Cluster OPS:")
        print(" --------------------------------------------------------------------------")
        args = molecule_factory.generate_cluster_ops(
            self.molecule_symbol, type_of_generator=self.type_of_generator,
            transform=self.transform, active=self.active)
        print("Pool size: ", args[0])
        print("length of the cluster OP: ", len(args[1]))
        print("length of the cluster OPS: ", len(args[2]))
        return args

    def execute(self):  # pragma: no cover - abstract
        raise NotImplementedError

    # ---------------------------------------------------------------- plots
    def energy_list(self):
        return self.result["energies_1"], self.result["energies_2"]

    def plot_energy_result(self, save_path: Optional[str] = None, show: bool = False):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        energies_1, energies_2 = self.energy_list()
        plt.figure(figsize=(14, 8))
        plt.plot(energies_1, "-o", color="orange", label="Energies Cluster operators")
        plt.plot(energies_2, "-o", color="red", label="Pool generators")
        plt.plot([self.info["FCI"]] * max(len(energies_1), len(energies_2)),
                 "k--", label="True ground state energy(FCI)")
        plt.xlabel("Optimization step", fontsize=20)
        plt.ylabel("Energy (Ha)", fontsize=20)
        plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left", fontsize=12)
        plt.grid()
        plt.title(f"Energy evolution of {type(self).__name__} on "
                  f"{self.molecule_symbol} molecule", fontsize=20)
        plt.tight_layout()
        if save_path:
            plt.savefig(save_path)
        if show:  # pragma: no cover
            plt.show()
        plt.close()

    def plot_error_result(self, save_path: Optional[str] = None, show: bool = False):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        energies_1, energies_2 = self.energy_list()
        err1 = np.maximum(np.asarray(energies_1) - self.info["FCI"], 1e-16)
        err2 = np.maximum(np.asarray(energies_2) - self.info["FCI"], 1e-16)
        plt.figure(figsize=(14, 8))
        plt.plot(err1, "-o", color="orange", label="Energies Cluster operators")
        plt.plot(err2, "-o", color="red", label="Pool generators")
        plt.fill_between(np.arange(0, max(len(energies_1), len(energies_2))),
                         min(err1.min(), err2.min()), 1e-3, color="cadetblue",
                         alpha=0.2, label="Chemical Accuracy")
        plt.yscale("log")
        plt.xlabel("Optimization step", fontsize=20)
        plt.ylabel("Energy (Ha)", fontsize=20)
        plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left", fontsize=12)
        plt.grid()
        plt.title(f"Error on log scale for {type(self).__name__} on "
                  f"{self.molecule_symbol} molecule", fontsize=20)
        plt.tight_layout()
        if save_path:
            plt.savefig(save_path)
        if show:  # pragma: no cover
            plt.show()
        plt.close()
