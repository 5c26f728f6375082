"""Contextual-subspace scaling plot: Hamiltonian terms vs qubit count
(reference applications/quantum_batteries/plot_cs_scaling.py)."""

from .utils import load_cs_hams


def main(save_path: str = "cs_scaling.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hams = load_cs_hams()
    n_qubits = sorted(hams)
    n_terms = [len(hams[n][0]) + 1 for n in n_qubits]  # + identity term
    plt.plot(n_qubits, n_terms, marker="o")
    plt.xlabel("# qubits")
    plt.ylabel("# Ham terms")
    plt.xticks(n_qubits)
    plt.yticks(n_terms)
    plt.title("Contextual Subspace scaling")
    plt.savefig(save_path)
    plt.close()
    return n_qubits, n_terms


if __name__ == "__main__":
    main()
