"""Entry point (reference openvqe/main_qubit_adapt.py): qubit ADAPT-VQE on
H2 with the singlet_gsd cluster pool, on the default device."""

from openvqe_tpu_torch.vqe import VQE


def main(opts=None):
    return VQE.algorithm("qubit_adapt", "H2", "singlet_gsd", "JW", False,
                         opts).execute()


if __name__ == "__main__":
    main()
