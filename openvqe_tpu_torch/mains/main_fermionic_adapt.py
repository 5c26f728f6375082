"""Entry point (reference openvqe/main_fermionic_adapt.py): fermionic
ADAPT-VQE on H4, non-active then active, on the default device."""

from openvqe_tpu_torch.vqe import VQE


def main(opts=None):
    VQE.algorithm("fermionic_adapt", "H4", "spin_complement_gsd", "JW",
                  False, opts).execute()
    VQE.algorithm("fermionic_adapt", "H4", "spin_complement_gsd", "JW",
                  True, opts).execute()


if __name__ == "__main__":
    main()
