"""Entry point (reference openvqe/main_quccsd_active_space.py): QUCCSD on
H4 under JW in the active space, on the default device."""

from openvqe_tpu_torch.vqe import VQE


def main(opts=None):
    return VQE.algorithm("quccsd", "H4", "QUCCSD", "JW", True,
                         opts).execute()


if __name__ == "__main__":
    main()
