"""Entry point (reference openvqe/main_quccsd.py): QUCCSD on H4 under JW,
non-active space, on the default device."""

from openvqe_tpu_torch.vqe import VQE


def main(opts=None):
    return VQE.algorithm("quccsd", "H4", "QUCCSD", "JW", False,
                         opts).execute()


if __name__ == "__main__":
    main()
