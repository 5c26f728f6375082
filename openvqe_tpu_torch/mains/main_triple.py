"""Standalone triples pool generation with symmetry screening
(reference openvqe/main_triple.py)."""

from openvqe_tpu_torch.ops.generators import apply_transforms, triple_excitation
from openvqe_tpu_torch.ops.screening import HF_sym


def generate(molecule, n_occ, n_spatial_orb, apply_HF_sym, apply_transform):
    ops = triple_excitation(n_spatial_orb, n_occ)
    if apply_HF_sym:
        ops = HF_sym(molecule, n_occ, ops)
    if apply_transform:
        ops = apply_transforms(ops, "JW")[-1]
    return ops


def main():
    ops = generate(molecule="LiH", n_occ=4, n_spatial_orb=6,
                   apply_HF_sym=True, apply_transform=True)
    print(len(ops))
    return ops


if __name__ == "__main__":
    main()
