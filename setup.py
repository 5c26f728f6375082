from setuptools import find_packages, setup

setup(
    name="openvqe_tpu",
    version="0.1.0",
    description="TPU-native variational quantum eigensolver framework "
                "(OpenVQE capabilities rebuilt on JAX/XLA)",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "openvqe_tpu.apps.quantum_batteries": ["cs_hams.json"],
        "openvqe_tpu.native": ["eri.cpp", "Makefile"],
        "openvqe_tpu_torch.apps.quantum_batteries": ["cs_hams.json",
                                                     "cs_hams_native.json"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "optax", "numpy", "scipy"],
    extras_require={"plots": ["matplotlib"], "test": ["pytest"]},
)
