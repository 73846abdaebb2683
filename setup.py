"""Packaging for elasticdl_tpu (reference bundles three pip packages;
this single package exposes the same CLI surface via the `edl` entrypoint).
"""

from setuptools import find_packages, setup

setup(
    name="elasticdl_tpu",
    version="0.1.0",
    description=(
        "Elastic, fault-tolerant distributed deep learning on TPUs "
        "(JAX/XLA) with dynamic data sharding"
    ),
    packages=find_packages(include=["elasticdl_tpu", "elasticdl_tpu.*",
                                    "elasticdl_tpu_torch",
                                    "elasticdl_tpu_torch.*"]),
    package_data={"elasticdl_tpu.proto": ["*.proto"],
                  "elasticdl_tpu.native": ["*.cc", "Makefile"],
                  "elasticdl_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"],
                  "elasticdl_tpu_torch.native": ["*.cc"],
                  "elasticdl_tpu_torch.proto": ["*.proto"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "grpcio",
        "protobuf",
        "ml_dtypes",
    ],
    extras_require={"k8s": ["kubernetes"]},
    entry_points={
        "console_scripts": ["edl=elasticdl_tpu.client.main:main"],
    },
)
