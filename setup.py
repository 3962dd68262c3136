from setuptools import find_packages, setup

setup(
    name="rad-tpu",
    version="0.3.0",
    description=("Retrieval-augmented docking on the GPU: HNSW over packed "
                 "molecular fingerprints with score-guided traversal "
                 "(JAX/XLA/Pallas)"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["rad_tpu", "rad_tpu.*"]),
    package_data={"rad_tpu.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    extras_require={
        "test": ["pytest"],
        "chem": ["rdkit"],
    },
)
