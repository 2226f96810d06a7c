from setuptools import find_packages, setup

setup(
    name="nupgcm_tpu",
    version="0.1.0",
    description="TPU-native planetary-geostrophic ocean model (JAX/XLA/Pallas)",
    packages=find_packages(include=["nupgcm_tpu", "nupgcm_tpu.*",
                                    "nupgcm_tpu_torch", "nupgcm_tpu_torch.*"]),
    package_data={"nupgcm_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    extras_require={"torch": ["torch"]},
)
