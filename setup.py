from setuptools import find_packages, setup

setup(
    name="armour_tpu",
    version="0.1.0",
    description=(
        "Receding-horizon safe planning and robust control for "
        "serial manipulators (JAX/XLA)"
    ),
    packages=find_packages(include=["armour_tpu", "armour_tpu.*"]),
    python_requires=">=3.10",
)
