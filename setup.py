"""Package setup (console entry points mirror the reference: setup.py:27-32)."""

from setuptools import find_packages, setup

# The C++ host kernels (liteasr_tpu/native/liteasr_native.cc) are built on
# demand by liteasr_tpu.native.get_lib() via g++ — a plain C-ABI shared
# object loaded with ctypes, not a CPython extension — so no ext_modules here.
setup(
    name="liteasr_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) end-to-end speech recognition framework",
    packages=find_packages(include=["liteasr_tpu", "liteasr_tpu.*",
                                    "liteasr_tpu_torch", "liteasr_tpu_torch.*"]),
    include_package_data=True,
    package_data={"liteasr_tpu.config": ["yaml/*.yaml", "yaml/*/*.yaml"],
                  "liteasr_tpu_torch": ["csrc/*.cu"],
                  "liteasr_tpu_torch.config": ["yaml/*.yaml", "yaml/*/*.yaml"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "pyyaml"],
    entry_points={
        "console_scripts": [
            "liteasr-train = liteasr_tpu.train:cli_main",
            "liteasr-infer = liteasr_tpu.infer:cli_main",
        ],
    },
)
