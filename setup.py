from setuptools import setup, find_packages

setup(
    name="xpoint_tpu",
    version="0.1.0",
    description=("TPU-native JAX/XLA/Pallas framework for self-supervised "
                 "multispectral image registration"),
    packages=find_packages(include=["xpoint_tpu", "xpoint_tpu.*",
                                    "xpoint_tpu_torch", "xpoint_tpu_torch.*"]),
    package_data={"xpoint_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "einops",
        "numpy", "opencv-python", "h5py", "pyyaml", "scipy", "tqdm",
    ],
    extras_require={
        "logging": ["tensorboardX"],
        "compat": ["torch"],          # only for converting reference checkpoints
    },
)
