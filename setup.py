# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Packaging (capability parity: reference ``setup.py``)."""

import os

from setuptools import Extension, find_packages, setup

# Optional native fastwire extension (C++ via the CPython C API, no
# pybind11); the Python transport is the fallback when it is unavailable.
ext_modules = []
fastwire_src = os.path.join("native", "fastwire.cc")
if os.path.exists(fastwire_src):
    ext_modules.append(
        Extension(
            "rayfed_tpu._fastwire",
            sources=[fastwire_src],
            extra_compile_args=["-O3", "-std=c++17"],
        )
    )

setup(
    name="rayfed-tpu",
    version="0.1.0",
    description=(
        "TPU-native multi-party federated execution framework: "
        "multi-controller programming model, owner-push data perimeter, "
        "party device meshes, collective FedAvg."
    ),
    packages=find_packages(include=["rayfed_tpu", "rayfed_tpu.*",
                                    "rayfed_tpu_torch", "rayfed_tpu_torch.*"]),
    # The PyTorch/CUDA port builds its kernels (nvcc) and its native wire
    # module (the C++ compiler) from these at first use.
    package_data={"rayfed_tpu_torch": ["csrc/*.cu", "csrc/*.cc"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "msgpack",
        "cloudpickle",
        "cryptography",
        "zstandard",
    ],
    extras_require={
        "tpu": ["jax", "optax"],
        "cuda": ["torch"],
        "grpc": ["grpcio"],
        "test": ["pytest"],
    },
    ext_modules=ext_modules,
)
