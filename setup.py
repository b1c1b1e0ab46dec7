"""Packaging for euler_tpu (reference analog: tools/pip/setup.py +
tools/pip/build_wheel.sh, which ship the C++ engine inside a binary
wheel). The native graph engine is compiled by `make` during build_py so
wheels carry libeuler_graph.so; source installs can also rebuild it
lazily on first import (euler_tpu/graph/native.py build_native)."""

import os
import subprocess
import sys

import setuptools
from setuptools.command.build_py import build_py as _build_py

_ROOT = os.path.dirname(os.path.abspath(__file__))
_NATIVE = os.path.join(_ROOT, "euler_tpu", "graph", "_native")


class build_py(_build_py):
    def run(self):
        try:
            subprocess.run(["make", "-s", "-j"], cwd=_NATIVE, check=True)
        except (OSError, subprocess.CalledProcessError) as e:
            # no toolchain at build time: ship sources only — the
            # package rebuilds lazily on first import (native.py
            # build_native), provided make/g++ exist at runtime
            print(
                f"warning: native engine build skipped ({e}); "
                "libeuler_graph.so will be built on first import",
                file=sys.stderr,
            )
        super().run()


cmdclass = {"build_py": build_py}
try:
    from wheel.bdist_wheel import bdist_wheel as _bdist_wheel

    class bdist_wheel(_bdist_wheel):
        def finalize_options(self):
            super().finalize_options()
            self.root_is_pure = False  # carries a compiled .so

    cmdclass["bdist_wheel"] = bdist_wheel
except ImportError:  # building an sdist without wheel installed
    pass


def _version() -> str:
    # single source: euler_tpu/__init__.py __version__ (regex-read — the
    # package is not importable at build time without jax installed)
    import re

    with open(os.path.join(_ROOT, "euler_tpu", "__init__.py")) as f:
        return re.search(
            r'^__version__ = "([^"]+)"', f.read(), re.M
        ).group(1)


setuptools.setup(
    name="euler-tpu",
    version=_version(),
    description=(
        "TPU-native graph learning framework: C++ host graph engine + "
        "JAX/Flax/pjit training with device-resident sampling"
    ),
    long_description=open(
        os.path.join(_ROOT, "README.md"), encoding="utf-8"
    ).read(),
    long_description_content_type="text/markdown",
    license="Apache License 2.0",
    packages=setuptools.find_packages(include=["euler_tpu*"]),
    package_data={
        # ship the built engine AND its sources+Makefile so source
        # checkouts / sdists can rebuild with plain make
        "euler_tpu.graph": [
            "_native/*.so",
            "_native/*.cc",
            "_native/*.h",
            "_native/Makefile",
            "_native/*.supp",
        ],
        # the PyTorch port's CUDA sources, built with nvcc at first use,
        # and its copy of the engine's sources, built with make at first
        # use (the port's build_py builds nothing)
        "euler_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "euler_tpu_torch.graph": [
            "_native/*.cc",
            "_native/*.h",
            "_native/Makefile",
        ],
        "euler_tpu_torch.examples": ["dist_train.sh"],
    },
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
    ],
    extras_require={"remote-fs": ["fsspec"], "torch": ["torch"]},
    entry_points={
        "console_scripts": [
            # the reference's `python -m tf_euler` / console / converter /
            # service entry points as installed commands
            "euler-tpu = euler_tpu.run_loop:main",
            "euler-tpu-console = euler_tpu.console:main",
            "euler-tpu-convert = euler_tpu.graph.convert:main",
            "euler-tpu-service = euler_tpu.graph.service:main",
            # the PyTorch port's, the same four on the card
            "euler-tpu-torch = euler_tpu_torch.run_loop:main",
            "euler-tpu-torch-console = euler_tpu_torch.console:main",
            "euler-tpu-torch-convert = euler_tpu_torch.graph.convert:main",
            "euler-tpu-torch-service = euler_tpu_torch.graph.service:main",
        ]
    },
    cmdclass=cmdclass,
)
