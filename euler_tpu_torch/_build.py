"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no
PyTorch header, so ``nvcc`` compiles them in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o libeuler_tpu_torch_<hash>.so csrc/*.cu

The library is built at first use into ``build/euler_tpu_torch/`` beside
the package, named by a hash of the sources and flags (a changed source
builds anew), and loaded with ``ctypes``. Pointers and the stream pass as
``c_void_p``; each C entry returns ``cudaGetLastError()`` after its
launch, which the wrapper raises on.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "euler_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
build_log = ""  # nvcc's output (ptxas register/spill report) of this process
build_seconds = 0.0  # 0.0 when the library came from the cache


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu"))
        + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "CUDA kernels of euler_tpu_torch are built from source at first "
            "use and need the CUDA toolkit"
        )
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(
        BUILD_DIR, f"libeuler_tpu_torch_{h.hexdigest()[:16]}.so"
    )


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.etpu_sample_fanout2.argtypes = [
        p, i,            # roots, m
        p, p, p,         # nbr1, cum1, sampleable1
        p, p, p,         # nbr2, cum2, sampleable2
        i, i, i, i, i,   # R, W1, W2, f1, f2
        u32, u32,        # seed words
        p, p,            # u1, u2 (null: Philox)
        p, p,            # out1, out2
        p,               # stream
    ]
    lib.etpu_sample_fanout2.restype = ctypes.c_int
    lib.etpu_fanout2_max_width.argtypes = []
    lib.etpu_fanout2_max_width.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if this source
    hash has no build yet. Raises when ``nvcc`` is missing or fails."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build beside the target, then rename: a concurrent process sees
        # either no library or a whole one
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[
                s for s in _sources() if s.endswith(".cu")
            ]],
            capture_output=True, text=True,
        )
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{build_log}"
            )
        os.replace(tmp, out)
    _lib = _declare(ctypes.CDLL(out))
    return _lib
