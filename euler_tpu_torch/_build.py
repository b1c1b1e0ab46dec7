"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no
PyTorch header, so ``nvcc`` compiles them in seconds. Each ``*.cu`` is
compiled by its own ``nvcc`` process, all started together, then the
objects are linked into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o
    nvcc -shared -o libeuler_tpu_torch_<hash>.so *.o

The library is built at first use into ``build/euler_tpu_torch/`` beside
the package (a checkout's root, or the directory an install put the
package in), named by a hash of the sources (headers included) and flags
(a changed source builds anew), and loaded with ``ctypes``. A build
directory that cannot be written raises, naming it. Pointers and
the stream pass as ``c_void_p``; each C entry returns
``cudaGetLastError()`` after its launch, which the wrapper raises on.
A build (not a load of an earlier one) is a compile for the device
plane: ``devprof.record_compile`` counts it with its wall time.

``set_compile_cache(False)`` (the CLIs' ``--compile_cache 0``) builds
this process's kernels anew into a directory of their own under
``build/euler_tpu_torch/``, removed at exit, as the JAX package
recompiles its programs without its compilation cache; unset or True
reuses the cache across launches.
"""

from __future__ import annotations

import atexit
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-shared"]

_lib = None
_build_dir = BUILD_DIR  # where libraries are built and looked up
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


def make_build_dir(path: str, what: str) -> None:
    """Create ``path`` (where ``what`` is built) if needed and check that
    it can be written, else raise ``RuntimeError`` naming it."""
    try:
        os.makedirs(path, exist_ok=True)
        ok = os.access(path, os.W_OK | os.X_OK)
    except OSError as e:
        raise RuntimeError(f"cannot create {path}, where {what} is built "
                           f"at first use: {e}") from e
    if not ok:
        raise RuntimeError(f"cannot write {path}, where {what} is built at "
                           "first use: install euler_tpu_torch where it "
                           "can write beside itself")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(
        _build_dir, f"libeuler_tpu_torch_{h.hexdigest()[:16]}.so"
    )


def set_compile_cache(enabled) -> None:
    """Reuse the build cache under ``BUILD_DIR`` (``None`` or True), or
    build this process's kernels anew in a directory removed at exit
    (False). A library already loaded from the other place is dropped,
    so the next launch loads or builds from the chosen one."""
    global _build_dir, _lib
    want_cache = enabled is None or bool(enabled)
    if want_cache == (_build_dir == BUILD_DIR):
        return
    if want_cache:
        _build_dir = BUILD_DIR
    else:
        make_build_dir(BUILD_DIR, "the CUDA kernels")
        _build_dir = tempfile.mkdtemp(prefix="launch-", dir=BUILD_DIR)
        atexit.register(shutil.rmtree, _build_dir, True)
    _lib = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.etpu_sample_fanout2.argtypes = [
        p, i,            # roots, m
        p, p, p, p,      # nbr1, cum1, sampleable1, deg1 (null: W1 slots)
        p, p, p, p,      # nbr2, cum2, sampleable2, deg2 (null: W2 slots)
        i, i, i, i, i,   # R, W1, W2, f1, f2
        u32, u32,        # seed words
        p, p,            # u1, u2 (null: Philox)
        p, p,            # out1, out2
        p,               # stream
    ]
    lib.etpu_sample_fanout2.restype = ctypes.c_int
    lib.etpu_sample_neighbor.argtypes = [
        p, i,            # nodes, m
        p, p, p, p,      # nbr, cum, sampleable, deg (null: W slots)
        i, i, i, i,      # R, W, count, hop
        u32, u32,        # seed words
        p,               # u (null: Philox)
        p,               # out
        p,               # stream
    ]
    lib.etpu_sample_neighbor.restype = ctypes.c_int
    lib.etpu_draw_max_width.argtypes = []
    lib.etpu_draw_max_width.restype = ctypes.c_int
    lib.etpu_launch_floor.argtypes = [i, p]  # warps, stream
    lib.etpu_launch_floor.restype = ctypes.c_int
    return lib


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; append their output to build_log
    and raise if any failed."""
    global build_log
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    failed = []
    for c, proc in zip(cmds, procs):
        text, _ = proc.communicate()
        build_log += text
        if proc.returncode != 0:
            failed.append(f"{' '.join(c)} (exit {proc.returncode})")
    if failed:
        raise RuntimeError(
            "nvcc failed: " + "; ".join(failed) + f"\n{build_log}"
        )


def _compile_and_link(out: str) -> None:
    """One nvcc per source, started together, then one link. The build
    goes to a scratch directory beside the target and is renamed into
    place: a concurrent process sees either no library or a whole one."""
    nvcc = _nvcc()
    srcs = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=_build_dir) as tmp:
        objs = [
            os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs
        ]
        _run_all([
            [nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(srcs, objs)
        ])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, out)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if this source
    hash has no build yet. Raises when ``nvcc`` is missing or fails."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not os.path.exists(out):
        make_build_dir(_build_dir, "the CUDA kernels")
        t0 = time.perf_counter()
        _compile_and_link(out)
        build_seconds = time.perf_counter() - t0
        from euler_tpu_torch import devprof

        devprof.record_compile(build_seconds * 1e6)
    _lib = _declare(ctypes.CDLL(out))
    return _lib
