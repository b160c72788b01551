"""Builds the CUDA sources under ``csrc/`` on first use and loads them.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, cached under ``horovod_tpu_torch/_build/`` by a hash of
the source and of every header in ``csrc/`` (the sources share
``flash_kernels.cuh`` and the tensor-core kernels of ``flash_tc.cuh`` with
their building blocks, ``hopper.cuh``), so an edited source or header
rebuilds and an unchanged one loads at once. The library is loaded with
``ctypes``; the wrappers in ``ops/`` declare each entry's argument types
and keep the loaded library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _library_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_locked(out: str, command, error=RuntimeError) -> str:
    """Make ``out`` with ``command(tmp)`` (an argv that writes ``tmp``)
    unless it exists; return ``out``. Processes that build at once wait on a
    file lock beside ``out``, so one builds and the rest load its result;
    the compiler's output goes to ``<out>.log``. A failed build raises
    ``error``."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            argv = command(tmp)
            proc = subprocess.run(argv, capture_output=True, text=True)
            with open(out + ".log", "w") as log:
                log.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise error(
                    f"{argv[0]} failed on {os.path.basename(out)} "
                    f"({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
    return out


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library is cached; return the
    library's path (``build_locked``: one process builds, the compiler's
    resource report goes to ``<library>.log``)."""
    return build_locked(
        _library_path(source),
        lambda tmp: [nvcc(), *NVCC_FLAGS, "-o", tmp,
                     os.path.join(CSRC, source)])


def load(source: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<source>``, building it first if needed."""
    return ctypes.CDLL(build(source))
