"""The native core's loader: builds ``libhvd_core`` from ``cc/src`` (once)
and returns its path.

The library is compiled with ``g++`` at first use, with the flags of
``cc/Makefile`` (which stays for the sanitizer targets and builds by hand),
into ``horovod_tpu_torch/_build/``, never beside the sources. Its name
carries a hash of the sources, the flags and the host's CPU model: the
build is ``-march=native``, so an edited source, or a tree carried to a
host of another model, builds afresh instead of loading a stale or foreign
library. Processes that build at once wait on a file lock
(``ops/_build.build_locked``): one compiles, the rest load its result.
"""

from __future__ import annotations

import hashlib
import os

from ..ops._build import BUILD_DIR, build_locked

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "src")
SOURCES = ("engine.cc", "c_api.cc")
CXXFLAGS = ("-O3", "-march=native", "-g", "-fPIC", "-std=c++17", "-Wall",
            "-Wextra", "-pthread")
# librt: shm_open/shm_unlink live there on glibc < 2.34 (shm_ring.h).
LDLIBS = ("-lrt",)


class NativeBuildError(ImportError):
    pass


def cpu_model() -> str:
    """The host's CPU as ``-march=native`` sees it: vendor, family, model,
    model name and feature flags of the first processor in
    ``/proc/cpuinfo`` ("" where there is none)."""
    keys = ("vendor_id", "cpu family", "model", "model name", "flags")
    found: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                k, _, v = line.partition(":")
                if k.strip() in keys:
                    found[k.strip()] = v.strip()
    except OSError:
        return ""
    return "|".join(found.get(k, "") for k in keys)


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def library_path(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR,
                 flags=CXXFLAGS) -> str:
    """Where the library of ``src_dir`` built with ``flags`` on this host
    lies: ``<build_dir>/libhvd_core-<hash>.so``."""
    digest = hashlib.sha256(
        "\0".join([compiler(), *flags, *LDLIBS, cpu_model()]).encode())
    for name in sorted(os.listdir(src_dir)):
        with open(os.path.join(src_dir, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(build_dir,
                        f"libhvd_core-{digest.hexdigest()[:16]}.so")


def build_library(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR,
                  flags=CXXFLAGS) -> str:
    """Compile ``src_dir``'s library unless it is built; return its path."""
    out = library_path(src_dir, build_dir, flags)
    return build_locked(
        out,
        lambda tmp: [compiler(), *flags, "-shared", "-o", tmp,
                     *(os.path.join(src_dir, s) for s in SOURCES), *LDLIBS],
        error=NativeBuildError)


def lib_path(build: bool = True) -> str:
    """Path to the built shared library, building it if needed.

    ``HVD_NATIVE_LIB`` overrides the build with an explicit library path
    (a sanitizer build of ``cc/Makefile``, for instance); every process
    that inherits the env loads it."""
    override = os.environ.get("HVD_NATIVE_LIB")
    if override:
        if not os.path.exists(override):
            raise NativeBuildError(
                f"HVD_NATIVE_LIB={override} does not exist")
        return override
    if build:
        return build_library()
    out = library_path()
    if not os.path.exists(out):
        raise NativeBuildError(f"{os.path.basename(out)} not built")
    return out
