"""Builds the port's native sources into shared libraries: the CUDA
kernels (``csrc/*.cu``) with ``nvcc``, and the host code (``csrc/*.cpp``,
the JPEG decoder, the letterbox, the MPEG-4 encoder and decoder) with the host C++ compiler.

Each source is compiled at first use into a shared library with a plain C
interface, loaded with ``ctypes``. The library's name carries a hash of the
source, of the CUDA headers beside it (``csrc/*.cuh``, for a ``.cu``) and
of the flags, so an edited source is rebuilt and an unchanged one is
loaded from the build directory: ``_build/`` beside the package (listed in
``.gitignore``), or the run's ``compile_cache`` (`set_build_dir`, which
`core.mesh.enable_compile_cache` calls), where a restarted process finds
the libraries an earlier one built. Each build writes a temporary file and
renames it, so that several processes (pytest workers, loader workers,
ranks) can build the same library at once. A failed build raises with the
compiler's log; nothing falls back.

CUDA flags: ``sm_90a`` (Hopper), ``--fmad=false`` because the kernels must
round every intermediate as the plain PyTorch versions do, and
``-Xptxas -v`` so the build log records registers and shared memory. Host
flags: ``-O3 -std=c++17``, no ``-march=native`` (a library built on one
host may be loaded on another), ``-ffp-contract=off`` (a float multiply
and add fuse only where the source calls ``fmaf``, so the result does not
depend on the host's instruction set), ``-pthread``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-pthread", "-shared", "-fPIC")


@dataclass(frozen=True)
class Build:
    name: str
    source: str  # path in the repository, e.g. fastvision_tpu_torch/csrc/nms.cu
    path: str  # the shared library
    seconds: float  # compiler wall time; 0.0 when an earlier build was reused
    log: str  # the compiler's output (ptxas register / shared-memory report)


_BUILDS: dict[str, Build] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # one build of a source at a time within a process


def build_dir() -> str:
    """The directory this process builds into and loads from (``BUILD_DIR``,
    one directory for the process's life: `set_build_dir`)."""
    return BUILD_DIR


def set_build_dir(path: str) -> str:
    """Build into and load from ``path`` (created) from now on. It must be
    set before the process's first build or load: once a library was built
    or loaded from another directory, a different one raises, so that one
    process never mixes two. -> the absolute path."""
    global BUILD_DIR
    path = os.path.abspath(os.path.expanduser(path))
    with _LOCK:
        if path != BUILD_DIR:
            if _BUILDS or _LIBS:
                raise RuntimeError(
                    f"compile_cache {path!r}: this process already built or loaded "
                    f"{sorted(set(_BUILDS) | set(_LIBS))} from {BUILD_DIR!r}; set the "
                    "cache before the first native build")
            os.makedirs(path, exist_ok=True)
            BUILD_DIR = path
    return path


def cached() -> list[str]:
    """The shared libraries in the build directory (file names, sorted)."""
    d = build_dir()
    return sorted(f for f in os.listdir(d) if f.endswith(".so")) if os.path.isdir(d) else []


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def host_compiler() -> str:
    for cxx in (os.environ.get("CXX"), "c++", "g++"):
        path = cxx and shutil.which(cxx)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (looked for $CXX, c++ and g++ on PATH)")


def _source(name: str) -> str:
    for ext in (".cu", ".cpp"):
        src = os.path.join(CSRC_DIR, name + ext)
        if os.path.exists(src):
            return src
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def kind(name: str) -> str:
    """``"cuda"`` for ``csrc/<name>.cu`` (nvcc), ``"host"`` for
    ``csrc/<name>.cpp`` (the host compiler)."""
    return "cuda" if _source(name).endswith(".cu") else "host"


def _command(src: str, out: str) -> list[str]:
    if src.endswith(".cu"):
        return [nvcc(), *NVCC_FLAGS, "-o", out, src]
    return [host_compiler(), *HOST_FLAGS, "-o", out, src]


def _target(src: str, name: str) -> str:
    h = hashlib.sha256()
    # a CUDA source's hash covers the headers beside it (csrc/*.cuh), which it may include
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh")) if src.endswith(".cu") else []
    for path in (src, *headers):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS if src.endswith(".cu") else HOST_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:16]}.so")


def sources() -> list[str]:
    """Names of the sources under ``csrc/`` (``*.cu`` and ``*.cpp``)."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cpp")))


def build_all(names: list[str] | None = None) -> list[Build]:
    """Compile the named sources (default: every ``csrc/*.cu`` and
    ``csrc/*.cpp``), one compiler process per source, all started together.
    Raises after all have ended if any failed."""
    if names is None:
        names = sources()
    with _LOCK:
        os.makedirs(build_dir(), exist_ok=True)
        running = []
        for name in names:
            if name in _BUILDS:
                continue
            src = _source(name)
            rel = os.path.relpath(src, os.path.dirname(_PKG_DIR))
            so = _target(src, name)
            if os.path.exists(so):
                _BUILDS[name] = Build(name, rel, so, 0.0, "")
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.Popen(_command(src, tmp), stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((name, rel, so, tmp, proc, time.perf_counter()))
        failures = []
        for name, rel, so, tmp, proc, t0 in running:
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"the build of {rel} failed (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, so)
            _BUILDS[name] = Build(name, rel, so, seconds, log)
        if failures:
            raise RuntimeError("\n".join(failures))
        return [_BUILDS[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``csrc/<name>.cpp``,
    built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        (build,) = build_all([name])
        lib = ctypes.CDLL(build.path)
        _LIBS[name] = lib
    return lib
