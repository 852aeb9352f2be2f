"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``. The library's name carries
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded from ``_build/`` (listed in ``.gitignore``). A
failed build raises; nothing falls back.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` because the kernels must
round every intermediate as the plain PyTorch versions do, and
``-Xptxas -v`` so the build log records registers and shared memory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Build:
    name: str
    path: str  # the shared library
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    log: str  # nvcc's output (ptxas register / shared-memory report)


_BUILDS: dict[str, Build] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(names: list[str] | None = None) -> list[Build]:
    """Compile the named sources (default: every ``csrc/*.cu``), one nvcc
    process per source, all started together. Raises on the first failure."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for name in names:
        if name in _BUILDS:
            continue
        src, so = _target(name)
        if os.path.exists(so):
            _BUILDS[name] = Build(name, so, 0.0, "")
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, so, tmp, proc, time.perf_counter()))
    failures = []
    for name, so, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        _BUILDS[name] = Build(name, so, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return [_BUILDS[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        (build,) = build_all([name])
        lib = ctypes.CDLL(build.path)
        _LIBS[name] = lib
    return lib
