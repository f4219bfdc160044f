"""Build the hand-written CUDA kernels on first use.

Each source in ``csrc/`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. Builds
are cached in ``_build/`` keyed by a hash of the source, the headers in
``csrc/`` (``*.cuh``, which any source may include) and the flags, and
land there by an atomic rename, so concurrent processes never load a
half-written library. Every failure raises: a missing ``nvcc``, a compile
error or a timeout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: every kernel source, by stem
SOURCES = ("batchnorm", "conv_lanes", "attention", "xent")
BUILD_TIMEOUT_S = 600
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME``, else the toolkit's
    default install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME") or DEFAULT_CUDA_HOME)
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns, per source,
    the build seconds (0.0 when cached) and the compiler's report (register
    and shared-memory use per kernel, from ``-Xptxas -v``)."""
    out: dict[str, dict] = {}
    missing = []
    for name in names:
        if library_path(name).exists():
            out[name] = {"seconds": 0.0, "log": "cached"}
        else:
            missing.append(name)
    if not missing:
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    try:
        for name in missing:
            target = library_path(name)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, target, time.perf_counter()))
        errors = []
        for name, proc, tmp, target, t0 in jobs:
            try:
                log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                errors.append(f"{name}: nvcc timed out after {BUILD_TIMEOUT_S} s\n{log}")
                continue
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, target)
            out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    finally:
        for _name, proc, tmp, _target, _t0 in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
