"""Build the host pipeline's shared library on first use.

The source (``src/host_pipeline.cc``) compiles with the host C++ compiler
(``g++``, else ``c++`` or ``clang++``) into a library with a plain C
interface, loaded with ``ctypes``. Builds are cached in ``_build/`` keyed by
a hash of the source and the flags, and land there by an atomic rename, so
concurrent processes never load a half-written library. Without a compiler
there is nothing to build (:func:`build_library` returns None and the
pipeline keeps its Python form); a compile error or a timeout raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SRC = Path(__file__).parent / "src" / "host_pipeline.cc"
BUILD_DIR = Path(__file__).parent / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall"]
BUILD_TIMEOUT_S = 300


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libhost_pipeline-{h.hexdigest()[:16]}.so"


def build_library() -> Optional[Path]:
    """The built library (compiled now if not cached), or None when no
    host compiler is installed."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", tmp], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"host pipeline build failed ({cxx} exited {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return out
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
