"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
repository's ``build/kernels/`` directory and loaded with ``ctypes``.  The
library's file name carries a hash of its source and of every header the
source includes from ``csrc/``, so an edited source or header is rebuilt and
a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
# where the libraries are built and looked up (runtime.artifact.enable_persistent_cache)
BUILD_DIR = DEFAULT_BUILD_DIR
# -Xptxas -v: the compiler output then lists each kernel's registers,
# shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("qd_inverse", "chol_inverse")

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: dict = {}
build_logs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return path


def source_files(name: str) -> list:
    """``csrc/<name>.cu`` and, recursively, the files it includes by
    ``#include "..."`` (paths relative to ``csrc/``), in a fixed order."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC_DIR, rel)) as f:
            todo += sorted(_INCLUDE.findall(f.read()), reverse=True)
    return [os.path.join(CSRC_DIR, rel) for rel in seen]


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start_build(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library exists; returns
    (process, temporary output path) or None."""
    if os.path.exists(library_path(name)):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def _finish_build(name: str, started) -> str:
    """Wait for a build; returns nvcc's output ("" when nothing was built)."""
    if started is None:
        return ""
    proc, tmp = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, library_path(name))  # atomic: a concurrent loader sees all or nothing
    return out


def load_libraries(names=KERNELS) -> list:
    """The loaded shared libraries for ``csrc/<name>.cu``, each built if
    needed, all compilers started together; the compiler's output is kept in
    ``build_logs[name]``."""
    with _lock:
        missing = [n for n in names if n not in _loaded]
        started = {n: _start_build(n) for n in missing}
        errors = []
        for n in missing:
            try:
                build_logs[n] = _finish_build(n, started[n])
                _loaded[n] = ctypes.CDLL(library_path(n))
            except RuntimeError as err:  # let the other compilers finish first
                errors.append(err)
        if errors:
            raise errors[0]
        return [_loaded[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, built if needed."""
    return load_libraries((name,))[0]
