"""Build a kernel source with ``nvcc`` into a shared library and load it with
``ctypes`` (a plain C interface: no PyTorch headers, so a build takes
seconds).

Libraries go to ``kernels/build/`` beside the sources, named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Building and loading one library sit behind a
process-wide lock of its own: the thread executor runs several tasks at
once, and each may be the first to launch a kernel, while two different
kernels may build at the same time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")

_locks_guard = threading.Lock()
_locks: dict = {}          # name -> the lock its build and load sit behind
_loaded: dict = {}
build_log: dict = {}       # name -> {"seconds": float, "ptxas": str}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``CUDA_HOME``, else the toolkit's
    usual install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "kernels are built from source at first use")
    return path


def load_library(name: str, source: Path,
                 defines: dict | None = None) -> ctypes.CDLL:
    """Return the loaded library for ``source``, building it first if this
    source, these flags and these ``-D`` ``defines`` have not been built
    yet."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        flags = ARCH_FLAGS + FLAGS + tuple(
            f"-D{k}={v}" for k, v in sorted((defines or {}).items()))
        digest = hashlib.sha256(
            source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"{name}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *flags, "-o", str(tmp), str(source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {source.name} (exit {proc.returncode}):"
                    f"\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
            build_log[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": proc.stderr.strip()}
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
