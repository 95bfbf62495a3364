"""Builds a CUDA source of `repro_torch/csrc/` into a shared library with
`nvcc` on first use and loads it with ctypes.

The library is named by a hash of its sources, the headers of csrc/ and
the flags, so an edited source or header is rebuilt and a built one is
reused. The build directory is
`build/kernels/` at the root of the checkout (listed in .gitignore). One
lock per library serialises the build across threads (the EC path calls
the kernel from several pools at once) and an exclusive file lock across
processes; the library is written under a temporary name and renamed into
place, so a reader never loads half a file.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
build_logs: Dict[str, str] = {}     # name -> nvcc's output (ptxas report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def load(name: str, sources: List[str],
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library built from `sources` (file names in csrc/);
    `bind` declares its functions' argtypes and restype once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        paths = [CSRC / src for src in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in paths + sorted(CSRC.glob("*.cuh")):
            digest.update(path.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        with open(BUILD_DIR / f"{name}.lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if not so.exists():
                    tmp = so.with_suffix(f".{os.getpid()}.tmp")
                    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, paths)]
                    res = subprocess.run(cmd, capture_output=True, text=True)
                    build_logs[name] = res.stdout + res.stderr
                    if res.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed for {name} ({res.returncode}):\n"
                            f"{res.stdout}{res.stderr}")
                    os.replace(tmp, so)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(so))
        bind(lib)
        _libs[name] = lib
        return lib
