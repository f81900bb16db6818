"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exports a plain C interface.  ``nvcc`` compiles
it for ``sm_90a`` into ``_build/lib<name>-<digest>.so`` (the digest
covers the source, every shared header ``csrc/*.cuh`` and the flags, so
an edited source or header rebuilds) and ``ctypes`` loads it.  No
PyTorch header is compiled, which keeps a build to seconds.  A build
failure raises with the compiler's output; nothing falls back to a
plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Compiler output of each build made by this process (ptxas's register,
# shared-memory and spill report per kernel instance).
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA toolkit is needed to build the port's kernels")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless its current library exists."""
    target = _target(name)
    if target.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(
            f"CUDA kernel build failed:\n$ {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, target)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
