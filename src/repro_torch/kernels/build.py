"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into the repository's ``build/``
directory (named by a hash of the source and flags, so an edited source
rebuilds) and loaded with ``ctypes``.  Nothing is built at import time:
the CPU-only test machine imports every module and has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}          # source stem -> ctypes.CDLL
build_info: dict = {}     # source stem -> {"seconds", "ptxas", "path"}

# launches of each kernel, one per wrapper call that launched it
_launches: dict = {}


def count_launch(name: str) -> None:
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def load_library(stem: str) -> ctypes.CDLL:
    """Compile ``csrc/<stem>.cu`` (once per content) and load it."""
    if stem in _libs:
        return _libs[stem]
    src = CSRC / f"{stem}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}-{digest}.so"
    info = {"path": str(out), "seconds": 0.0, "ptxas": "(cached build)"}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        info["ptxas"] = proc.stderr
        os.replace(tmp, out)
    build_info[stem] = info
    _libs[stem] = ctypes.CDLL(str(out))
    return _libs[stem]
