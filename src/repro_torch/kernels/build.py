"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into the repository's ``build/``
directory (named by a hash of the source, every ``csrc/*.cuh`` header
and the flags, so an edited source or header rebuilds) and loaded with ``ctypes``.  Nothing is built at import time:
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
_probed: set = set()      # source stems built with -DSCAN_PROBE

# launches of each kernel, one per wrapper call that launched it
_launches: dict = {}


def count_launch(name: str) -> None:
    _launches[name] = _launches.get(name, 0) + 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def set_probe(stem: str, on: bool) -> None:
    """From its next load on, build ``csrc/<stem>.cu`` with
    ``-DSCAN_PROBE`` (clock stamps between its phases,
    ``csrc/scan_probe.cuh``) or, with ``on`` false, as shipped."""
    (_probed.add if on else _probed.discard)(stem)
    _libs.pop(stem, None)
    build_info.pop(stem, None)


def _flags(stem: str) -> list:
    return NVCC_FLAGS + (["-DSCAN_PROBE"] if stem in _probed else [])


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _paths(stem: str):
    src = CSRC / f"{stem}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # whatever the source includes
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(stem)).encode())
    return src, BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def load_libraries(stems) -> dict:
    """Compile every ``csrc/<stem>.cu`` not yet built (once per content),
    one ``nvcc`` per source, all started together; then load them."""
    jobs = {}
    for stem in stems:
        if stem in _libs:              # loaded: no hashing on a launch's path
            continue
        src, out = _paths(stem)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen([_nvcc(), *_flags(stem), "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs[stem] = (proc, tmp, out, src, time.perf_counter())
    done = {stem: (proc.communicate()[1], time.perf_counter() - t0)
            for stem, (proc, _, _, _, t0) in jobs.items()}   # wait for all
    for stem, (proc, tmp, out, src, _) in jobs.items():
        err, seconds = done[stem]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{err}")
        os.replace(tmp, out)
        build_info[stem] = {"path": str(out), "ptxas": err,
                            "seconds": seconds}
    for stem in stems:
        if stem not in _libs:
            out = _paths(stem)[1]
            build_info.setdefault(stem, {"path": str(out), "seconds": 0.0,
                                         "ptxas": "(cached build)"})
            _libs[stem] = ctypes.CDLL(str(out))
    return {stem: _libs[stem] for stem in stems}


def load_library(stem: str) -> ctypes.CDLL:
    """Compile ``csrc/<stem>.cu`` (once per content) and load it.  Every
    wrapper call asks for its library, so a loaded one is returned
    before anything else is done."""
    lib = _libs.get(stem)
    return lib if lib is not None else load_libraries([stem])[stem]
