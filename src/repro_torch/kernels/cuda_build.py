"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each kernel lives in ``kernels/csrc/<name>.cu`` with a plain C entry point.
At first use (or all together, through :func:`build`) it is compiled for
Hopper (``sm_90a``) into a shared library
under ``kernels/build/`` (ignored by git), named by a hash of the source,
the shared headers and the flags, so an edited source rebuilds and an
unchanged one loads the library already built.  Nothing here runs at import time: the CPU
test suite imports every module on machines with no ``nvcc``.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds: Dict[str, float] = {}   # wall time of each build this process
ptxas_log: Dict[str, str] = {}        # each build's -Xptxas -v report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                       "the port's CUDA kernels are built at first use on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names) -> None:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one
    ``nvcc`` process per source, all started together."""
    with _lock:
        jobs = []
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((name, so, tmp, proc, time.perf_counter()))
        failed = []
        for name, so, tmp, proc, t0 in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{err}")
                continue
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
            ptxas_log[name] = err
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
