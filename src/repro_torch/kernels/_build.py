"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``_build/`` beside this file (listed in ``.gitignore``),
named by the hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt at its next use and an
unchanged one is loaded as it is.  Nothing is built when the module is
imported: :func:`load` builds one library on first use, :func:`load_all`
builds every library at once, one ``nvcc`` per source, all started
together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_LOGS", "load", "load_all",
           "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# library name -> source file under csrc/
SOURCES = {"bw_gemm": "bw_gemm.cu", "bw_gemm_sparse": "bw_gemm_sparse.cu",
           "encode": "encode.cu", "quant_gemm": "quant_gemm.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> nvcc's output (ptxas' register and spill report) of the
# build this process ran; absent when the library was already built
BUILD_LOGS: Dict[str, str] = {}

_LOCKS = {name: threading.Lock() for name in SOURCES}
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if its .so is missing."""
    with _LOCKS[name]:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        src = CSRC / SOURCES[name]
        digest = hashlib.sha256(b"".join(
            [src.read_bytes()]
            + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
            + [" ".join(NVCC_FLAGS).encode()])).hexdigest()
        path = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                  str(src)], capture_output=True, text=True)
            if res.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed to build {src.name} (exit "
                                   f"{res.returncode}):\n{res.stdout}"
                                   f"{res.stderr}")
            os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
            BUILD_LOGS[name] = res.stdout + res.stderr
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
        return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Every library of SOURCES, the missing ones built in parallel."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(load, SOURCES)))
