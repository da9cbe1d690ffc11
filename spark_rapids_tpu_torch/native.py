"""Builds and loads the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers), at first use,
into ``_build/`` next to this file; the library name carries a hash of the
source, so an edited kernel is rebuilt. Libraries load through ``ctypes``.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("hashtbl_probe.cu",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR,
                        f"lib{os.path.splitext(source)[0]}_{digest}.so")


def build(source: str) -> str:
    """Compile one source (if its library is missing); returns its path."""
    out = _lib_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> List[str]:
    """Compile every kernel source, one nvcc process each, in parallel."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        return list(ex.map(build, SOURCES))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    fn = lib.srt_hashtbl_probe
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_uint64, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    lib.srt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.srt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(source: str = "hashtbl_probe.cu") -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _bind(ctypes.CDLL(build(source)))
            _libs[source] = lib
        return lib


def error_string(code: int) -> str:
    return load().srt_cuda_error_string(code).decode()
