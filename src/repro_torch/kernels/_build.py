"""Build the CUDA sources of ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds); each wrapper module keeps the ``argtypes`` of its entry points
in a module-level ``_ARGTYPES`` table, which ``bind`` applies.
Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout, keyed by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.
``build_all()`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

__all__ = ["SOURCES", "CSRC_DIR", "BUILD_DIR", "bind", "build_all", "load",
           "nvcc_path"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG_DIR)),
                         "build", "repro_torch_kernels")
SOURCES = ("rmmec_matmul", "flash_decode", "dequant", "quire_dot", "kv_write")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> str:
    """Library path keyed by the source, the shared headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (process or None, library path, temporary output path)."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None, out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: str, tmp: str) -> str:
    """Wait for one build; returns nvcc's report (empty if cached)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: List[str] = SOURCES) -> Dict[str, str]:
    """Build every source in parallel (one nvcc each); returns each
    source's nvcc report (``-Xptxas -v``: registers, shared memory,
    spills), empty for a library that was already built."""
    with _LOCK:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib


def bind(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """``load(name)`` with each entry point's ``argtypes`` set from
    ``argtypes`` (name -> list of ctypes types) and an ``int`` result."""
    lib = load(name)
    for fn_name, types in argtypes.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib
