"""Builds the CUDA kernels in csrc/ into plain-C shared libraries.

Each library is compiled with nvcc for Hopper (sm_90a) at first use and
cached under _build/<name>-<sha12>.so, keyed on a sha256 of the sources and
the flags, so an edited source never meets a stale binary. The libraries
have a plain C interface and are loaded with ctypes: no PyTorch headers are
compiled, which keeps a cold build to seconds. Binaries are never committed.
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

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Library name -> its sources under csrc/.
KERNELS: Dict[str, List[str]] = {
    "partial_min": ["partial_min.cu"],
    "gather_rows": ["gather_rows.cu"],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str, sources: List[str]) -> str:
    """Path of the up-to-date build of `name`, compiling it if needed.
    Raises RuntimeError with nvcc's output when the build fails. nvcc's
    report (registers, shared memory, spills per kernel) is kept beside
    the library as <name>-<sha12>.log."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    stem = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}")
    lib = stem + ".so"
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                          capture_output=True, text=True, timeout=600)
    with open(stem + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):"
                           f"\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent first users race the build
    return lib


def build_all() -> Dict[str, str]:
    """Build every library of KERNELS (one nvcc per library, all started
    together) and return name -> path."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        futs = {name: pool.submit(library_path, name, srcs)
                for name, srcs in KERNELS.items()}
        return {name: f.result() for name, f in futs.items()}


def load(name: str) -> ctypes.CDLL:
    """ctypes handle of the library `name` of KERNELS, built on first
    use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(
                library_path(name, KERNELS[name]))
        return lib
