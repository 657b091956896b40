"""Builds the CUDA sources in csrc/ into shared libraries with nvcc.

Each library is compiled for Hopper (sm_90a) at first use and cached under
_build/<name>-<sha12>.so, keyed on a sha256 of the sources and the command's
flags, so an edited source never meets a stale binary. Binaries are never
committed. Two kinds:
- plain-C libraries loaded with ctypes (partial_min, id_scan): no PyTorch
  headers, so a cold build takes seconds;
- PyTorch operator libraries (gather_rows_op: the gather kernel and the
  `vdb::gather_rows` operator; csr_ip_op: the sparse scorer's kernel and
  the `vdb::csr_ip` operator; beam_iter_op: the traversal kernel and the
  `vdb::beam_iter` operator), compiled against the installed PyTorch's
  headers and libraries, which takes tens of seconds, and registered with
  torch.ops.load_library. Its key also holds the PyTorch version, so a new
  PyTorch never meets a library built against another one.
build_all() starts one nvcc per library, all together.
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
# PyTorch's libraries an operator library links against.
TORCH_LIBS = ["c10", "c10_cuda", "torch_cpu", "torch_cuda"]

# Library name -> its sources under csrc/: plain-C libraries (ctypes) and
# PyTorch operator libraries (torch.ops).
KERNELS: Dict[str, List[str]] = {"partial_min": ["partial_min.cu"],
                                 "id_scan": ["id_scan.cu"]}
OPERATORS: Dict[str, List[str]] = {
    "gather_rows_op": ["gather_rows.cu", "gather_rows_op.cpp"],
    "csr_ip_op": ["csr_ip.cu", "csr_ip_op.cpp"],
    "beam_iter_op": ["beam_iter.cu", "beam_iter_op.cpp"]}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_registered: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def operator_flags() -> List[str]:
    """nvcc's flags for an operator library before its sources: NVCC_FLAGS,
    the C++ ABI the installed PyTorch was built with and its include paths
    (as system headers)."""
    import torch
    from torch.utils import cpp_extension

    flags = [*NVCC_FLAGS,
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    for path in cpp_extension.include_paths():
        flags += ["-isystem", path]
    return flags


def operator_link_flags() -> List[str]:
    """nvcc's flags for an operator library after its sources (the link
    needs them there): PyTorch's library paths, also as the run path, and
    TORCH_LIBS."""
    from torch.utils import cpp_extension

    flags = []
    for path in cpp_extension.library_paths():
        flags += ["-L", path, "-Xlinker", f"-rpath={path}"]
    return flags + [f"-l{lib}" for lib in TORCH_LIBS]


def _sources(name: str) -> List[str]:
    return [os.path.join(CSRC_DIR, s)
            for s in KERNELS.get(name) or OPERATORS[name]]


def _flags(name: str):
    """(flags before the sources, flags after them) of library `name`."""
    if name in KERNELS:
        return NVCC_FLAGS, []
    return operator_flags(), operator_link_flags()


def build_command(name: str, out: str) -> List[str]:
    """The nvcc command that builds library `name` of KERNELS or OPERATORS
    into `out`."""
    before, after = _flags(name)
    return [_nvcc(), *before, "-o", out, *_sources(name), *after]


def library_stem(name: str) -> str:
    """_build/<name>-<sha12>: the sha256 of the flags, the sources' bytes
    and, for an operator library, the PyTorch version."""
    before, after = _flags(name)
    h = hashlib.sha256("\0".join([*before, *after]).encode())
    if name in OPERATORS:
        import torch

        h.update(f"\0torch {torch.__version__}".encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}")


def library_path(name: str) -> str:
    """Path of the up-to-date build of `name`, compiling it if needed.
    Raises RuntimeError with nvcc's output when the build fails. nvcc's
    report (registers, shared memory, spills per kernel) is kept beside
    the library as <name>-<sha12>.log."""
    stem = library_stem(name)
    lib = stem + ".so"
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    proc = subprocess.run(build_command(name, tmp), capture_output=True,
                          text=True, timeout=900)
    with open(stem + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):"
                           f"\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent first users race the build
    return lib


def build_all() -> Dict[str, str]:
    """Build every library of KERNELS and OPERATORS (one nvcc per library,
    all started together) and return name -> path."""
    names = [*KERNELS, *OPERATORS]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futs = {name: pool.submit(library_path, name) for name in names}
        return {name: f.result() for name, f in futs.items()}


def load(name: str) -> ctypes.CDLL:
    """ctypes handle of the library `name` of KERNELS, built on first
    use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
        return lib


def operator_cdll(name: str) -> ctypes.CDLL:
    """ctypes handle of the operator library `name` of OPERATORS (its
    extern "C" functions), registered with torch.ops first."""
    load_operator(name)
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(_registered[name])
        return lib


def load_operator(name: str) -> None:
    """Register the operators of library `name` of OPERATORS with torch.ops,
    built on first use. Raises RuntimeError naming nvcc's log when the
    library does not load."""
    import torch

    with _lock:
        if name in _registered:
            return
        path = library_path(name)
        try:
            torch.ops.load_library(path)
        except OSError as e:
            raise RuntimeError(f"{path} did not load ({e}); nvcc's output is "
                               f"in {path[:-3]}.log") from e
        _registered[name] = path
