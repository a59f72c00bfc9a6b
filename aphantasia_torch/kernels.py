"""Build, load and count the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface and compiles with
nvcc into its own shared library under `build/kernels/` at the root of the
checkout (listed in .gitignore), at first use; the libraries are loaded
with ctypes.  `build_all()` starts one nvcc per source, all at once, so the
sources compile in parallel.  A library's file name carries a hash of its
source, so an edited source is rebuilt and a stale one never loads.

Every C entry point returns the `cudaError_t` of `cudaGetLastError()` right
after its launch; `check()` raises on anything but success.  `LAUNCHES`
counts the launches per kernel name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

LAUNCHES: collections.Counter = collections.Counter()

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "kernels")
SOURCES = ("attention", "cutout")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOGS: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every named source that has no library yet, one nvcc
    process per source, all started together.  Returns {name: .so path}.
    Raises with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.isfile(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu:\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if needed.
    `signatures` maps each C function to its ctypes argtypes; every
    function returns an int (a cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all((name,))[name])
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


# ctypes argument shorthands for the kernel modules
PTR = ctypes.c_void_p
INT = ctypes.c_int
