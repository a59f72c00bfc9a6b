"""Build, load and count the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface and compiles with
nvcc into its own shared library under `build/kernels/` at the root of the
checkout (listed in .gitignore), at first use; the libraries are loaded
with ctypes.  `build_all()` starts one nvcc per source, all at once, so the
sources compile in parallel.  A library's file name carries a hash of its
source and of the shared headers (`csrc/*.cuh`), so an edited source or
header is rebuilt and a stale library never loads.

Every C entry point returns the `cudaError_t` of `cudaGetLastError()` right
after its launch; `check()` raises on anything but success.  `LAUNCHES`
counts the launches per kernel name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.  Under a CUDA graph a wrapper runs once, at the
capture, when nothing launches: `CountedGraph` takes the capture's counts
out of `LAUNCHES` and adds them again at each replay.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

LAUNCHES: collections.Counter = collections.Counter()

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "kernels")
SOURCES = ("attention", "cutout", "persp", "shift", "cutout_win", "ln",
           "block")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOGS: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


class CountedGraph:
    """A `torch.cuda.CUDAGraph` whose replays count its kernels' launches.

    `capture()` records the block into the graph (nothing runs) and keeps
    the counts the wrappers added meanwhile apart from `LAUNCHES`;
    `replay()` runs the graph and adds those counts, once per replay."""

    def __init__(self):
        import torch
        self.graph = torch.cuda.CUDAGraph()
        self.counts: collections.Counter = collections.Counter()

    @contextlib.contextmanager
    def capture(self, **kwargs):
        import torch
        before = LAUNCHES.copy()
        try:
            with torch.cuda.graph(self.graph, **kwargs):
                yield
        finally:
            self.counts = LAUNCHES - before
            LAUNCHES.clear()
            LAUNCHES.update(before)

    def replay(self) -> None:
        self.graph.replay()
        LAUNCHES.update(self.counts)


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
    """The library's path, named by a hash of its source and of every
    header in csrc/ (the sources include them)."""
    digest = hashlib.sha1()
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


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


def aligned(tensor):
    """`tensor` contiguous and starting on a 16-byte boundary (copied if it
    does not), for kernels that read 16 bytes a load."""
    tensor = tensor.contiguous()
    return tensor if tensor.data_ptr() % 16 == 0 else tensor.clone()


def stream_ptr(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


# ctypes argument shorthands for the kernel modules
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
