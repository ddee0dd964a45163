"""Builds the CUDA kernels of csrc/ at first use and binds them with ctypes.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers: seconds per file instead of minutes),
for Hopper only (``sm_90a``). All sources build in parallel, one ``nvcc``
each, into ``dynamo_tpu_torch/_build/<hash>/``, where the hash covers every
source and header and the flags, so an edited source rebuilds and an
unchanged checkout reuses its libraries. Only the CUDA toolkit is needed
(``$CUDA_HOME/bin/nvcc``, default ``/usr/local/cuda``).

The host code of csrc/ (``*.cpp``: the KV transfer agent) builds with
``g++`` into the same directory (``build_host``), on the CPU machines too.

Nothing here runs at import: the tests import every module on machines
without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterator, List, Sequence, Union

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_ROOT = os.path.join(PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _sources() -> List[str]:
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + GXX_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh", ".cpp")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(BUILD_ROOT, source_hash())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels build on the "
            "GPU machine only"
        )
    return found


def build_all() -> str:
    """Compile every csrc/*.cu that is missing from the build directory,
    all in parallel; returns the directory. Raises with the compiler's
    output if any source fails."""
    out_dir = build_dir()
    todo = [
        s for s in _sources()
        if not os.path.exists(os.path.join(out_dir, _lib_name(s)))
    ]
    if not todo:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        # build into a temporary name, then rename: concurrent builders of
        # the same hash never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(os.path.join(out_dir, _lib_name(src) + ".log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"--- {src} (exit {proc.returncode})\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, os.path.join(out_dir, _lib_name(src)))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out_dir


def build_host(source: str) -> str:
    """Compile the host source ``csrc/<source>`` (C++, a plain C interface)
    with ``g++`` into the build directory unless it is there; returns the
    library's path. Raises with the compiler's output when it fails."""
    out_dir = build_dir()
    path = os.path.join(out_dir, _lib_name(source))
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found (set CXX): the host libraries of csrc/ need it")
    # a temporary name, then a rename, as build_all
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {source} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def _lib_name(source: str) -> str:
    return "lib" + os.path.splitext(source)[0] + ".so"


def load(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(os.path.join(build_all(), _lib_name(source)))
            _libs[source] = lib
        return lib


# every launch counter (each Kernel is one), so that a graph capture can
# record what it launched
_counters: List["LaunchCounter"] = []


class LaunchCounter:
    """A count of launches. ``launches`` counts them all; ``replayed``
    the share that CUDA-graph replays made (``add_replayed``), since a
    replay runs the captured launches without calling any wrapper."""

    def __init__(self):
        self.launches = 0
        self.replayed = 0
        _counters.append(self)


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[LaunchCounter, int]]:
    """Around a CUDA-graph capture: yields a dict that holds, on exit, the
    launches each counter was asked for inside the block, and takes them
    back out of the counts (a capture runs nothing; each replay adds them
    with ``add_replayed``)."""
    before = [(c, c.launches) for c in _counters]
    recorded: Dict[LaunchCounter, int] = {}
    try:
        yield recorded
    finally:
        for c, n in before:
            if c.launches != n:
                recorded[c] = c.launches - n
                c.launches = n


def add_replayed(recorded: Dict[LaunchCounter, int], replays: int = 1) -> None:
    """Count ``replays`` replays of a graph whose capture recorded
    ``recorded``."""
    for c, n in recorded.items():
        c.launches += n * replays
        c.replayed += n * replays


class Kernel(LaunchCounter):
    """One C entry point of one csrc source, with its launch count.

    ``launch`` passes tensors as device pointers (None as a null pointer,
    for an optional argument; an int as an address the caller keeps valid:
    inside a tensor it holds, or a host array the entry point reads during
    the call; at least one must be a tensor), ints as C ints, floats as C
    floats, appends the current CUDA stream of the first tensor's device,
    and raises when the entry point reports a CUDA error. ``launches`` counts the launches that succeeded; whoever wants to
    see which kernels a run went through sets it to 0 before and reads it
    after. Launches inside a CUDA-graph capture are recorded instead
    (``recording_launches``) and counted once per replay."""

    def __init__(self, source: str, entry: str, n_ptrs: int, n_ints: int,
                 n_floats: int = 0):
        super().__init__()
        self.source = source
        self.entry = entry
        self.n_ptrs = n_ptrs
        self.n_ints = n_ints
        self.n_floats = n_floats
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.entry)
            fn.argtypes = (
                [ctypes.c_void_p] * self.n_ptrs
                + [ctypes.c_int] * self.n_ints
                + [ctypes.c_float] * self.n_floats
                + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, tensors: Sequence[Union[torch.Tensor, int, None]], ints: Sequence[int],
               floats: Sequence[float] = ()) -> None:
        if (len(tensors) != self.n_ptrs or len(ints) != self.n_ints
                or len(floats) != self.n_floats):
            raise TypeError(f"{self.entry}: wrong argument count")
        fn = self._bind()
        device = next(t.device for t in tensors if isinstance(t, torch.Tensor))
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t if t is None or isinstance(t, int) else t.data_ptr() for t in tensors]
        err = fn(*ptrs, *[int(i) for i in ints], *[float(x) for x in floats], stream)
        if err != 0:
            raise RuntimeError(f"{self.entry}: CUDA error {err}")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Device, type, rank, contiguity and 16-byte alignment: what every
    kernel of csrc/ assumes of its tensor arguments."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
