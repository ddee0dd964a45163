"""ctypes surface over the C++ transfer agent (csrc/transfer_agent.cpp).

The port's copy of the reference package's transfer/native.py. The agent
is host code: it builds with ``g++`` from the checkout's own source into
the kernels' build directory (ops/_build.py ``build_host``), once per
source hash, and loads from there; nothing else of the repository is
loaded or built for it. The build runs when a transfer server starts
(``ensure_native``, blocking: a few seconds), never on a request path:
``native_available()`` only reports whether the library is loaded, so a
fetch never races a build. A build or load that fails is logged at ERROR
with the compiler's output and is not retried; the transfer plane then
answers inline, and counts the fallback (engine/transfer.py).

A fetch (``dtpu_fetch``) is a blocking foreign call, which ctypes runs
with the GIL released, so multi-MB pulls on an executor thread run beside
the engine loop.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..runtime.faults import FAULTS
from ..runtime.logging import get_logger

log = get_logger("transfer.native")

SOURCE = "transfer_agent.cpp"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False
# arenas whose agent teardown leaked its connection threads: kept alive for
# the process's life, so that a leaked thread's writev never reads freed
# (pinned) memory
_LEAKED_ARENAS: list = []

Buffer = Union[np.ndarray, torch.Tensor]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dtpu_agent_new.restype = ctypes.c_void_p
    lib.dtpu_agent_new.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dtpu_agent_port.restype = ctypes.c_int
    lib.dtpu_agent_port.argtypes = [ctypes.c_void_p]
    lib.dtpu_agent_register.restype = ctypes.c_int
    lib.dtpu_agent_register.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                                        ctypes.c_uint64, ctypes.c_uint64]
    lib.dtpu_agent_unregister.restype = ctypes.c_int
    lib.dtpu_agent_unregister.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dtpu_agent_free.restype = ctypes.c_int   # 0 freed, 1 leaked
    lib.dtpu_agent_free.argtypes = [ctypes.c_void_p]
    lib.dtpu_fetch.restype = ctypes.c_longlong
    lib.dtpu_fetch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
                               ctypes.c_void_p, ctypes.c_uint64]
    return lib


def _load(build: bool) -> Optional[ctypes.CDLL]:
    """The bound library; with ``build``, compiled first when missing. None
    once a build or load has failed (logged then, once)."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        from ..ops import _build

        path = os.path.join(_build.build_dir(), _build._lib_name(SOURCE))
        try:
            if build:
                path = _build.build_host(SOURCE)
            _lib = _bind(ctypes.CDLL(path))
        except OSError as e:
            if not build:
                return None   # not built yet: a later ensure_native builds it
            log.error("native transfer agent: loading %s failed (%s); the KV transfer "
                      "plane answers inline", path, e)
            _build_failed = True
        except (RuntimeError, subprocess.SubprocessError) as e:
            log.error("native transfer agent: build failed; the KV transfer plane answers "
                      "inline:\n%s", e)
            _build_failed = True
        return _lib


def native_available() -> bool:
    """True when the library is loaded now (or loads from an earlier build).
    Never builds: ``ensure_native`` does, when a transfer server starts."""
    return _load(build=False) is not None


def ensure_native() -> bool:
    """Build (when missing) and load the library, blocking; False when that
    failed (logged)."""
    return _load(build=True) is not None


def _address(buf: Buffer) -> int:
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("a native buffer must be a contiguous host tensor")
        return buf.data_ptr()
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("a native buffer must be C-contiguous")
    return buf.ctypes.data


def _nbytes(buf: Buffer) -> int:
    return buf.numel() * buf.element_size() if isinstance(buf, torch.Tensor) else buf.nbytes


class NativeAgent:
    """Serving side: registered host arenas exposed over raw TCP.

    An arena is a contiguous host buffer (a numpy array, or a pinned uint8
    tensor) sliced into equal-size blocks; the agent serves reads of named
    block indices. Registered buffers stay referenced here until
    ``unregister`` or ``close``; a close whose teardown leaks the agent's
    threads parks them in ``_LEAKED_ARENAS`` for the process's life."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        lib = _load(build=True)
        if lib is None:
            raise RuntimeError("native transfer library unavailable")
        self._lib = lib
        self._handle = lib.dtpu_agent_new(host.encode(), port)
        if not self._handle:
            raise RuntimeError(f"failed to bind transfer agent on {host}:{port}")
        self.port = lib.dtpu_agent_port(self._handle)
        self._regions: dict = {}   # region id -> buffer (kept alive)

    def register(self, region_id: int, arena: Buffer, block_bytes: int) -> None:
        nbytes = _nbytes(arena)
        if block_bytes <= 0 or nbytes % block_bytes:
            raise ValueError("arena size must be a multiple of block_bytes")
        rc = self._lib.dtpu_agent_register(self._handle, region_id, _address(arena),
                                           block_bytes, nbytes // block_bytes)
        if rc != 0:
            raise RuntimeError("region registration failed")
        self._regions[region_id] = arena

    def unregister(self, region_id: int) -> None:
        self._lib.dtpu_agent_unregister(self._handle, region_id)
        self._regions.pop(region_id, None)

    def close(self) -> None:
        if self._handle:
            rc = self._lib.dtpu_agent_free(self._handle)
            self._handle = None
            if rc == 1:
                # the teardown leaked the agent: its connection threads may
                # still writev from these arenas, so they must outlive us
                log.warning("native agent leaked on close; keeping %d arena(s) for the "
                            "process's life", len(self._regions))
                _LEAKED_ARENAS.append(dict(self._regions))
            self._regions.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_fetch(host: str, port: int, region_id: int, block_ids: Sequence[int],
                 block_bytes: int, out: Optional[Buffer] = None) -> Buffer:
    """Client side: the remote blocks, concatenated, into ``out`` (a host
    buffer of ``len(block_ids) * block_bytes`` bytes: a pinned tensor for a
    card's upload) or a fresh uint8 array ``[n, block_bytes]``. Raises on
    any failure. Runs on executor threads: the sync fault point is safe."""
    FAULTS.inject("transfer.native_fetch")
    lib = _load(build=False)
    if lib is None:
        raise RuntimeError("native transfer library unavailable")
    n = len(block_ids)
    ids = np.asarray(block_ids, np.uint64)
    if out is None:
        out = np.empty((n, block_bytes), np.uint8)
    want = n * block_bytes
    if _nbytes(out) != want:
        raise ValueError(f"native fetch: a buffer of {_nbytes(out)} bytes for {want}")
    got = lib.dtpu_fetch(host.encode(), port, region_id,
                         ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
                         _address(out), want)
    if got != want:
        raise RuntimeError(f"native fetch failed: rc={got}, expected {want}")
    return out
