"""Device memory shared between processes on one card, for the KV
transfer's device path (engine/transfer.py).

The reference pulls pages between processes through PJRT's transfer
server; on the H100 two processes on one card share device memory through
CUDA IPC. The transfer server's staging arena is one ``cudaMalloc`` of its
own (csrc/block_copy.cu ``dtt_ipc_*``): a handle of a PyTorch tensor would
name the caching allocator's whole segment, not the tensor. The server
exports the arena's handle once; a client process opens it once per server
and keeps the mapping while it is in use or among the most recent. Either side sees its bytes as torch tensors through
``__cuda_array_interface__`` (``device_view``), so the page-move kernel's
wrappers gather into the arena and scatter out of it as into any buffer.

CUDA only, built with the kernels at first use; nothing runs at import.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from typing import Dict, Sequence

import torch

from ._build import load

HANDLE_BYTES = 64   # CUDA_IPC_HANDLE_SIZE

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = load("block_copy.cu")
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        for name, args in (("dtt_ipc_alloc", [i, ll, ctypes.POINTER(p)]),
                           ("dtt_ipc_free", [i, p]),
                           ("dtt_ipc_export", [i, p, p]),
                           ("dtt_ipc_open", [i, p, ctypes.POINTER(p)]),
                           ("dtt_ipc_close", [i, p])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _bound = lib
    return _bound


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


class _CudaArray:
    """The ``__cuda_array_interface__`` of ``nbytes`` bytes at ``ptr``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2, "strides": None,
        }


def device_view(ptr: int, device: torch.device, dtype: torch.dtype,
                shape: Sequence[int]) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` over the device memory at
    ``ptr`` (not owned: the caller keeps the memory alive)."""
    numel = 1
    for s in shape:
        numel *= int(s)
    nbytes = numel * torch.empty((), dtype=dtype).element_size()
    raw = torch.as_tensor(_CudaArray(ptr, nbytes), device=device)
    return raw.view(dtype).view(*shape)


class IpcArena:
    """One exported device allocation of ``nbytes`` on ``device``."""

    def __init__(self, device: torch.device, nbytes: int):
        self.device = torch.device(device)
        self.index = self.device.index if self.device.index is not None else 0
        self.nbytes = int(nbytes)
        ptr = ctypes.c_void_p()
        _check(_lib().dtt_ipc_alloc(self.index, self.nbytes, ctypes.byref(ptr)),
               "cudaMalloc of the transfer arena")
        self.ptr = int(ptr.value)
        buf = ctypes.create_string_buffer(HANDLE_BYTES)
        _check(_lib().dtt_ipc_export(self.index, ctypes.c_void_p(self.ptr), buf),
               "cudaIpcGetMemHandle")
        self.handle = buf.raw

    def view(self, offset: int, dtype: torch.dtype, shape: Sequence[int]) -> torch.Tensor:
        return device_view(self.ptr + int(offset), self.device, dtype, shape)

    def close(self) -> None:
        if self.ptr:
            _lib().dtt_ipc_free(self.index, ctypes.c_void_p(self.ptr))
            self.ptr = 0


# The arenas this process opened, least recently used first. A mapping
# keeps its server's device memory alive until it is closed, so one is
# closed once no pull uses it and its server's address offers another
# handle (the server restarted), a pull through it failed, or it falls out
# of the MAX_OPEN_ARENAS most recently used. Pulls open arenas from worker
# threads, and a handle may be opened only once a process.
MAX_OPEN_ARENAS = 8


class _Mapping:
    __slots__ = ("ptr", "index", "users", "retired")

    def __init__(self, ptr: int, index: int):
        self.ptr, self.index, self.users, self.retired = ptr, index, 0, False


_opened: "OrderedDict[bytes, _Mapping]" = OrderedDict()
_retired: Dict[bytes, _Mapping] = {}     # closed once their last pull ends
_by_address: Dict[str, bytes] = {}
_opened_lock = threading.Lock()


def _close(m: _Mapping) -> None:
    _lib().dtt_ipc_close(m.index, ctypes.c_void_p(m.ptr))


def _retire(handle: bytes) -> None:
    """(under the lock) Take ``handle`` out of the cache; close it now if
    no pull uses it, else when its last pull releases it."""
    m = _opened.pop(handle, None)
    if m is None:
        return
    for address in [a for a, h in _by_address.items() if h == handle]:
        del _by_address[address]
    if m.users:
        m.retired = True
        _retired[handle] = m
    else:
        _close(m)


def open_arena(handle: bytes, device: torch.device, address: str = "") -> int:
    """The base address in this process of the arena ``handle`` that the
    server at ``address`` exported, opened once and kept while it is in
    use or recent. Each call is one use: pair it with ``release_arena``."""
    with _opened_lock:
        m = _opened.get(handle) or _retired.pop(handle, None)
        if m is None:
            index = torch.device(device).index or 0
            out = ctypes.c_void_p()
            _check(_lib().dtt_ipc_open(index, handle, ctypes.byref(out)),
                   "cudaIpcOpenMemHandle")
            m = _Mapping(int(out.value), index)
        m.retired = False
        _opened[handle] = m
        _opened.move_to_end(handle)
        m.users += 1
        old = _by_address.get(address)
        if address and old is not None and old != handle:
            _retire(old)
        if address:
            _by_address[address] = handle
        idle = [h for h, v in _opened.items() if not v.users]
        for h in idle[:max(0, len(_opened) - MAX_OPEN_ARENAS)]:
            _retire(h)
        return m.ptr


def release_arena(handle: bytes, failed: bool = False) -> None:
    """End one use of ``handle``. After a failed pull the mapping is
    retired, so the next offer of that handle opens it anew."""
    with _opened_lock:
        m = _opened.get(handle) or _retired.get(handle)
        if m is None:
            return
        m.users -= 1
        if failed and not m.retired:
            _retire(handle)
        if m.retired and not m.users:
            _retired.pop(handle, None)
            _close(m)


def open_arenas() -> int:
    """Mappings this process holds open (cached or still in use)."""
    with _opened_lock:
        return len(_opened) + len(_retired)
