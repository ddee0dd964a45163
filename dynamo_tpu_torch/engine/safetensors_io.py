"""A safetensors reader on torch, json and mmap.

Counterpart of the reference's ``_open_safetensors`` (engine/weights.py),
which reads through the ``safetensors`` package and numpy: numpy has no
bfloat16, so that path needs ``ml_dtypes``. This reader needs neither.

A shard is an 8-byte little-endian header length, a JSON header (name ->
``{"dtype", "shape", "data_offsets": [begin, end]}``, plus an optional
``__metadata__`` entry), then the raw little-endian data; offsets count
from the end of the header. Each tensor's bytes are viewed over a
copy-on-write mmap of the file (writable, so ``torch.frombuffer`` does not
warn, and nothing is ever written back), copied to the target device as
bytes, and the view is dropped before the next tensor: no tensor that
``read_safetensors`` yields refers to the file.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, List, Tuple

import torch

from ..device import DeviceLike, resolve_device

# safetensors dtype names -> torch dtypes
DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}

# a header past this is not a safetensors file (the format's own limit)
MAX_HEADER_BYTES = 100 * 1024 * 1024


def shard_files(path: str) -> List[str]:
    """Every ``*.safetensors`` file of the directory ``path``, in sorted
    name order (the reference's order)."""
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.endswith(".safetensors")]


def read_header(fname: str, size: int, head: bytes) -> Tuple[int, Dict[str, dict]]:
    """(data start, {name: entry}) of one shard, every entry checked
    against the file: a known dtype, ``data_offsets`` spanning exactly
    shape x itemsize bytes, inside the file."""
    if size < 8:
        raise ValueError(f"{fname}: {size} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", head[:8])
    if n > MAX_HEADER_BYTES or 8 + n > size:
        raise ValueError(f"{fname}: header of {n} bytes runs past the file ({size} bytes)")
    try:
        header = json.loads(bytes(head[8:8 + n]))
    except ValueError as e:
        raise ValueError(f"{fname}: unreadable header: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{fname}: the header is not a JSON object")
    header.pop("__metadata__", None)
    start = 8 + n
    for name, t in header.items():
        if not isinstance(t, dict) or not {"dtype", "shape", "data_offsets"} <= set(t):
            raise ValueError(f"{fname}: tensor {name!r} lacks dtype, shape or data_offsets")
        if t["dtype"] not in DTYPES:
            raise ValueError(f"{fname}: tensor {name!r} has unknown dtype {t['dtype']!r}")
        shape, (begin, end) = t["shape"], t["data_offsets"]
        if any(not isinstance(s, int) or s < 0 for s in shape):
            raise ValueError(f"{fname}: tensor {name!r} has a bad shape {shape}")
        numel = 1
        for s in shape:
            numel *= s
        nbytes = numel * DTYPES[t["dtype"]].itemsize
        if not 0 <= begin <= end or end - begin != nbytes:
            raise ValueError(f"{fname}: tensor {name!r} data_offsets {[begin, end]} "
                             f"disagree with its shape {shape} x {t['dtype']} "
                             f"({nbytes} bytes)")
        if start + end > size:
            raise ValueError(f"{fname}: tensor {name!r} runs past the end of the file")
    return start, header


def tensor_from_buffer(buf, offset: int, nbytes: int, dtype: torch.dtype, shape,
                       device: torch.device) -> torch.Tensor:
    """A fresh tensor on ``device`` from ``nbytes`` raw little-endian bytes
    of ``buf`` (an mmap) at ``offset``: the bytes are copied first (any
    offset is aligned for uint8), then viewed in ``dtype`` on the aligned
    copy; the view over ``buf`` is dropped before returning."""
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    view = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes, offset=offset)
    out = view.to(device, copy=True)
    del view
    return out.view(dtype).reshape(shape)


def read_safetensors(path: str, device: DeviceLike = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yields ``(name, tensor)`` for every tensor of every shard in the
    directory ``path``, or of the one file ``path`` (shards, and the
    tensors of a shard, in sorted name order: the reference's order), each
    a fresh tensor on ``device`` in its stored dtype and shape."""
    device = resolve_device(device)
    for fname in [path] if os.path.isfile(path) else shard_files(path):
        with open(fname, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                raise ValueError(f"{fname}: empty file")
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        try:
            start, header = read_header(fname, size, mm)
            for name in sorted(header):
                t = header[name]
                begin, end = t["data_offsets"]
                out = tensor_from_buffer(mm, start + begin, end - begin, DTYPES[t["dtype"]],
                                         t["shape"], device)
                yield name, out
                del out
        finally:
            mm.close()
