"""Batched KV page moves on the GPU: counterpart of the reference's
ops/block_copy.py (``gather_blocks``, ``scatter_blocks``, ``copy_blocks``,
the int8 pair wrappers, and the TPU kernels ``_gather_kernel`` :30,
``_scatter_kernel`` :65 and ``_copy_kernel`` :110).

The kernel is ``csrc/block_copy.cu``: one page-move kernel over a
descriptor table, each entry one array (its bases, page strides, page
bytes, and which side the ids index), the work flattened over (page,
entry, 4 KiB chunk) with one warp per chunk and 8 16-byte loads per lane in
flight. Bytes bound it on the H100, and a small move its launch, so every
move here is ONE launch:

- ``gather_blocks`` / ``scatter_blocks`` / ``copy_blocks`` on one array of
  any dtype, and the ``*_quant`` pair wrappers, which move an int8
  payload and its f32 scale rows together (table entries passed by value);
- ``gather_layers`` / ``scatter_layers``: every layer's K and V pages (and
  scale rows) of an engine's caches at once, in the stacked host-storage
  layout ``[n, L, 2, bs, kvh, d]`` (int8: payload plus ``[n, L, 2, kvh]``
  scales) that the KVBM offload copies to the host and the onboard reads
  back. Their table is built once per set of caches (``layer_moves``, pure
  Python) and kept on the device; only the ids and the stacked buffer
  change per call.
- ``gather_layers_packed``: gather_layers' move into ONE byte buffer
  ``[n, block_bytes]`` in the blocks' storage format (kvbm/layout): the
  stacked pages of a float cache, and for int8 each block's payload bytes
  then its scale bytes (``QuantizedBlockCodec``'s buffer), the native
  transfer arena's slots (engine/transfer.py);
- ``gather_layers_wire`` / ``scatter_layers_wire``: the same move in the
  KV transfer wire's layer-major order ``[L, 2, n, bs, kvh, d]`` (int8:
  plus scales ``[L, 2, n, kvh]``), engine/transfer.py's one gather per
  pull and one scatter per import. Their table (``wire_moves``: one entry
  per layer and K or V, the block index from the ids) depends on n, so it
  is kept per (caches, n).

Each has a plain version beside it (``*_ref``). On CPU tensors each
wrapper runs its plain version; on CUDA tensors it launches the kernel or
raises. The reference donates the cache buffer to its scatter and copy;
here they write the cache tensor IN PLACE and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ._build import Kernel, check_cuda_tensor
from .quant import QuantizedKV, is_quantized

# one C entry, counted by the move it makes: gather (gather_blocks, the
# pair's, gather_layers), scatter (likewise) and copy
GATHER = Kernel("block_copy.cu", "dtt_page_moves", n_ptrs=6, n_ints=3)
SCATTER = Kernel("block_copy.cu", "dtt_page_moves", n_ptrs=6, n_ints=3)
COPY = Kernel("block_copy.cu", "dtt_page_moves", n_ptrs=6, n_ints=3)

# csrc/block_copy.cu's PageMove, 64 bytes
MOVE_DTYPE = np.dtype([
    ("src", "<i8"), ("dst", "<i8"), ("src_stride", "<i8"), ("dst_stride", "<i8"),
    ("page_bytes", "<i8"), ("w0", "<i8"), ("src_limit", "<i4"), ("dst_limit", "<i4"),
    ("flags", "<i4"), ("nchunk", "<i4"),
])
CHUNK_BYTES = 4096   # bytes per warp item (the kernel's CHUNK)
SRC_IDS, DST_IDS = 1, 2


def rel_src(buffer: int) -> int:
    """Flag: the source side is an offset into launch buffer 1 or 2."""
    return buffer << 2


def rel_dst(buffer: int) -> int:
    """Flag: the destination side is an offset into launch buffer 1 or 2."""
    return buffer << 4


@dataclasses.dataclass(frozen=True)
class Move:
    """One array of a page move: page m of the destination (``dst`` +
    index * ``dst_stride``) gets page m of the source; the side whose flag
    is set is indexed by the launch's ids (outside ``[0, limit)``: nothing
    moves, a gather leaves zeros)."""
    src: int
    dst: int
    src_stride: int
    dst_stride: int
    page_bytes: int
    src_limit: int
    dst_limit: int
    flags: int


def move_table(moves: Sequence[Move]) -> Tuple[np.ndarray, int]:
    """The kernel's descriptor table for ``moves`` and W, the items (4 KiB
    chunks) of one page index over all entries."""
    table = np.zeros(len(moves), MOVE_DTYPE)
    w = 0
    for i, mv in enumerate(moves):
        n = -(-mv.page_bytes // CHUNK_BYTES)
        table[i] = (mv.src, mv.dst, mv.src_stride, mv.dst_stride, mv.page_bytes, w,
                    mv.src_limit, mv.dst_limit, mv.flags, n)
        w += n
    return table, w


def layer_moves(arrays: Sequence[Tuple[int, int]], num_blocks: int, gather: bool,
                buffer: int) -> List[Move]:
    """The moves between per-layer caches and one stacked buffer (launch
    buffer ``buffer``, 1 or 2): ``arrays`` is [(address, page bytes)] in
    stacked order (layer 0 K, layer 0 V, layer 1 K, ...), and page m of
    array i sits at byte ``m * row + i * page`` of the buffer, ``row`` the
    sum of the pages: the layout of a contiguous ``[n, L, 2, *page]``
    tensor. ``gather``: cache pages ids[m] -> buffer; else buffer -> cache
    pages ids[m]."""
    row = sum(pb for _, pb in arrays)
    moves, off = [], 0
    for addr, pb in arrays:
        if gather:
            moves.append(Move(addr, off, pb, row, pb, num_blocks, 0,
                              SRC_IDS | rel_dst(buffer)))
        else:
            moves.append(Move(off, addr, row, pb, pb, 0, num_blocks,
                              DST_IDS | rel_src(buffer)))
        off += pb
    return moves


def wire_moves(arrays: Sequence[Tuple[int, int]], num_blocks: int, n: int, gather: bool,
               buffer: int) -> List[Move]:
    """The moves between per-layer caches and one layer-major buffer
    (launch buffer ``buffer``): ``arrays`` as in ``layer_moves``, and page m
    of array i at byte ``(i * n + m) * page`` of the buffer: the layout of
    a contiguous ``[L, 2, n, *page]`` tensor, the transfer wire's."""
    moves = []
    for i, (addr, pb) in enumerate(arrays):
        off = i * n * pb
        if gather:
            moves.append(Move(addr, off, pb, pb, pb, num_blocks, 0, SRC_IDS | rel_dst(buffer)))
        else:
            moves.append(Move(off, addr, pb, pb, pb, 0, num_blocks, DST_IDS | rel_src(buffer)))
    return moves


# ----------------------------------------------------------- plain versions
def gather_blocks_ref(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    return cache[block_ids.long()]


def scatter_blocks_ref(cache: torch.Tensor, block_ids: torch.Tensor,
                       blocks: torch.Tensor) -> torch.Tensor:
    cache[block_ids.long()] = blocks
    return cache


def copy_blocks_ref(cache: torch.Tensor, src_ids: torch.Tensor,
                    dst_ids: torch.Tensor) -> torch.Tensor:
    cache[dst_ids.long()] = cache[src_ids.long()]
    return cache


Caches = Sequence[Union[torch.Tensor, QuantizedKV]]
Pages = Union[torch.Tensor, QuantizedKV]


def _groups(k_caches: Caches, v_caches: Caches) -> List[List[torch.Tensor]]:
    """The arrays of a set of layer caches in stacked order, one list per
    stacked buffer: [[k0, v0, k1, v1, ...]], or for int8 the payloads and
    the scale rows."""
    pairs = list(zip(k_caches, v_caches))
    if pairs and is_quantized(pairs[0][0]):
        return [[c.data for kv in pairs for c in kv], [c.scale for kv in pairs for c in kv]]
    return [[c for kv in pairs for c in kv]]


def _split(pages: Pages, quantized: bool) -> List[torch.Tensor]:
    if not quantized:
        return [pages]
    data, scale = (pages.data, pages.scale) if isinstance(pages, QuantizedKV) else pages
    return [data, scale]


def gather_layers_ref(k_caches: Caches, v_caches: Caches, ids: torch.Tensor) -> Pages:
    """Pages ``ids`` of every layer stacked as ``[n, L, 2, ...]`` (per-layer
    ``cache[ids]`` and ``torch.stack``); for int8 caches a QuantizedKV of
    the payload ``[n, L, 2, bs, kvh, d]`` and scales ``[n, L, 2, kvh]``."""
    out = [torch.stack([gather_blocks_ref(c, ids) for c in grp], 1).unflatten(1, (-1, 2))
           for grp in _groups(k_caches, v_caches)]
    return QuantizedKV(*out) if len(out) == 2 else out[0]


def gather_layers_packed_ref(k_caches: Caches, v_caches: Caches,
                             ids: torch.Tensor) -> torch.Tensor:
    """gather_layers_ref as one uint8 buffer ``[n, block_bytes]``: each
    block's payload bytes, then (int8) its scale bytes."""
    got = gather_layers_ref(k_caches, v_caches, ids)
    n = ids.shape[0]
    return torch.cat([t.contiguous().reshape(n, -1).view(torch.uint8)
                      for t in _split(got, isinstance(got, QuantizedKV))], 1)


def scatter_layers_ref(k_caches: Caches, v_caches: Caches, ids: torch.Tensor,
                       pages: Pages) -> None:
    """``cache[ids] = pages[:, layer, k-or-v]`` for every layer, in place:
    the inverse of gather_layers_ref."""
    groups = _groups(k_caches, v_caches)
    for grp, stacked in zip(groups, _split(pages, len(groups) == 2)):
        for i, c in enumerate(grp):
            scatter_blocks_ref(c, ids, stacked[:, i // 2, i % 2])


def gather_layers_wire_ref(k_caches: Caches, v_caches: Caches, ids: torch.Tensor) -> Pages:
    """gather_layers_ref permuted to the wire's ``[L, 2, n, ...]`` (int8:
    payload and scales ``[L, 2, n, kvh]``), contiguous."""
    got = gather_layers_ref(k_caches, v_caches, ids)
    out = [t.permute(1, 2, 0, *range(3, t.dim())).contiguous()
           for t in _split(got, isinstance(got, QuantizedKV))]
    return QuantizedKV(*out) if len(out) == 2 else out[0]


def scatter_layers_wire_ref(k_caches: Caches, v_caches: Caches, ids: torch.Tensor,
                            pages: Pages) -> None:
    """scatter_layers_ref of wire-order ``pages`` (gather_layers_wire's
    layout), permuted back to ``[n, L, 2, ...]``."""
    parts = [t.permute(2, 0, 1, *range(3, t.dim()))
             for t in _split(pages, len(_groups(k_caches, v_caches)) == 2)]
    scatter_layers_ref(k_caches, v_caches, ids,
                       QuantizedKV(*parts) if len(parts) == 2 else parts[0])


# ----------------------------------------------------------------- wrappers
def _page_bytes(cache: torch.Tensor) -> int:
    if cache.device.type != "cuda":
        raise ValueError(f"cache: expected a CUDA tensor, got {cache.device}")
    if not cache.is_contiguous() or cache.dim() < 1:
        raise ValueError("cache: must be contiguous with a leading block dim")
    return cache[0].numel() * cache.element_size() if cache.shape[0] else 0


def _check_ids(name: str, ids: torch.Tensor) -> None:
    check_cuda_tensor(name, ids, torch.int32, 1)


def _check_pages(cache: torch.Tensor, blocks: torch.Tensor, M: int) -> None:
    if blocks.dtype != cache.dtype or tuple(blocks.shape) != (M, *cache.shape[1:]):
        raise ValueError(
            f"blocks {blocks.dtype} {tuple(blocks.shape)} are not {M} pages of "
            f"{cache.dtype} {tuple(cache.shape[1:])}"
        )
    if not blocks.is_contiguous() or blocks.device != cache.device:
        raise ValueError("blocks: must be contiguous on the cache's device")


def _launch(kernel: Kernel, src_ids, dst_ids, moves: List[Move], M: int) -> None:
    """One launch of ``moves`` (at most 4, the kernel's MAX_INLINE, passed by
    value)."""
    moves = [mv for mv in moves if mv.page_bytes]
    if not M or not moves:
        return
    table, W = move_table(moves)
    # the entry point copies the host table into the launch's parameters
    kernel.launch([src_ids, dst_ids, None, table.ctypes.data, None, None],
                  [len(moves), W, M])


def _gather_moves(cache: torch.Tensor, out: torch.Tensor) -> Move:
    page = _page_bytes(cache)
    return Move(cache.data_ptr(), out.data_ptr(), page, page, page, cache.shape[0], 0, SRC_IDS)


def _scatter_moves(cache: torch.Tensor, blocks: torch.Tensor) -> Move:
    page = _page_bytes(cache)
    return Move(blocks.data_ptr(), cache.data_ptr(), page, page, page, 0, cache.shape[0],
                DST_IDS)


def gather_blocks(cache: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """Pages ``cache[block_ids]`` as a fresh contiguous [M, ...] tensor."""
    if cache.device.type == "cpu":
        return gather_blocks_ref(cache, block_ids)
    _check_ids("block_ids", block_ids)
    out = torch.empty((block_ids.shape[0], *cache.shape[1:]), dtype=cache.dtype,
                      device=cache.device)
    _launch(GATHER, block_ids, None, [_gather_moves(cache, out)], block_ids.shape[0])
    return out


def scatter_blocks(cache: torch.Tensor, block_ids: torch.Tensor,
                   blocks: torch.Tensor) -> torch.Tensor:
    """``cache[block_ids] = blocks`` in place; returns ``cache``."""
    if cache.device.type == "cpu":
        return scatter_blocks_ref(cache, block_ids, blocks)
    _check_ids("block_ids", block_ids)
    _check_pages(cache, blocks, block_ids.shape[0])
    _launch(SCATTER, None, block_ids, [_scatter_moves(cache, blocks)], block_ids.shape[0])
    return cache


def _upload(ids: torch.Tensor, device: torch.device) -> torch.Tensor:
    """int32 ids on ``device``; host ids go through pinned memory, so the
    upload does not wait for the device to drain (a pageable copy would)."""
    ids = ids.to(torch.int32)
    if ids.device.type == "cpu":
        ids = ids.pin_memory().to(device, non_blocking=True)
    return ids


def copy_blocks(cache: torch.Tensor, src_ids: torch.Tensor,
                dst_ids: torch.Tensor) -> torch.Tensor:
    """``cache[dst_ids] = cache[src_ids]`` in place (defrag / prefix fork).
    ``src_ids`` and ``dst_ids`` must be disjoint, as the reference requires
    (a page both read and written would be read before or after its write
    depending on the order the blocks run in); the check reads the ids on
    the host, so ids passed as CPU tensors keep it free of a device sync."""
    if src_ids.shape != dst_ids.shape:
        raise ValueError("src_ids and dst_ids must have the same length")
    overlap = set(src_ids.tolist()) & set(dst_ids.tolist())
    if overlap:
        raise ValueError(f"copy_blocks: src and dst share pages {sorted(overlap)[:8]}")
    if cache.device.type == "cpu":
        return copy_blocks_ref(cache, src_ids, dst_ids)
    page = _page_bytes(cache)
    src_ids, dst_ids = (_upload(i, cache.device) for i in (src_ids, dst_ids))
    _check_ids("src_ids", src_ids)
    _check_ids("dst_ids", dst_ids)
    nb = cache.shape[0]
    _launch(COPY, src_ids, dst_ids,
            [Move(cache.data_ptr(), cache.data_ptr(), page, page, page, nb, nb,
                  SRC_IDS | DST_IDS)], src_ids.shape[0])
    return cache


# -- quantized caches (ops/quant.QuantizedKV) --------------------------------
# A quantized page move is two arrays, the int8 payload and its f32 scale
# row, that MUST travel together (a payload under the wrong scale is silent
# corruption, not an error): one launch moves both.
def gather_blocks_quant(cache: QuantizedKV, block_ids: torch.Tensor) -> QuantizedKV:
    """QuantizedKV pages -> (payload [M, bs, kvh, d] int8, scales [M, kvh])."""
    if cache.data.device.type == "cpu":
        return QuantizedKV(gather_blocks_ref(cache.data, block_ids),
                           gather_blocks_ref(cache.scale, block_ids))
    _check_ids("block_ids", block_ids)
    M = block_ids.shape[0]
    out = QuantizedKV(*(torch.empty((M, *c.shape[1:]), dtype=c.dtype, device=c.device)
                        for c in (cache.data, cache.scale)))
    _launch(GATHER, block_ids, None, [_gather_moves(cache.data, out.data),
                                      _gather_moves(cache.scale, out.scale)], M)
    return out


def scatter_blocks_quant(cache: QuantizedKV, block_ids: torch.Tensor,
                         blocks: QuantizedKV) -> QuantizedKV:
    """Scatter (payload, scales) pages into a QuantizedKV cache in place."""
    if cache.data.device.type == "cpu":
        scatter_blocks_ref(cache.data, block_ids, blocks.data)
        scatter_blocks_ref(cache.scale, block_ids, blocks.scale)
        return cache
    _check_ids("block_ids", block_ids)
    M = block_ids.shape[0]
    _check_pages(cache.data, blocks.data, M)
    _check_pages(cache.scale, blocks.scale, M)
    _launch(SCATTER, None, block_ids, [_scatter_moves(cache.data, blocks.data),
                                       _scatter_moves(cache.scale, blocks.scale)], M)
    return cache


# -- every layer at once (the engine's KVBM offload and onboard) -------------
# layer_table_key -> (device table, entries, W); an engine's caches never
# move, so its two tables are built once and a call only reads the arrays'
# addresses
_layer_tables: Dict[tuple, Tuple[torch.Tensor, int, int]] = {}


def layer_table_key(groups: List[List[torch.Tensor]], gather: bool) -> tuple:
    """What a cached layer table depends on: the direction, the device,
    each group's page shape AND dtype (the table holds page byte counts),
    and the arrays' addresses."""
    return (gather, str(groups[0][0].device),
            tuple((tuple(g[0].shape), g[0].dtype) for g in groups),
            tuple(c.data_ptr() for grp in groups for c in grp))


def _layer_table(groups: List[List[torch.Tensor]], gather: bool, wire_n: int = 0,
                 packed: bool = False):
    """The device table of a layer-batched move: the stacked layout, with
    ``wire_n`` the wire's layer-major layout of that many pages, or
    ``packed``: every group's arrays in one row of one buffer."""
    key = (layer_table_key(groups, gather), wire_n, packed)
    hit = _layer_tables.get(key)
    if hit is None:
        for grp in groups:
            if any(c.shape != grp[0].shape or c.dtype != grp[0].dtype for c in grp):
                raise ValueError("every layer cache must have one shape and dtype")
        if packed:
            moves = layer_moves([(c.data_ptr(), _page_bytes(c)) for grp in groups
                                 for c in grp], groups[0][0].shape[0], gather, 1)
        else:
            moves = []
            for i, grp in enumerate(groups):
                arrays = [(c.data_ptr(), _page_bytes(c)) for c in grp]
                moves += (wire_moves(arrays, grp[0].shape[0], wire_n, gather, i + 1)
                          if wire_n else layer_moves(arrays, grp[0].shape[0], gather, i + 1))
        table, W = move_table(moves)
        # through pinned memory: the upload does not wait for the device
        dev = torch.from_numpy(table.view(np.uint8)).pin_memory().to(
            groups[0][0].device, non_blocking=True)
        if len(_layer_tables) >= 64:   # caches of engines long gone, old n
            _layer_tables.clear()
        hit = _layer_tables[key] = (dev, len(moves), W)
    return hit


def _stacked_shape(c: torch.Tensor, n: int, L: int) -> tuple:
    return (n, L, 2, *c.shape[1:])


def gather_layers(k_caches: Caches, v_caches: Caches, ids: torch.Tensor) -> Pages:
    """Pages ``ids`` of every layer's K and V cache in ONE launch, stacked
    as the host storage layout ``[n, L, 2, bs, kvh, d]``; for int8 caches a
    QuantizedKV of that payload and the scales ``[n, L, 2, kvh]``. Plain
    version: gather_layers_ref."""
    groups = _groups(k_caches, v_caches)
    if groups[0][0].device.type == "cpu":
        return gather_layers_ref(k_caches, v_caches, ids)
    _check_ids("ids", ids)
    n, L = ids.shape[0], len(k_caches)
    bufs = [torch.empty(_stacked_shape(g[0], n, L), dtype=g[0].dtype, device=g[0].device)
            for g in groups]
    if n:
        table, count, W = _layer_table(groups, gather=True)
        GATHER.launch([ids, None, table, None, *bufs, *[None] * (2 - len(bufs))],
                      [count, W, n])
    return QuantizedKV(*bufs) if len(bufs) == 2 else bufs[0]


def gather_layers_packed(k_caches: Caches, v_caches: Caches, ids: torch.Tensor,
                         out: torch.Tensor = None) -> torch.Tensor:
    """gather_layers' pages in ONE launch as one uint8 buffer ``[n,
    block_bytes]`` in the blocks' storage format: a float block's stacked
    pages, an int8 block's payload bytes then its scale bytes (the
    QuantizedBlockCodec buffer), into ``out`` when given. Plain version:
    gather_layers_packed_ref."""
    groups = _groups(k_caches, v_caches)
    n = ids.shape[0]
    if groups[0][0].device.type == "cpu":
        got = gather_layers_packed_ref(k_caches, v_caches, ids)
        return got if out is None else out.copy_(got)
    _check_ids("ids", ids)
    # every cache of a group has one page (the table checks it)
    row = sum(len(grp) * _page_bytes(grp[0]) for grp in groups)
    if out is None:
        out = torch.empty((n, row), dtype=torch.uint8, device=groups[0][0].device)
    elif (out.dtype != torch.uint8 or tuple(out.shape) != (n, row) or not out.is_contiguous()
          or out.device != groups[0][0].device):
        raise ValueError(f"out: expected contiguous uint8 {(n, row)} on the caches' device")
    if n:
        table, count, W = _layer_table(groups, gather=True, packed=True)
        GATHER.launch([ids, None, table, None, out, None], [count, W, n])
    return out


def scatter_layers(k_caches: Caches, v_caches: Caches, ids: torch.Tensor,
                   pages: Pages) -> None:
    """``cache[ids] = pages[:, layer, k-or-v]`` for every layer's K and V
    cache in ONE launch, in place; ``pages`` in gather_layers' layout, on
    the caches' device. Plain version: scatter_layers_ref."""
    groups = _groups(k_caches, v_caches)
    if groups[0][0].device.type == "cpu":
        return scatter_layers_ref(k_caches, v_caches, ids, pages)
    _check_ids("ids", ids)
    bufs = _split(pages, len(groups) == 2)
    n, L = ids.shape[0], len(k_caches)
    _check_stacked(groups, bufs, _stacked_shape, n, L)
    if n:
        table, count, W = _layer_table(groups, gather=False)
        SCATTER.launch([None, ids, table, None, *bufs, *[None] * (2 - len(bufs))],
                       [count, W, n])


def _wire_shape(c: torch.Tensor, n: int, L: int) -> tuple:
    return (L, 2, n, *c.shape[1:])


def _check_stacked(groups, bufs, shape_of, n: int, L: int) -> None:
    for g, b in zip(groups, bufs):
        want = shape_of(g[0], n, L)
        if b.dtype != g[0].dtype or tuple(b.shape) != want:
            raise ValueError(f"pages {b.dtype} {tuple(b.shape)} are not {g[0].dtype} {want}")
        if not b.is_contiguous() or b.device != g[0].device:
            raise ValueError("pages: must be contiguous on the caches' device")


def gather_layers_wire(k_caches: Caches, v_caches: Caches, ids: torch.Tensor,
                       out: Pages = None) -> Pages:
    """Pages ``ids`` of every layer's K and V cache in ONE launch, in the
    transfer wire's layer-major layout ``[L, 2, n, bs, kvh, d]`` (int8: a
    QuantizedKV of that payload and the scales ``[L, 2, n, kvh]``), into
    ``out`` when given (a staging buffer of that layout) or a fresh
    buffer. Plain version: gather_layers_wire_ref."""
    groups = _groups(k_caches, v_caches)
    if groups[0][0].device.type == "cpu":
        got = gather_layers_wire_ref(k_caches, v_caches, ids)
        if out is None:
            return got
        for o, g in zip(_split(out, len(groups) == 2), _split(got, len(groups) == 2)):
            o.copy_(g)
        return out
    _check_ids("ids", ids)
    n, L = ids.shape[0], len(k_caches)
    if out is None:
        bufs = [torch.empty(_wire_shape(g[0], n, L), dtype=g[0].dtype, device=g[0].device)
                for g in groups]
    else:
        bufs = _split(out, len(groups) == 2)
        _check_stacked(groups, bufs, _wire_shape, n, L)
    if n:
        table, count, W = _layer_table(groups, gather=True, wire_n=n)
        GATHER.launch([ids, None, table, None, *bufs, *[None] * (2 - len(bufs))],
                      [count, W, n])
    return QuantizedKV(*bufs) if len(bufs) == 2 else bufs[0]


def scatter_layers_wire(k_caches: Caches, v_caches: Caches, ids: torch.Tensor,
                        pages: Pages) -> None:
    """``cache[ids] = pages[layer, k-or-v]`` for every layer's K and V cache
    in ONE launch, in place; ``pages`` in gather_layers_wire's layout, on
    the caches' device. Plain version: scatter_layers_wire_ref."""
    groups = _groups(k_caches, v_caches)
    if groups[0][0].device.type == "cpu":
        return scatter_layers_wire_ref(k_caches, v_caches, ids, pages)
    _check_ids("ids", ids)
    bufs = _split(pages, len(groups) == 2)
    n, L = ids.shape[0], len(k_caches)
    _check_stacked(groups, bufs, _wire_shape, n, L)
    if n:
        table, count, W = _layer_table(groups, gather=False, wire_n=n)
        SCATTER.launch([None, ids, table, None, *bufs, *[None] * (2 - len(bufs))],
                       [count, W, n])
