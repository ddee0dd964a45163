"""Engine checkpoint and restore through the G3 disk tier.

The port's copy of the reference package's engine/checkpoint.py: the
planned-death half of crash recovery. A worker told of a reclaim
(engine/drain.py) writes its *warm* state: the sealed KV pages of its
prefix cache as block files in the G3 tier's layout (kvbm/pool.py
``_write_block_file``: a length-prefixed JSON header, then the raw bytes,
byte-identical to the reference's), the allocator's LRU order, a manifest
of the requests in flight, and the weights by reference (engine/warm.py
``fingerprint``, never a copy). Its replacement restores the pages warm
instead of prefilling the fleet's working set again. Because the block
files are the reference's, a checkpoint written by a JAX worker restores
into a port worker and the other way round.

Crash consistency: block files land first (each through a temporary name
and a rename), and the manifest's rename is the one commit point. A death
before it leaves no ``MANIFEST.json``: the restore calls that a partial
checkpoint and boots cold. The restore checks the manifest's structure and
every block against the declared format; any mismatch raises
``CheckpointCorrupt`` (the manifest) or stops the import (a block), and
never imports wrong pages.

On the card the capture is ONE page-copy launch (``gather_layers``, the
KVBM offload's route, ``TorchEngine._enqueue_offload_gather``) and one copy
to the host; the restore imports windows of 64 blocks, ONE
``scatter_layers`` launch each (``TorchEngine.import_blocks``). The
imported pages are committed to the prefix cache, so their stored events
reach KV routers with the loop's next tick.

Manifests carry no timestamps, so the same state writes the same bytes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..kvbm.layout import dtype_name, storage_dtype
from ..kvbm.pool import _read_block_file, _write_block_file
from ..runtime.config import ENV_CKPT_MAX_BLOCKS, env_int
from ..runtime.faults import FAULTS
from ..runtime.logging import get_logger

log = get_logger("engine.checkpoint")

MANIFEST_NAME = "MANIFEST.json"
FORMAT_VERSION = 1
_HASH_WIDTH = 16   # hashes as zero-padded 16-digit hex, like G3 file names
RESTORE_WINDOW = 64   # blocks a restore imports with one scatter


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed validation: the caller boots cold, never serves it."""

    code = "checkpoint_corrupt"


def weights_ref_for(source: str, cfg: Any) -> str:
    """The weights' reference (engine/warm.py ``fingerprint``: checkpoint
    path, its mtime, the config, the layout version). A checkpoint stores
    this, never the weights: the restore resolves them through the warm
    cache or the weight owner."""
    from .warm import fingerprint

    return fingerprint(source, cfg)


class CheckpointWriter:
    """Stages block files under ``<dir>/blocks/`` and commits the manifest
    atomically. ``begin_manifest`` returns a temporary file that every path
    discharges with ``commit_manifest`` or ``abort_manifest``."""

    def __init__(self, ckpt_dir: str, max_blocks: Optional[int] = None):
        self.dir = ckpt_dir
        self.blocks_dir = os.path.join(ckpt_dir, "blocks")
        os.makedirs(self.blocks_dir, exist_ok=True)
        self.max_blocks = (env_int(ENV_CKPT_MAX_BLOCKS, 4096) if max_blocks is None
                           else max_blocks)
        self.written: List[int] = []

    def _block_file(self, h: int) -> str:
        return os.path.join(self.blocks_dir, f"{h:016x}.kv")

    def write_block(self, h: int, block: np.ndarray) -> bool:
        """Write one sealed block; False once the cap is reached. A crash
        mid-write leaves only a temporary file that no manifest names."""
        if len(self.written) >= self.max_blocks:
            return False
        FAULTS.inject("checkpoint.write")
        tmp = self._block_file(h) + f".tmp{os.getpid()}"
        _write_block_file(tmp, block)
        os.replace(tmp, self._block_file(h))
        self.written.append(h)
        return True

    def begin_manifest(self, manifest: Dict[str, Any]) -> str:
        tmp = os.path.join(self.dir, MANIFEST_NAME + f".tmp{os.getpid()}")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, sort_keys=True, indent=1)
            f.flush()
            os.fsync(f.fileno())
        return tmp

    def commit_manifest(self, tmp: str) -> None:
        # the fault point sits before the rename: an armed
        # checkpoint.manifest fault is a death mid-commit, which leaves no
        # manifest, so that the restore sees a partial checkpoint
        FAULTS.inject("checkpoint.manifest")
        os.replace(tmp, os.path.join(self.dir, MANIFEST_NAME))

    def abort_manifest(self, tmp: str) -> None:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass


def save_checkpoint(ckpt_dir: str, blocks: Iterable[Tuple[int, np.ndarray]], *,
                    block_format: Dict[str, Any], radix_order: Optional[Sequence[int]] = None,
                    queue: Sequence[Dict[str, Any]] = (), weights_ref: str = "",
                    max_blocks: Optional[int] = None) -> Dict[str, Any]:
    """Write a complete checkpoint and commit its manifest; returns it.

    ``blocks`` yields ``(hash, array)`` in LRU order, oldest first (the
    allocator's eviction order). ``block_format`` is ``{"kind": "int8",
    "nbytes": N}`` (QuantizedBlockCodec buffers) or ``{"kind": "float",
    "dtype": name, "shape": [L, 2, bs, kvh, d]}``."""
    w = CheckpointWriter(ckpt_dir, max_blocks=max_blocks)
    stored: List[int] = []
    for h, arr in blocks:
        if not w.write_block(h, arr):
            break
        stored.append(h)
    manifest = {
        "version": FORMAT_VERSION,
        "blocks": [f"{h:0{_HASH_WIDTH}x}" for h in stored],
        "block_format": dict(block_format),
        "radix": [f"{h:0{_HASH_WIDTH}x}"
                  for h in (stored if radix_order is None else radix_order)],
        "queue": list(queue),
        "weights_ref": str(weights_ref),
    }
    handle = w.begin_manifest(manifest)
    try:
        w.commit_manifest(handle)
    except BaseException:
        w.abort_manifest(handle)
        raise
    return manifest


@dataclasses.dataclass
class CheckpointState:
    """A validated, committed checkpoint to restore from."""

    dir: str
    blocks: List[int]            # sealed-block hashes, LRU order
    block_format: Dict[str, Any]
    radix: List[int]             # the whole LRU snapshot (may exceed blocks)
    queue: List[Dict[str, Any]]  # the requests in flight at the drain
    weights_ref: str

    def _block_file(self, h: int) -> str:
        return os.path.join(self.dir, "blocks", f"{h:016x}.kv")

    def load_block(self, h: int) -> np.ndarray:
        """One sealed block, checked against the manifest's block format."""
        FAULTS.inject("restore.read")
        try:
            arr = _read_block_file(self._block_file(h))
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointCorrupt(f"block {h:016x} unreadable: {e}") from e
        fmt = self.block_format
        if fmt.get("kind") == "int8":
            if arr.dtype != np.uint8 or arr.shape != (int(fmt["nbytes"]),):
                raise CheckpointCorrupt(
                    f"block {h:016x} is not the manifest's int8 codec buffer "
                    f"({arr.dtype} {arr.shape} vs nbytes={fmt['nbytes']})")
        else:
            expect = tuple(fmt.get("shape", ()))
            if arr.shape != expect or dtype_name(arr.dtype) != fmt.get("dtype"):
                raise CheckpointCorrupt(
                    f"block {h:016x} does not match the manifest block format "
                    f"({dtype_name(arr.dtype)} {arr.shape} vs {fmt.get('dtype')} {expect})")
        return arr


def _parse_hashes(raw: Any, what: str) -> List[int]:
    if not isinstance(raw, list):
        raise CheckpointCorrupt(f"manifest {what} is not a list")
    out = []
    for item in raw:
        try:
            out.append(int(item, 16))
        except (TypeError, ValueError):
            raise CheckpointCorrupt(f"manifest {what} entry {item!r} is not a hash")
    return out


def load_checkpoint(ckpt_dir: str) -> CheckpointState:
    """Validate and open a checkpoint. Raises ``CheckpointCorrupt`` for
    anything short of a committed, well-formed manifest whose blocks all
    exist; a missing manifest is a partial checkpoint (blocks staged, the
    commit never made)."""
    FAULTS.inject("restore.read")
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        raise CheckpointCorrupt("no committed manifest (absent or partial checkpoint)")
    try:
        with open(mpath, encoding="utf-8") as f:
            doc = json.loads(f.read())
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"manifest unreadable: {e}") from e
    if not isinstance(doc, dict) or doc.get("version") != FORMAT_VERSION:
        raise CheckpointCorrupt(
            f"manifest version {doc.get('version') if isinstance(doc, dict) else doc!r} "
            f"!= {FORMAT_VERSION}")
    fmt = doc.get("block_format")
    if not isinstance(fmt, dict) or fmt.get("kind") not in ("int8", "float"):
        raise CheckpointCorrupt(f"bad block_format {fmt!r}")
    blocks = _parse_hashes(doc.get("blocks"), "blocks")
    radix = _parse_hashes(doc.get("radix", doc.get("blocks")), "radix")
    queue = doc.get("queue", [])
    if not isinstance(queue, list):
        raise CheckpointCorrupt("manifest queue is not a list")
    state = CheckpointState(dir=ckpt_dir, blocks=blocks, block_format=fmt, radix=radix,
                            queue=queue, weights_ref=str(doc.get("weights_ref", "")))
    # the manifest commits last: a missing block means the directory was
    # cut after the commit
    for h in blocks:
        if not os.path.isfile(state._block_file(h)):
            raise CheckpointCorrupt(f"manifest names missing block {h:016x}")
    return state


# -------------------------------------------- a TorchEngine's capture/restore
def engine_block_format(engine) -> Dict[str, Any]:
    if engine.kv_quantized:
        return {"kind": "int8", "nbytes": int(engine._codec.nbytes)}
    m = engine.mcfg
    return {"kind": "float", "dtype": dtype_name(storage_dtype(m.dtype)),
            "shape": [m.num_layers, 2, engine.cfg.block_size, m.num_kv_heads, m.head_dim]}


async def checkpoint_engine(engine, ckpt_dir: str, *, queue: Sequence[Dict[str, Any]] = (),
                            weights_ref: str = "",
                            max_blocks: Optional[int] = None) -> Dict[str, Any]:
    """Write a live engine's sealed prefix-cache pages (LRU order, oldest
    first; past the cap the newest) and ``queue`` to ``ckpt_dir``; returns
    the manifest. ONE gather launch on the engine's step thread, then the
    copy to the host and the file writes off the event loop. A rank of a
    TP group refuses (ROADMAP.md Queue 1 item 6)."""
    engine._refuse_at_tp("drain and checkpoint")
    alloc = engine.allocator
    pending = [(bid, alloc._hash_of[bid], 0) for bid in alloc._lru if bid in alloc._hash_of]
    cap = env_int(ENV_CKPT_MAX_BLOCKS, 4096) if max_blocks is None else max_blocks
    if len(pending) > cap:
        pending = pending[-cap:]   # keep the hottest (most recent) suffix
    loop = asyncio.get_running_loop()
    blocks: List[Tuple[int, np.ndarray]] = []
    if pending:
        gathered, ready = await loop.run_in_executor(
            engine._executor, engine._enqueue_offload_gather, pending)

        def fetch() -> List[np.ndarray]:
            if ready is not None:
                ready.synchronize()
            return engine._storage_blocks(gathered, len(pending))

        blocks = [(h, arr) for (_, h, _), arr in zip(
            pending, await loop.run_in_executor(None, fetch))]
    return await loop.run_in_executor(None, lambda: save_checkpoint(
        ckpt_dir, blocks, block_format=engine_block_format(engine),
        radix_order=[h for _, h, _ in pending], queue=queue, weights_ref=weights_ref,
        max_blocks=cap))


def _record_restore(result: Dict[str, Any], ckpt_dir: str) -> Dict[str, Any]:
    """The restore's outcome on the flight recorder, under the synthetic id
    ``restore`` (as engine/drain.py's ``drain`` timeline)."""
    from ..runtime.flight_recorder import get_flight_recorder

    get_flight_recorder().record(
        "restore", "checkpoint_restore", mode=result["mode"], blocks=result["blocks"],
        queued=len(result.get("queue", ())), ckpt_dir=ckpt_dir,
        **({"reason": result["reason"]} if "reason" in result else {}))
    return result


async def restore_engine(engine, ckpt_dir: str) -> Dict[str, Any]:
    """Import a checkpoint's sealed pages into a fresh engine. Never raises
    on a bad checkpoint: it reports a cold boot. Returns ``{"mode": "warm" |
    "partial" | "cold", "blocks": n, "queue": [...], "windows": w,
    "seconds": s}``; ``partial`` means a torn block cut the import short
    (the content-addressed prefix before it is live). The outcome is also
    a ``checkpoint_restore`` event on the ``restore`` flight timeline.
    A rank of a TP group refuses (ROADMAP.md Queue 1 item 6)."""
    engine._refuse_at_tp("drain and checkpoint")
    loop = asyncio.get_running_loop()
    t0 = time.perf_counter()
    try:
        state = await loop.run_in_executor(None, load_checkpoint, ckpt_dir)
    except CheckpointCorrupt as e:
        log.warning("checkpoint at %s rejected (%s); cold boot", ckpt_dir, e)
        return _record_restore({"mode": "cold", "blocks": 0, "queue": [], "reason": str(e),
                                "windows": 0, "seconds": time.perf_counter() - t0}, ckpt_dir)
    if state.block_format != engine_block_format(engine):
        log.warning("checkpoint block format %s does not match this engine (%s); cold boot",
                    state.block_format, engine_block_format(engine))
        return _record_restore({"mode": "cold", "blocks": 0, "queue": [], "reason": "format",
                                "windows": 0, "seconds": time.perf_counter() - t0}, ckpt_dir)
    imported = windows = 0
    truncated = False
    for lo in range(0, len(state.blocks), RESTORE_WINDOW):
        batch = state.blocks[lo:lo + RESTORE_WINDOW]
        try:
            arrs = [await loop.run_in_executor(None, state.load_block, h) for h in batch]
        except CheckpointCorrupt as e:
            # the pages imported so far are content-addressed and valid:
            # keep the warm prefix, stop at the first torn block
            log.warning("restore stopped at a bad block (%s)", e)
            truncated = True
            break
        arr = (engine._codec.decode_many(np.stack(arrs))
               if state.block_format["kind"] == "int8" else np.stack(arrs))
        got = await engine.import_blocks(list(batch), arr)
        imported += got
        windows += got > 0   # a pool without room imports (and launches) nothing
    if not imported:
        mode = "cold"
    elif truncated or imported < len(state.blocks):
        mode = "partial"
    else:
        mode = "warm"
    return _record_restore({"mode": mode, "blocks": imported, "queue": list(state.queue),
                            "windows": windows, "seconds": time.perf_counter() - t0}, ckpt_dir)
