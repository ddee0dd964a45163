"""Multi-tier KV block pools: G2 host DRAM, G3 local disk, G4 remote.

Counterpart of the reference package's kvbm/pool.py. Sealed device blocks
are written through to the host pool (and to the G4 remote store,
kvbm/remote.py or the sharded fleet of kvbm/distributed.py) asynchronously;
host overflow spills to disk; a prefix lookup that misses device memory
onboards from host, disk or the remote store back into device pages before
prefill. The hashes newly written to a local tier feed the global KV
directory (kvbm/directory.py, ``drain_stored``).

Offloads enqueue with a priority: lower values transfer first, FIFO within
a priority, and the bounded queue sheds the lowest-priority work under
backpressure instead of stalling the engine.

A block is one contiguous host array in the engine's KV storage format
(kvbm/layout.block_shape_for): ``[L, 2, bs, kvh, d]`` in the model dtype
for float caches (bf16 as bit patterns), or the flat int8+scales codec
buffer for ``kv_dtype="int8"``. The pools themselves are format-agnostic.
"""

from __future__ import annotations

import heapq
import json
import logging
import os
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tokens import SequenceHash
from .layout import dtype_from_name, dtype_name

log = logging.getLogger("dynamo_tpu_torch.kvbm")


class HostBlockPool:
    """G2: content-addressed host DRAM pool with LRU eviction."""

    def __init__(self, capacity_bytes: int, block_nbytes: int):
        self.capacity_blocks = max(0, capacity_bytes // max(block_nbytes, 1))
        self.block_nbytes = block_nbytes
        self._data: OrderedDict[SequenceHash, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __contains__(self, h: SequenceHash) -> bool:
        with self._lock:
            return h in self._data

    def __len__(self) -> int:
        return len(self._data)

    def store(self, h: SequenceHash, block: np.ndarray) -> Optional[Tuple[SequenceHash, np.ndarray]]:
        """Insert; returns an evicted (hash, block) for spillover, if any."""
        if self.capacity_blocks == 0:
            return (h, block)
        evicted = None
        with self._lock:
            if h in self._data:
                self._data.move_to_end(h)
                return None
            if len(self._data) >= self.capacity_blocks:
                evicted = self._data.popitem(last=False)
            self._data[h] = block
        return evicted

    def get(self, h: SequenceHash) -> Optional[np.ndarray]:
        with self._lock:
            block = self._data.get(h)
            if block is not None:
                self._data.move_to_end(h)
                self.hits += 1
            else:
                self.misses += 1
            return block

    def clear(self) -> List[SequenceHash]:
        """Drop every block; returns the dropped hashes."""
        with self._lock:
            gone = list(self._data)
            self._data.clear()
        return gone


# G3 file format (the reference's): 4-byte little-endian header length, json
# {"dtype","shape"}, raw C-order bytes. The dtype rides an explicit header
# resolved by layout.dtype_from_name, so bf16 blocks round-trip without
# ml_dtypes. Legacy .npy files are still readable.
_NPY_MAGIC = b"\x93NUMPY"


def _write_block_file(path: str, block: np.ndarray) -> None:
    header = json.dumps({"dtype": dtype_name(block.dtype), "shape": list(block.shape)}).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(4, "little"))
        f.write(header)
        f.write(np.ascontiguousarray(block).tobytes())


def _read_block_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(4)
        if head[:4].startswith(_NPY_MAGIC[:4]):
            f.seek(0)
            return np.load(f, allow_pickle=False)
        n = int.from_bytes(head, "little")
        meta = json.loads(f.read(n))
        data = f.read()
    return np.frombuffer(data, dtype_from_name(meta["dtype"])).reshape(meta["shape"])


class DiskBlockPool:
    """G3: one file per block under a spill directory, LRU by access order."""

    def __init__(self, path: str, capacity_bytes: int, block_nbytes: int):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.capacity_blocks = max(0, capacity_bytes // max(block_nbytes, 1))
        self._lru: OrderedDict[SequenceHash, None] = OrderedDict()
        self._lock = threading.Lock()
        # recover existing blocks (warm restart: the disk tier survives)
        for name in sorted(os.listdir(path)):
            if name.endswith(".kv"):
                try:
                    self._lru[int(name[:-3], 16)] = None
                except ValueError:
                    pass

    def _file(self, h: SequenceHash) -> str:
        return os.path.join(self.path, f"{h:016x}.kv")

    def __contains__(self, h: SequenceHash) -> bool:
        with self._lock:
            return h in self._lru

    def __len__(self) -> int:
        return len(self._lru)

    def store(self, h: SequenceHash, block: np.ndarray) -> List[SequenceHash]:
        """Insert; returns hashes evicted from disk (gone for good)."""
        if self.capacity_blocks == 0:
            return [h]
        gone: List[SequenceHash] = []
        with self._lock:
            if h in self._lru:
                self._lru.move_to_end(h)
                return gone
            while len(self._lru) >= self.capacity_blocks:
                victim, _ = self._lru.popitem(last=False)
                gone.append(victim)
                try:
                    os.unlink(self._file(victim))
                except FileNotFoundError:
                    pass
        tmp = self._file(h) + f".tmp{os.getpid()}"
        _write_block_file(tmp, block)
        os.replace(tmp, self._file(h))
        with self._lock:
            self._lru[h] = None
        return gone

    def get(self, h: SequenceHash) -> Optional[np.ndarray]:
        with self._lock:
            if h not in self._lru:
                return None
            self._lru.move_to_end(h)
        try:
            return _read_block_file(self._file(h))
        except (FileNotFoundError, ValueError, KeyError):
            with self._lock:
                self._lru.pop(h, None)
            return None

    def clear(self) -> List[SequenceHash]:
        """Drop every block and its spill file, under the lock, so a
        concurrent store of one of these hashes lands before (file deleted)
        or after the clear (fresh file and entry), never lost between."""
        with self._lock:
            gone = list(self._lru)
            self._lru.clear()
            for h in gone:
                try:
                    os.unlink(self._file(h))
                except FileNotFoundError:
                    pass
        return gone


class OffloadQueue:
    """Bounded priority queue feeding one offload worker thread: lower
    priority value first, FIFO within a priority (a monotone sequence number
    breaks ties). When full, the worst queued item (highest priority value,
    newest within it) is shed."""

    def __init__(self, max_items: int = 512):
        self.max_items = max_items
        self._heap: List[tuple] = []  # (priority, seq, hash, block)
        self._seq = 0
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self.shed = 0
        self.in_flight = 0  # popped but not yet written (flush waits on this)
        self._closed = False

    def put(self, h: SequenceHash, block: np.ndarray, priority: int) -> None:
        with self._ready:
            if self._closed:
                return
            heapq.heappush(self._heap, (priority, self._seq, h, block))
            self._seq += 1
            if len(self._heap) > self.max_items:
                worst = max(range(len(self._heap)),
                            key=lambda i: (self._heap[i][0], self._heap[i][1]))
                self._heap[worst] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                self.shed += 1
            self._ready.notify()

    def get(self, timeout: Optional[float] = None):
        with self._ready:
            if not self._heap:
                self._ready.wait(timeout)
            if not self._heap:
                return None
            self.in_flight += 1
            return heapq.heappop(self._heap)

    def task_done(self) -> None:
        with self._lock:
            self.in_flight = max(0, self.in_flight - 1)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        with self._ready:
            self._closed = True
            self._ready.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


class KvbmTiers:
    """G2 + G3 + G4 stack with prioritized write-through offload and prefix
    onboarding (G4: kvbm/remote.RemoteBlockPool, or anything with its
    store / get / contains_many surface)."""

    def __init__(
        self,
        block_nbytes: int,
        host_capacity_bytes: int = 1 << 30,
        disk_capacity_bytes: int = 0,
        disk_path: Optional[str] = None,   # default: <tmpdir>/dtpu_kvbm
        remote=None,
        offload_queue_depth: int = 512,
    ):
        self.host = HostBlockPool(host_capacity_bytes, block_nbytes)
        if disk_path is None:
            disk_path = os.path.join(tempfile.gettempdir(), "dtpu_kvbm")
        self.disk = (
            DiskBlockPool(disk_path, disk_capacity_bytes, block_nbytes)
            if disk_capacity_bytes > 0 else None
        )
        self.remote = remote
        self.offloaded = 0
        self.onboarded = 0
        # blocks whose tier write raised on the offload worker
        self.errors = 0
        self.queue = OffloadQueue(offload_queue_depth)
        self._worker: Optional[threading.Thread] = None
        # hashes evicted from every tier since the last drain (the engine
        # turns these into router 'removed' events so the index stays honest)
        self._evicted: List[SequenceHash] = []
        self._evicted_lock = threading.Lock()
        # hashes newly written to a local tier since the last drain: the
        # engine advertises them in the global KV directory
        self._stored: List[SequenceHash] = []

    # LOCAL tiers only: a remote round trip a hash would put RPCs on whatever
    # thread asks; remote membership is batched (match_prefix, filter_servable)
    def __contains__(self, h: SequenceHash) -> bool:
        return h in self.host or (self.disk is not None and h in self.disk)

    def _insert_host(self, h: SequenceHash, block: np.ndarray) -> None:
        """Host insert with spill to disk; tracks blocks gone from all tiers."""
        evicted = self.host.store(h, block)
        if evicted is None:
            return
        gone = self.disk.store(*evicted) if self.disk is not None else [evicted[0]]
        if gone:
            with self._evicted_lock:
                self._evicted.extend(gone)

    def store(self, h: SequenceHash, block: np.ndarray) -> None:
        """Synchronous write-through (host and remote). Prefer ``offload``."""
        self._insert_host(h, block)
        if self.remote is not None:
            self.remote.store(h, block)
        self.offloaded += 1
        with self._evicted_lock:
            self._stored.append(h)

    # -- prioritized async offload -------------------------------------------
    def offload(self, h: SequenceHash, block: np.ndarray, priority: int = 1) -> None:
        """Enqueue a block for background write-through; lower priority value
        transfers first. The engine uses priority 0 for prompt-prefix blocks
        (highest reuse odds) and 1 for decode-sealed blocks."""
        self._ensure_worker()
        self.queue.put(h, block, priority)

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._offload_loop, name="kvbm-offload", daemon=True
            )
            self._worker.start()

    def _offload_loop(self) -> None:
        while True:
            item = self.queue.get(timeout=1.0)
            if item is None:
                if self.queue.closed:
                    return
                continue
            _prio, _seq, h, block = item
            try:
                self.store(h, block)
            except Exception:
                self.errors += 1
                log.exception("kvbm offload of block %x failed", h)
            finally:
                self.queue.task_done()

    def flush(self, timeout_s: float = 10.0) -> None:
        """Wait until the offload queue drains (tests / orderly shutdown)."""
        deadline = time.monotonic() + timeout_s
        while (len(self.queue) or self.queue.in_flight) and time.monotonic() < deadline:
            time.sleep(0.005)

    def close(self) -> None:
        self.queue.close()

    def drain_evicted(self) -> List[SequenceHash]:
        with self._evicted_lock:
            out, self._evicted = self._evicted, []
        return out

    def drain_stored(self) -> List[SequenceHash]:
        """Hashes newly offloaded to a local tier since the last drain (the
        directory's advertisement feed)."""
        with self._evicted_lock:
            out, self._stored = self._stored, []
        return out

    def clear(self, host: bool = True, disk: bool = True) -> Dict[str, int]:
        """Reset the local tiers; returns the blocks dropped per tier. The
        dropped hashes feed the consolidated event path (drain_evicted)."""
        counts = {"g2": 0, "g3": 0}
        gone: List[SequenceHash] = []
        if host:
            dropped = self.host.clear()
            counts["g2"] = len(dropped)
            gone.extend(dropped)
        if disk and self.disk is not None:
            dropped = self.disk.clear()
            counts["g3"] = len(dropped)
            gone.extend(dropped)
        if gone:
            with self._evicted_lock:
                self._evicted.extend(gone)
        return counts

    def tier_of(self, h: SequenceHash) -> Optional[str]:
        """The LOCAL tier that holds ``h`` ("g2" host, "g3" disk), or None
        (the directory's tier advertisements)."""
        if h in self.host:
            return "g2"
        if self.disk is not None and h in self.disk:
            return "g3"
        return None

    def get_block(self, h: SequenceHash) -> Optional[Tuple[np.ndarray, str]]:
        """ONE block from a local tier, with no G3 -> G2 promotion (serving a
        peer's fetch must not churn this worker's host LRU); returns
        (block, tier) or None."""
        b = self.host.get(h)
        if b is not None:
            return b, "g2"
        if self.disk is not None:
            b = self.disk.get(h)
            if b is not None:
                return b, "g3"
        return None

    def filter_servable(self, hashes: List[SequenceHash]) -> List[SequenceHash]:
        """Subset of ``hashes`` still servable from a tier (the remote one
        asked in one batch). Used to consolidate router 'removed' events."""
        local = [h for h in hashes if h in self]
        rest = [h for h in hashes if h not in self]
        if rest and self.remote is not None:
            have = self.remote.contains_many(rest)
            local.extend(h for h, ok in zip(rest, have) if ok)
        return local

    def match_prefix(self, hashes: List[SequenceHash]) -> int:
        """Length of the leading run of ``hashes`` that some tier holds
        (the remote one extends the local run in one batched query)."""
        n = 0
        for h in hashes:
            if h not in self:
                break
            n += 1
        if n < len(hashes) and self.remote is not None:
            for ok in self.remote.contains_many(hashes[n:]):
                if not ok:
                    break
                n += 1
        return n

    def load_prefix(self, hashes: List[SequenceHash]) -> Optional[np.ndarray]:
        """Contiguous blocks [n, L, 2, bs, kvh, d] (or [n, nbytes] codec
        buffers) for a matched prefix. The run stops at the first block
        whose shape or dtype differs from the first: a restart-surviving
        disk tier or a shared remote store can hold blocks written under
        another kv_dtype for the same content hashes (the engine's format
        guard vets what remains). A G3 or G4 block is promoted to G2."""
        blocks: List[np.ndarray] = []
        for h in hashes:
            b = self.host.get(h)
            if b is None and self.disk is not None:
                b = self.disk.get(h)
            if b is None and self.remote is not None:
                b = self.remote.get(h)
            if b is None:
                break
            if blocks and (b.shape != blocks[0].shape or b.dtype != blocks[0].dtype):
                log.warning("kvbm block %x format %s%s != prefix %s%s; truncating "
                            "onboard run", h, b.dtype, b.shape, blocks[0].dtype,
                            blocks[0].shape)
                break
            if h not in self.host:
                self._insert_host(h, b)  # promote G3 / G4 -> G2 (with spill)
            blocks.append(b)
        if not blocks:
            return None
        self.onboarded += len(blocks)
        return np.stack(blocks)

    def stats(self) -> Dict[str, int]:
        return {
            "host_blocks": len(self.host),
            "disk_blocks": len(self.disk) if self.disk is not None else 0,
            "host_hits": self.host.hits,
            "host_misses": self.host.misses,
            "offloaded": self.offloaded,
            "onboarded": self.onboarded,
            "errors": self.errors,
            "queue_depth": len(self.queue),
            "queue_shed": self.queue.shed,
        }
