"""KV block transfer between engines: disaggregated prefill/decode and
fleet-wide KV reuse.

The port's copy of the reference package's engine/transfer.py, with its
native agent and KVBM tier stream and without its multihost branches
(ROADMAP Queue 1 item 6). A prefill engine serves its pages by sequence
hash; a decode engine pulls them and imports them as content-addressed
cached pages, so that admission finds them as a cached prefix. Four paths
move the bytes:

1. **The wire (inline):** the serving engine gathers the pages into one
   device buffer in the wire's layer-major layout ``[L, 2, n, bs, kvh, d]``
   (ops/block_copy.gather_layers_wire: ONE page-copy launch), copies it to
   pinned host memory in one piece, and ships its bytes in a request-plane
   frame; the client uploads them and scatters them with ONE launch
   (scatter_layers_wire). The frame is the reference's, byte for byte: a
   port server answers a reference client, and a reference server a port
   client.
2. **In process (``LOCAL_SERVERS``):** when the address names a server in
   this process, the source engine's gather feeds the destination
   engine's scatter on the card, with no host hop (``LocalKvMover``, the
   reference's ``IciKvMover``).
3. **The device path between processes on one card (CUDA IPC):** the
   counterpart of the reference's PJRT device pulls. The server owns one
   staging arena (ops/cuda_ipc.IpcArena: a cudaMalloc of its own, its IPC
   handle exported once). An offer leases a contiguous run of arena slots,
   gathers into it with the same kernel, waits for the gather to finish and
   replies ``{"matched", "device": {uuid, address, shape, dtype, shards,
   ipc}}``; the client opens the arena once per server (the mapping is
   closed when that address offers another handle or falls out of the most
   recent), scatters straight out of it, waits for the scatter and frees
   the lease (``free_pull``).
   Leases expire after ``SLOT_LEASE_S``; an offer that expires unpulled is
   reclaimed and counted, and past ``_DEVICE_LEAK_BUDGET`` of them the
   server stops offering the device path. ``DTPU_DEVICE_TRANSFER=0`` turns
   it off.
4. **The native wire between hosts (the C++ agent, transfer/native.py):**
   the reference's bulk path. A request that says ``native_ok`` (its
   client loaded the agent) is answered with leased slots of the server's
   native arena, a pinned host buffer of one block a slot registered with
   the agent: ONE page-copy launch (``gather_layers_packed``: each block
   in its storage format, the int8 codec's bytes for an int8 cache) and
   ONE copy fill a contiguous run of slots, then a crc32 a block. The
   client reads the slots over the agent's TCP wire into pinned memory on
   an executor thread, frees them (``free_slots`` with the lease's token),
   checks every crc32 (a lease that expired mid-read is torn: recomputed,
   never imported) and imports with ONE scatter launch. The slots' bytes
   are the reference's arena's, so either package's client reads either
   agent. A device offer still wins when the client can take one.

Wire protocol (served as an endpoint of its own):
    request : {"hashes": [u64...], "native_ok": bool, "device_ok": bool}
    response: one item, either
      inline:  {"matched": n, "shape": [L, 2, n, bs, kvh, d], "dtype": name,
                "data": bytes} (int8: plus "scales" [L, 2, n, kvh] f32)
      device:  {"matched": n, "device": {...}}
      native:  {"matched": n, "block_shape": [L, 2, bs, kvh, d], "dtype",
                "kv_dtype": "model" | "int8", "block_bytes", "native":
                {"host", "port", "region", "slots", "token", "crc32"}}
    then, for a native item, {"free_slots": [...], "token": t}.

Streamed protocol (same endpoint):
    request : {"hashes", "stream": true, "window": W, "wait_s": S, ...}
    response: window items {"offset": k, "matched": m <= W, "wait_s": t,
              + the inline or device body}, then {"eof": true, "served": n}.
    The server serves whatever prefix the engine has committed so far and
    waits on the engine's commit signal (``kv_commits``, fired per prefill
    chunk) for more, so the pull overlaps the prefill's compute; ``wait_s``
    is that window's commit wait, which the client subtracts when it
    estimates the wire's bandwidth. A client that loses the stream resumes
    from its first un-imported block. A window is inline or native, as in
    the reference, or in the port a device offer too.

Tier stream (same endpoint; fleet-wide KV reuse, kvbm/directory.py):
    request : {"tier": true, "hashes", "window": W}
    response: window items {"offset": k, "matched": m <= W, "data": bytes,
              "dtype", "shape": [m, ...], "fmt": "model" | "int8", "tier":
              "g2" | "g3", "crc32": [per block], + "block_shape" for int8},
              then {"eof": true, "served": n, "of": N}.
    The server reads sealed blocks from its KVBM host and disk tiers
    (``KvbmTiers.get_block``) in their storage format, which is already
    block-major: model-dtype ``[m, L, 2, bs, kvh, d]`` pages or the flat
    int8 codec buffers, bit-exact on the wire. The run ends at the first
    hash no local tier holds. The client (``_pull_tier``) checks each
    block's crc32, imports each window as it lands with ONE page-copy
    launch (the engine's ``import_blocks``, the KVBM onboard's route:
    ``scatter_layers``), resumes a lost stream from its first un-imported
    block, and after ``STREAM_MAX_RESUMES`` attempts without progress
    leaves the rest to the recompute. A float window at an int8 cache
    quantises on the way in, an int8 window at a float cache dequantises.
    The pull observes into the bandwidth EWMA under the wire class ``tier``.

Three fallbacks are the reference's semantics and are kept: from a device
path to the wire, from the native wire to the inline one (an agent whose
library failed to build or start: logged at ERROR, counted once), and
from a failed or short transfer to a local recompute. Each is logged and
counted (``transfer_stats``: the ``dtpu_kv_transfer_fallbacks_total``
counter on the worker's /metrics and a flight event on the request's
timeline); no kernel failure falls back to a plain version.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import itertools
import os
import threading
import time
import zlib
from typing import Any, AsyncIterator, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kvbm.layout import (
    BlockShape,
    QuantizedBlockCodec,
    dtype_from_name,
    dtype_name,
    storage_dtype,
    to_host,
    torch_dtype_from_name,
)
from ..ops import block_copy as bc
from ..ops.quant import SCALE_DTYPE, QuantizedKV
from ..runtime import metrics as M
from ..runtime.config import (
    ENV_DEVICE_TRANSFER,
    ENV_ICI_TRANSFER,
    ENV_STREAM_WAIT_S,
    ENV_STREAM_WINDOW,
)
from ..runtime.engine import Context
from ..runtime.faults import FAULTS
from ..runtime.logging import get_logger
from ..runtime.request_plane.tcp import NoResponders, TcpClient
from ..runtime.resilience import RETRYABLE_DEFAULT, retry_policy
from ..runtime.tracing import get_tracer
from ..transfer.native import native_available, native_fetch

log = get_logger("engine.transfer")

NATIVE_REGION = 1
SLOT_LEASE_S = 30.0
# streamed block-window protocol: the window in blocks, the commit-wait
# budget of a streamed fetch, the commit signal's re-check tick, and the
# progress-less resumes before the client gives the suffix up
STREAM_WINDOW_BLOCKS = int(os.environ.get(ENV_STREAM_WINDOW, "8"))
STREAM_WAIT_S = float(os.environ.get(ENV_STREAM_WAIT_S, "30.0"))
_STREAM_POLL_S = 1.0
STREAM_MAX_RESUMES = 3
# outstanding un-pulled device offers per server, and expired-unpulled
# offers after which the server stops offering the device path
_DEVICE_PULL_CAP = 32
_DEVICE_LEAK_BUDGET = 128
# how long a streamed window waits for its client's frees when the arena
# (or the offer cap) is full before it goes inline: a stream serves ahead
# of its client, which frees each window once it has scattered it
_ARENA_WAIT_S = 5.0
# recent pulls a client keeps for /debug/worker
_PULL_LOG = 64


class KvCommitSignal:
    """Broadcast wakeup: "new blocks were content-addressed on this engine".

    The engine fires it from ``_commit_prefilled_blocks`` (once per landed
    prefill chunk) and ``import_blocks``; streaming fetch handlers wait on
    it instead of polling the allocator. One shared future serves every
    waiter (``shield`` keeps one waiter's timeout from cancelling the
    others' wakeup); ``gen`` is a commit generation, so a fire between two
    ``wait`` calls is never lost."""

    def __init__(self) -> None:
        self.gen = 0
        self._fut: Optional[asyncio.Future] = None

    def fire(self) -> None:
        self.gen += 1
        fut = self._fut
        if fut is not None and not fut.done():
            fut.set_result(None)

    async def wait(self, seen: int, timeout: float) -> int:
        """The current generation, blocking up to ``timeout`` only while it
        still equals ``seen``."""
        if self.gen != seen:
            return self.gen
        if self._fut is None or self._fut.done():
            self._fut = asyncio.get_running_loop().create_future()
        try:
            await asyncio.wait_for(asyncio.shield(self._fut), timeout)
        except asyncio.TimeoutError:
            pass
        return self.gen


# process-local registry: transfer address -> KvTransferServer. A client
# whose target lives here moves the pages on the card (LocalKvMover).
LOCAL_SERVERS: Dict[str, "KvTransferServer"] = {}

_pull_uuids = itertools.count(int(time.time()) << 20)


def device_transfer_available() -> bool:
    return os.environ.get(ENV_DEVICE_TRANSFER, "1") != "0"


def card_uuid(device: torch.device) -> str:
    """The card's UUID: two processes share device memory only on one card."""
    return str(torch.cuda.get_device_properties(device).uuid)


class TransferStats:
    """The process's transfer fallbacks by kind (``device_to_wire``,
    ``native_to_inline``, ``recompute``) and reason, on /metrics once a worker attaches its
    scope. Every count is also a log line and a flight event where a
    request is known."""

    def __init__(self) -> None:
        self.counts: Dict[str, int] = {"device_to_wire": 0, "native_to_inline": 0,
                                       "recompute": 0}
        self.reasons: Dict[str, int] = {}
        self._counter = None
        self._lock = threading.Lock()

    def attach_metrics(self, metrics: M.MetricsScope) -> None:
        self._counter = metrics.counter(
            M.KV_TRANSFER_FALLBACKS_TOTAL,
            "KV transfers that fell back (device path to the wire, or a local recompute)",
            extra_labels=("kind", "reason"))

    def count(self, kind: str, reason: str) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            key = f"{kind}:{reason}"
            self.reasons[key] = self.reasons.get(key, 0) + 1
        if self._counter is not None:
            self._counter.inc(kind=kind, reason=reason)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counts": dict(self.counts), "reasons": dict(self.reasons)}


transfer_stats = TransferStats()


def _lease_run(table: Dict[int, Tuple[float, int]], slots: int,
               n: int) -> Optional[Tuple[List[int], int]]:
    """A contiguous run of ``n`` free slots of an arena of ``slots`` (a
    slot whose lease expired is free), leased in ``table`` {slot: (expiry,
    token)} under a new token, or None."""
    now = time.monotonic()
    run = 0
    for s in range(slots):
        run = run + 1 if table.get(s, (0.0, 0))[0] < now else 0
        if run == n:
            got = list(range(s - n + 1, s + 1))
            token = next(_pull_uuids)
            for t in got:
                table[t] = (now + SLOT_LEASE_S, token)
            return got, token
    return None


def _drop_leases(table: Dict[int, Tuple[float, int]], leases: List[Tuple[int, int]]) -> None:
    """Drop every (slot, token) lease of ``table``; the token match keeps
    slots leased again since untouched."""
    for slot, token in leases:
        lease = table.get(slot)
        if lease is not None and lease[1] == token:
            table.pop(slot, None)


def _wire_block_shape(engine) -> List[int]:
    m = engine.mcfg
    return [m.num_layers, 2, engine.cfg.block_size, m.num_kv_heads, m.head_dim]


def _cache_dtype(engine) -> torch.dtype:
    return torch.int8 if engine.kv_quantized else engine.mcfg.dtype


def wire_pages_from_item(item: Dict[str, Any]):
    """An inline item's (pages, scales or None) as host arrays in the wire's
    ``[L, 2, n, ...]`` layout (bf16 as bit patterns)."""
    dtype = dtype_from_name(item.get("dtype", "float32"))
    arr = np.frombuffer(item.get("data", b""), dtype).reshape(item.get("shape", []))
    scales = None
    if "scales" in item:
        L, _, n = arr.shape[:3]
        scales = np.frombuffer(item["scales"], SCALE_DTYPE).reshape(L, 2, n, arr.shape[4])
    return arr, scales


class KvTransferServer:
    """Serves this engine's KV pages by sequence hash."""

    def __init__(self, engine, host: str = "127.0.0.1", arena_slots: Optional[int] = None):
        self.engine = engine   # TorchEngine (duck-typed: allocator, caches, executor)
        self.host = host
        self._block_shape = _wire_block_shape(engine)
        self._quantized = bool(engine.kv_quantized)
        self._block_nbytes = int(engine.kv_bytes_per_block)
        # the device plane: the staging arena (two of the longest prompts
        # by default), its slot leases {slot: (expiry, token)} and the
        # outstanding offers {uuid: (expiry, slots)}
        self._arena_slots = int(arena_slots or 2 * engine.cfg.max_blocks_per_seq)
        self._arena = None
        self._card = None
        self._slot_lease: Dict[int, Tuple[float, int]] = {}
        self._pull_pending: Dict[int, Tuple[float, List[int]]] = {}
        self._pull_leaked = 0
        self.device_address = f"cuda-ipc://{os.getpid()}/{id(self):x}"
        # the native plane: the C++ agent, its arena of as many slots in
        # pinned host memory (the blocks' storage format, one block a slot)
        # and the arena's leases {slot: (expiry, token)}
        self._agent = None
        self._native_arena: Optional[torch.Tensor] = None
        self._native_lease: Dict[int, Tuple[float, int]] = {}
        self._native_lock: Optional[asyncio.Lock] = None
        self._native_failed = False
        # the native plane's host work: windows gathered, bytes, and the
        # seconds of the device gather + copy and of the crc32s
        self.native_stats = {"leases": 0, "blocks": 0, "bytes": 0, "gather_s": 0.0,
                             "crc_s": 0.0}
        # requests in flight and when the last one came: a worker whose
        # loop died serves evacuation pulls until the endpoint goes idle
        self._active = 0
        self._last_request = time.monotonic()
        # recent streamed fetches: blocks asked, served, committed when the
        # first window went out (fewer than asked: it went out while the
        # prefill still ran), each window's commit wait
        self.streams: Deque[Dict[str, Any]] = collections.deque(maxlen=_PULL_LOG)
        # set whenever leases are dropped, for windows waiting for room
        self._freed: Optional[asyncio.Event] = None

    # -- native plane --------------------------------------------------------
    async def _ensure_native(self) -> bool:
        """The agent and its pinned arena, made on the first native-capable
        fetch (GiB-scale for a large model). The library itself is built
        when the server starts (``TorchEngine.serve_transfer``), so this
        never waits for a compiler; a failed build or start answers inline,
        counted once as a fallback."""
        if self._agent is not None:
            return True
        if self._native_failed:
            return False
        if not native_available():
            self._native_failed = True
            transfer_stats.count("native_to_inline", "no_library")
            return False
        if self._native_lock is None:
            self._native_lock = asyncio.Lock()
        async with self._native_lock:
            if self._agent is None and not self._native_failed:
                try:
                    await asyncio.get_running_loop().run_in_executor(None, self._start_native)
                except Exception:
                    log.exception("native transfer agent unavailable; answering inline")
                    self._native_failed = True
                    transfer_stats.count("native_to_inline", "agent_failed")
        return self._agent is not None

    def _start_native(self) -> None:
        from ..transfer import NativeAgent

        arena = torch.empty(self._arena_slots * self._block_nbytes, dtype=torch.uint8,
                            pin_memory=self.engine.device.type == "cuda")
        agent = NativeAgent(host=self.host)
        agent.register(NATIVE_REGION, arena, self._block_nbytes)
        self._native_arena, self._agent = arena, agent
        log.info("native transfer agent serving on %s:%d (%d slots, %.0f MiB pinned arena)",
                 self.host, agent.port, self._arena_slots, arena.numel() / 2**20)

    async def _native_item(self, block_ids: List[int],
                           leases: List[Tuple[int, int]]) -> Optional[Dict[str, Any]]:
        """Gather the blocks into leased slots of the native arena and return
        the item that names them, or None when no run of free slots is left
        (the caller answers inline). The leases are appended to ``leases``;
        a gather that fails raises, its lease reclaimed."""
        n = len(block_ids)
        leased = _lease_run(self._native_lease, self._arena_slots, n)
        if leased is None:
            return None
        slots, token = leased
        try:
            crcs = await self._gather_into_arena(block_ids, slots[0])
        except BaseException:
            _drop_leases(self._native_lease, [(s, token) for s in slots])
            raise
        leases.extend((s, token) for s in slots)
        return {
            "matched": n,
            "block_shape": self._block_shape,
            "dtype": "uint8" if self._quantized else dtype_name(
                storage_dtype(self.engine.mcfg.dtype)),
            "kv_dtype": "int8" if self._quantized else "model",
            "block_bytes": self._block_nbytes,
            "native": {
                "host": self.host, "port": self._agent.port, "region": NATIVE_REGION,
                "slots": slots, "token": token,
                # the client checks what it read: a lease that expired
                # mid-read and was gathered again for another fetch gives
                # torn bytes, which must never be imported under a valid
                # content hash
                "crc32": crcs,
            },
        }

    async def _gather_into_arena(self, block_ids: List[int], slot0: int) -> List[int]:
        """The blocks into the arena's slots from ``slot0`` on: ONE page-copy
        launch (gather_layers_packed: the storage format, the int8 codec's
        bytes for an int8 cache) on the engine's step thread, ONE copy to
        the pinned arena, then a crc32 a block, off the step thread."""
        eng = self.engine
        n, nbytes = len(block_ids), self._block_nbytes
        dst = self._native_arena[slot0 * nbytes:(slot0 + n) * nbytes].view(n, nbytes)
        loop = asyncio.get_running_loop()
        t0 = time.perf_counter()

        def launch():
            ids = eng._t(block_ids, torch.int32)
            packed = bc.gather_layers_packed(eng.k_caches, eng.v_caches, ids)
            if eng.device.type != "cuda":
                dst.copy_(packed)
                return None
            dst.copy_(packed, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            return ev

        ev = await loop.run_in_executor(eng._executor, launch)

        def checksums():
            if ev is not None:
                ev.synchronize()
            t1 = time.perf_counter()
            host = dst.numpy()
            crcs = [zlib.crc32(host[i]) for i in range(n)]
            return crcs, t1

        crcs, t1 = await loop.run_in_executor(None, checksums)
        st = self.native_stats
        st["leases"] += 1
        st["blocks"] += n
        st["bytes"] += n * nbytes
        st["gather_s"] += t1 - t0
        st["crc_s"] += time.perf_counter() - t1
        return crcs

    # -- device plane --------------------------------------------------------
    def _ensure_device(self) -> bool:
        """The arena, allocated and exported on the first device-capable
        fetch (hundreds of MiB for a large model)."""
        if self._arena is not None:
            return True
        if not device_transfer_available() or self.engine.device.type != "cuda":
            return False
        from ..ops.cuda_ipc import IpcArena

        self._arena = IpcArena(self.engine.device, self._arena_slots * self._block_nbytes)
        self._card = card_uuid(self.engine.device)
        log.info("device transfer arena: %d slots, %.0f MiB", self._arena_slots,
                 self._arena.nbytes / 2**20)
        return True

    def _reclaim_leases(self, leases: List[Tuple[int, int]]) -> None:
        """Drop every (slot, token) device lease the client never freed,
        and their offers."""
        _drop_leases(self._slot_lease, leases)
        for token in {t for _, t in leases}:
            self._pull_pending.pop(token, None)
        if self._freed is not None:
            self._freed.set()

    def _reclaim_expired(self) -> None:
        """Offers past their lease, never pulled: reclaimed and counted
        toward the leak budget."""
        now = time.monotonic()
        expired = [u for u, (t, _) in self._pull_pending.items() if t <= now]
        if not expired:
            return
        self._pull_leaked += len(expired)
        log.warning("%d device offer(s) expired unpulled (%d lifetime)", len(expired),
                    self._pull_leaked)
        for u in expired:
            _, slots = self._pull_pending.pop(u)
            self._reclaim_leases([(s, u) for s in slots])

    def _arena_pages(self, slot0: int, n: int):
        """Views of the arena at ``slot0`` in the wire's layout: the pages
        [L, 2, n, bs, kvh, d], and for int8 the scales after them."""
        off = slot0 * self._block_nbytes
        L, _, bs, kvh, d = self._block_shape
        dt = _cache_dtype(self.engine)
        pages = self._arena.view(off, dt, (L, 2, n, bs, kvh, d))
        if not self._quantized:
            return pages, off, None
        s_off = off + pages.numel()
        scales = self._arena.view(s_off, torch.float32, (L, 2, n, kvh))
        return QuantizedKV(pages, scales), off, s_off

    async def _offer_device(self, block_ids: List[int],
                            wait_s: float = 0.0) -> Optional[Dict[str, Any]]:
        """Gather the pages into leased arena slots and return the offer, or
        None (leak budget spent; at the offer cap or with no run of free
        slots, after waiting up to ``wait_s`` for leases to be freed). A
        gather that fails to launch raises, its lease reclaimed."""
        n = len(block_ids)
        deadline = time.monotonic() + wait_s
        while True:
            self._reclaim_expired()
            if self._pull_leaked >= _DEVICE_LEAK_BUDGET:
                return None
            leased = (_lease_run(self._slot_lease, self._arena_slots, n)
                      if len(self._pull_pending) < _DEVICE_PULL_CAP else None)
            left = deadline - time.monotonic()
            if leased is not None or left <= 0:
                break
            if self._freed is None:
                self._freed = asyncio.Event()
            self._freed.clear()
            try:
                await asyncio.wait_for(self._freed.wait(), left)
            except asyncio.TimeoutError:
                pass
        if leased is None:
            log.warning("device offer: %d offers pending, no run of %d free arena slots",
                        len(self._pull_pending), n)
            return None
        slots, uuid = leased
        # reserved before the gather await: concurrent fetches must not all
        # pass the cap check together; the infinite expiry keeps the
        # reservation out of the expiry scan
        self._pull_pending[uuid] = (float("inf"), slots)
        eng = self.engine
        pages, off, s_off = self._arena_pages(slots[0], n)

        def gather():
            ids = eng._t(block_ids, torch.int32)
            bc.gather_layers_wire(eng.k_caches, eng.v_caches, ids, out=pages)
            if eng.device.type != "cuda":
                return None
            ev = torch.cuda.Event()
            ev.record()
            return ev

        loop = asyncio.get_running_loop()
        try:
            ev = await loop.run_in_executor(eng._executor, gather)
            if ev is not None:
                # the gather must finish before the offer goes out: the
                # client reads the arena on its own stream, in its process
                await loop.run_in_executor(None, ev.synchronize)
        except BaseException:
            self._reclaim_leases([(s, uuid) for s in slots])
            raise
        expiry = time.monotonic() + SLOT_LEASE_S
        self._pull_pending[uuid] = (expiry, slots)
        for s in slots:
            self._slot_lease[s] = (expiry, uuid)
        L, _, bs, kvh, d = self._block_shape
        ipc = {"handle": self._arena.handle, "offset": off, "pid": os.getpid(),
               "card": self._card, "slots": slots}
        if s_off is not None:
            ipc["scales_offset"] = s_off
        return {"uuid": uuid, "address": self.device_address, "shape": [L, n, bs, kvh, d],
                "dtype": "int8" if self._quantized else dtype_name(
                    storage_dtype(eng.mcfg.dtype)), "shards": 1, "ipc": ipc}

    def _trace_serve(self, request: Any, start_ns: int, wire: str, matched: int,
                     nbytes: int) -> None:
        """The span of one served fetch, parented on the traceparent the
        client shipped, so the decode-side pull and this serve share a
        trace."""
        tracer = get_tracer()
        if tracer.enabled:
            tracer.emit("kv.transfer.serve", start_ns, time.time_ns(),
                        traceparent=request.get("traceparent"), wire=wire,
                        blocks=matched, bytes=nbytes)

    async def wait_idle(self, idle_s: float, timeout_s: float) -> None:
        """Return once no request is in flight and none came for ``idle_s``
        seconds since the call, or after ``timeout_s``."""
        start = time.monotonic()
        while time.monotonic() - start < timeout_s:
            since = time.monotonic() - max(self._last_request, start)
            if not self._active and since >= idle_s:
                return
            await asyncio.sleep(0.05)

    async def handle(self, request: Any, context: Context) -> AsyncIterator[Dict]:
        self._active += 1
        self._last_request = time.monotonic()
        try:
            # aclosing: a client gone mid-stream closes the inner generator
            # at once, which reclaims its leases
            async with contextlib.aclosing(self._serve(request)) as items:
                async for item in items:
                    yield item
        finally:
            self._active -= 1
            self._last_request = time.monotonic()

    async def _serve(self, request: Any) -> AsyncIterator[Dict]:
        if "free_slots" in request:
            token = request.get("token")
            _drop_leases(self._native_lease, [(int(s), token) for s in request["free_slots"]])
            yield {"ok": True}
            return
        if "free_pull" in request:
            uuid = int(request["free_pull"])
            pending = self._pull_pending.get(uuid)
            if pending is not None:
                self._reclaim_leases([(s, uuid) for s in pending[1]])
            yield {"ok": True}
            return
        if request.get("tier"):
            async for item in self._handle_tier_stream(request):
                yield item
            return
        if request.get("stream"):
            async for item in self._handle_stream(request):
                yield item
            return
        t_serve = time.time_ns()
        hashes = [int(h) for h in request.get("hashes", [])]
        device_ok = bool(request.get("device_ok")) and self._ensure_device()
        native_ok = bool(request.get("native_ok")) and await self._ensure_native()
        alloc = self.engine.allocator
        # pin the matched prefix so eviction cannot race the gather
        block_ids = alloc.acquire_prefix(hashes)
        try:
            n = len(block_ids)
            if n == 0:
                self._trace_serve(request, t_serve, "none", 0, 0)
                yield {"matched": 0, "data": b"", "shape": []}
                return
            if device_ok:
                offer = await self._offer_device(block_ids)
                if offer is not None:
                    self._trace_serve(request, t_serve, "device", n, n * self._block_nbytes)
                    yield {"matched": n, "device": offer}
                    return
            if native_ok:
                # the client frees the slots (free_slots) once it has read
                # them; they expire after SLOT_LEASE_S otherwise
                item = await self._native_item(block_ids, [])
                if item is not None:
                    self._trace_serve(request, t_serve, "native", n, n * self._block_nbytes)
                    yield item
                    return
            item, nbytes = await self._inline_item(block_ids)
            self._trace_serve(request, t_serve, "inline", n, nbytes)
            yield item
        finally:
            alloc.release(block_ids)

    async def _inline_item(self, block_ids: List[int]) -> Tuple[Dict[str, Any], int]:
        data, shape, dtype_name_, scales = await self._gather(block_ids)
        item: Dict[str, Any] = {"matched": len(block_ids), "data": data, "shape": shape,
                                "dtype": dtype_name_}
        nbytes = len(data)
        if scales is not None:
            item["scales"] = scales   # f32 [L, 2, n, kvh] raw bytes
            nbytes += len(scales)
        return item, nbytes

    async def _window_item(self, ids: List[int], device_ok: bool, native_ok: bool,
                           stream_leases: List[Tuple[int, int]],
                           native_leases: List[Tuple[int, int]]
                           ) -> Tuple[Dict[str, Any], int]:
        """ONE window of blocks as a response item: a device offer when the
        client can take one and the arena has room, else native slots when
        the client reads the agent and its arena has room, else inline."""
        if device_ok:
            offer = await self._offer_device(ids, wait_s=_ARENA_WAIT_S)
            if offer is not None:
                stream_leases.extend((s, offer["uuid"]) for s in offer["ipc"]["slots"])
                return {"matched": len(ids), "device": offer}, len(ids) * self._block_nbytes
        if native_ok:
            item = await self._native_item(ids, native_leases)
            if item is not None:
                return item, len(ids) * self._block_nbytes
        return await self._inline_item(ids)

    async def _handle_tier_stream(self, request: Any) -> AsyncIterator[Dict]:
        """Serve sealed blocks straight from the KVBM host and disk tiers as
        block windows, in their storage format, with a crc32 a block (the
        client rejects a torn disk read). There is no commit to wait for
        and no lease to reclaim: the run ends at the first hash no local
        tier holds, and the client recomputes the rest."""
        t_serve = time.time_ns()
        hashes = [int(h) for h in request.get("hashes", [])]
        n = len(hashes)
        window = max(1, int(request.get("window") or STREAM_WINDOW_BLOCKS))
        kvbm = getattr(self.engine, "kvbm", None)
        served = 0
        nbytes_total = 0
        loop = asyncio.get_running_loop()
        while kvbm is not None and served < n:
            blocks: List[np.ndarray] = []
            tier = "g2"
            for h in hashes[served:served + window]:
                # a disk read blocks: keep it off the event loop
                got = await loop.run_in_executor(None, kvbm.get_block, h)
                if got is None:
                    break
                b, b_tier = got
                if blocks and (b.shape != blocks[0].shape or b.dtype != blocks[0].dtype):
                    break   # mixed storage formats: end the run, never mix
                blocks.append(b)
                tier = b_tier if b_tier == "g3" or tier == "g2" else tier
            if not blocks:
                break
            arr = np.stack(blocks)
            data = arr.tobytes()
            item = {
                "matched": len(blocks),
                "offset": served,
                "data": data,
                "dtype": dtype_name(arr.dtype),
                "shape": list(arr.shape),
                "fmt": "int8" if arr.ndim == 2 else "model",
                "tier": tier,
                "crc32": [zlib.crc32(np.ascontiguousarray(b).view(np.uint8)) for b in blocks],
            }
            if arr.ndim == 2:
                # flat int8 codec buffers: the logical block shape, so that
                # a peer (a float cache too) can build the decode codec
                item["block_shape"] = _wire_block_shape(self.engine)
            yield item
            served += len(blocks)
            nbytes_total += len(data)
            if len(blocks) < window:
                break   # the run ended mid-window: nothing further is held
        self._trace_serve(request, t_serve, "tier", served, nbytes_total)
        yield {"eof": True, "served": served, "of": n}

    async def _handle_stream(self, request: Any) -> AsyncIterator[Dict]:
        """Block-window streaming fetch: serve committed blocks as windows,
        waiting on the engine's commit signal for blocks whose prefill
        chunk has not landed yet.

        A client that disappears mid-stream (GeneratorExit, a transport
        error) gets every lease it never freed dropped at once; after a
        clean eof the client's own ``free_pull`` (or expiry) frees the last
        windows."""
        t_serve = time.time_ns()
        hashes = [int(h) for h in request.get("hashes", [])]
        n = len(hashes)
        window = max(1, int(request.get("window") or STREAM_WINDOW_BLOCKS))
        wait_budget = float(request.get("wait_s") or STREAM_WAIT_S)
        device_ok = bool(request.get("device_ok")) and self._ensure_device()
        native_ok = bool(request.get("native_ok")) and await self._ensure_native()
        alloc = self.engine.allocator
        sig = getattr(self.engine, "kv_commits", None)
        served = 0
        nbytes_total = 0
        wire = "none"
        stream_leases: List[Tuple[int, int]] = []
        native_leases: List[Tuple[int, int]] = []
        clean_exit = False
        record: Dict[str, Any] = {"blocks": n, "served": 0, "committed_at_first_window": None,
                                  "waits": []}
        self.streams.append(record)
        try:
            gen = sig.gen if sig is not None else 0
            t_window = time.monotonic()   # when the wait for the next window began
            while served < n:
                block_ids = alloc.acquire_prefix(hashes)
                avail = len(block_ids)
                if avail <= served:
                    alloc.release(block_ids)
                    waited = time.monotonic() - t_window
                    if waited >= wait_budget or sig is None:
                        break   # no more commits coming: eof with what shipped
                    gen = await sig.wait(gen, min(_STREAM_POLL_S, wait_budget - waited))
                    continue
                take = min(avail - served, window)
                waited = time.monotonic() - t_window
                if record["committed_at_first_window"] is None:
                    record["committed_at_first_window"] = avail
                try:
                    item, nbytes = await self._window_item(
                        block_ids[served:served + take], device_ok, native_ok,
                        stream_leases, native_leases)
                finally:
                    alloc.release(block_ids)
                item["offset"] = served
                item["wait_s"] = round(waited, 6)
                wire = ("device" if "device" in item else
                        "native" if "native" in item else "inline")
                yield item
                served += take
                nbytes_total += nbytes
                record["served"] = served
                record["waits"].append(item["wait_s"])
                t_window = time.monotonic()
            self._trace_serve(request, t_serve, f"stream-{wire}", served, nbytes_total)
            clean_exit = True
            yield {"eof": True, "served": served, "of": n}
        finally:
            if not clean_exit:
                self._reclaim_leases(stream_leases)
                _drop_leases(self._native_lease, native_leases)

    async def _gather(self, block_ids: List[int]):
        """The inline payload: (data bytes, shape, dtype name, scales bytes
        or None), scales present exactly when the payload is int8. ONE
        gather launch on the engine's step thread, then one copy to pinned
        host memory, waited for off the step thread."""
        eng = self.engine
        loop = asyncio.get_running_loop()

        def launch():
            ids = eng._t(block_ids, torch.int32)
            pages = bc.gather_layers_wire(eng.k_caches, eng.v_caches, ids)
            parts = [pages.data, pages.scale] if self._quantized else [pages]
            if eng.device.type != "cuda":
                return parts, None
            host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in parts]
            for h, p in zip(host, parts):
                h.copy_(p, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            return host, ev

        host, ev = await loop.run_in_executor(eng._executor, launch)

        def to_bytes():
            if ev is not None:
                ev.synchronize()
            arrs = [to_host(h) for h in host]
            payload = arrs[0]
            return (payload.tobytes(), list(payload.shape),
                    "int8" if self._quantized else dtype_name(payload.dtype),
                    arrs[1].tobytes() if self._quantized else None)

        return await loop.run_in_executor(None, to_bytes)

    def snapshot(self) -> Dict[str, Any]:
        return {"arena_slots": self._arena_slots if self._arena is not None else 0,
                "leased_slots": len(self._slot_lease),
                "pending_offers": len(self._pull_pending),
                "leaked_offers": self._pull_leaked, "streams": list(self.streams),
                "native": {"port": self._agent.port if self._agent is not None else None,
                           "leased_slots": len(self._native_lease), **self.native_stats}}

    def close(self) -> None:
        if self._arena is not None:
            self._arena.close()
            self._arena = None
        if self._agent is not None:
            # a leaked teardown parks the arena (transfer/native.py)
            self._agent.close()
            self._agent = None
            self._native_arena = None


class LocalKvMover:
    """Page movement between two engines of one process, on the card: the
    reference's ``IciKvMover``. The source engine's gather (on its step
    thread) feeds the destination engine's scatter (on its own), in the
    wire's layout, with no host hop; the destination's stream waits for
    the gather's event. The source blocks stay pinned across the gather so
    that eviction cannot rewrite them."""

    def __init__(self, src_engine, dst_engine):
        assert src_engine is not dst_engine
        self.src = src_engine
        self.dst = dst_engine

    async def move(self, hashes: List[int]) -> Optional[int]:
        """Copy the blocks for ``hashes``; returns blocks imported (0 when
        the destination has no room), or None on failure (the caller
        takes the wire)."""
        src, dst = self.src, self.dst
        src_ids = src.allocator.acquire_prefix(hashes)
        if not src_ids:
            return 0
        try:
            n = len(src_ids)
            if not dst.allocator.can_allocate(n):
                # no source gather (prefill step time) for a move that
                # cannot land
                log.warning("local move: no room for %d blocks on the destination", n)
                return 0

            def gather():
                ids = src._t(src_ids, torch.int32)
                pages = bc.gather_layers_wire(src.k_caches, src.v_caches, ids)
                ev = None
                if src.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                return pages, ev

            loop = asyncio.get_running_loop()
            try:
                pages, ev = await loop.run_in_executor(src._executor, gather)
            except Exception:
                log.exception("local move's gather failed; taking the wire")
                return None
            return await dst.import_blocks(list(hashes[:n]), pages, wire=True, after=ev)
        finally:
            src.allocator.release(src_ids)


class KvTransferClient:
    """Fetches remote pages and imports them into a local engine's cache."""

    def __init__(self, engine, tcp_client: Optional[TcpClient] = None):
        self.engine = engine
        self._tcp = tcp_client or TcpClient()
        # recent pulls (wire, bytes, seconds, blocks, windows' commit waits, tier
        # windows, the address)
        self.pulls: Deque[Dict[str, Any]] = collections.deque(maxlen=_PULL_LOG)

    async def _fetch_item(self, address: str, req: Dict[str, Any]) -> Dict[str, Any]:
        """One wire fetch (request + drained single-item stream), replayed
        through the shared policy (scope transfer.pull): the protocol is
        content-addressed and idempotent, so a dropped connection retries
        safely; exhausted retries surface to the caller, whose engine then
        recomputes the prefill. The attempt timeout bounds a hung server."""
        async def once() -> Dict[str, Any]:
            await FAULTS.ainject("transfer.pull")
            stream = await self._tcp.call(address, req)
            item: Dict[str, Any] = {}
            async for it in stream:
                item = it
            return item

        return await retry_policy(
            "transfer.pull", max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
            attempt_timeout_s=30.0, retryable=RETRYABLE_DEFAULT + (NoResponders,),
        ).acall(once)

    def _block_nbytes(self) -> int:
        return int(self.engine.kv_bytes_per_block)

    async def fetch_and_import(self, address: str, hashes: List[int],
                               traceparent: Optional[str] = None, stream: bool = False,
                               request_id: Optional[str] = None, tier: bool = False) -> int:
        """Pull blocks for ``hashes`` from ``address``; returns the tokens
        now cached locally (already-cached blocks are skipped, only the
        missing suffix is fetched). Imported blocks are committed
        content-addressed, so admission picks them up as a cached prefix.

        ``stream`` takes the block-window protocol; ``tier`` pulls from the
        peer's KVBM host and disk tiers instead of its device cache (the
        tier stream, fleet-wide KV reuse). ``traceparent``
        continues the request's trace (a ``kv.transfer.pull`` span, shipped
        in the handshake so that the serving side's span joins it). The
        observed (bytes, seconds) feed the process's bandwidth estimator
        and the ``wire_collapse`` detector. A pull that leaves blocks to
        recompute, or raises, counts a ``recompute`` fallback."""
        from ..runtime.bandwidth import get_bandwidth_estimator
        from ..runtime.health import get_health_monitor

        tracer = get_tracer()
        info: Dict[str, Any] = {"wire": "none", "bytes": 0, "blocks": 0, "xfer_s": 0.0,
                                "waits": [], "request_id": request_id}
        t0 = time.time_ns()
        status = "OK"
        tokens = 0
        want_tokens = len(hashes) * self.engine.allocator.block_size
        try:
            if tier:
                tokens = await self._pull_tier(address, [int(h) for h in hashes], traceparent,
                                               info)
            else:
                tokens = await self._pull(address, [int(h) for h in hashes], traceparent,
                                          info, stream)
            if tokens < want_tokens:
                self._fallback("recompute", "zero_progress" if tokens == 0 else "partial",
                               request_id)
            return tokens
        except Exception as e:
            status = "ERROR"
            self._fallback("recompute", type(e).__name__, request_id)
            raise
        finally:
            # streamed pulls add wire-active time per window (the server's
            # commit waits taken out); blocking pulls are wire-active for
            # the whole call
            xfer_s = info["xfer_s"] or (time.time_ns() - t0) / 1e9
            est = get_bandwidth_estimator()
            est.observe(info["wire"], info["bytes"], xfer_s)
            if info["bytes"] > 0:
                get_health_monitor().observe_wire(info["wire"], est.bandwidth(info["wire"]))
            self.pulls.append({"wire": info["wire"], "bytes": info["bytes"],
                               "seconds": xfer_s, "blocks": info["blocks"],
                               "tokens": tokens, "want_tokens": want_tokens,
                               "streamed": bool(stream), "waits": info["waits"],
                               "tier": bool(tier), "address": address,
                               "windows": info.get("windows", 0),
                               "crc_s": info.get("crc_s", 0.0)})
            if tracer.enabled:
                tracer.emit("kv.transfer.pull", t0, time.time_ns(), traceparent=traceparent,
                            status=status, address=address, wire=info["wire"],
                            bytes=info["bytes"], blocks=info["blocks"], tokens=tokens,
                            streamed=bool(stream))

    def _fallback(self, kind: str, reason: str, request_id: Optional[str]) -> None:
        from ..runtime.flight_recorder import get_flight_recorder

        transfer_stats.count(kind, reason)
        log.warning("kv transfer fallback: %s (%s)", kind, reason)
        if request_id is not None:
            get_flight_recorder().record(request_id, "transfer_fallback", fallback=kind,
                                         reason=reason)

    def _device_ok(self, n: int) -> bool:
        """Ask for a device offer only when the pull could land: a CUDA
        engine with room to allocate (the offer costs the serving engine
        a gather)."""
        return (device_transfer_available() and self.engine.device.type == "cuda"
                and self.engine.allocator.can_allocate(n))

    async def _pull(self, address: str, hashes: List[int], traceparent: Optional[str],
                    info: Dict[str, Any], stream: bool = False) -> int:
        alloc = self.engine.allocator
        have = len(alloc.match_prefix(hashes))
        want = hashes[have:]
        if not want:
            return have * alloc.block_size
        # a server in this process: pages move on the card
        local = (LOCAL_SERVERS.get(address)
                 if os.environ.get(ENV_ICI_TRANSFER, "1") != "0" else None)
        if local is not None and local.engine is not self.engine:
            if stream:
                moved = await self._local_stream(local.engine, want, info)
            else:
                t_move = time.monotonic()
                moved = await LocalKvMover(local.engine, self.engine).move(list(want))
                if moved:
                    info.update(bytes=moved * self._block_nbytes(),
                                xfer_s=time.monotonic() - t_move)
            if moved is not None:
                info.update(wire="ici", blocks=moved)
                return (have + moved) * alloc.block_size
            self._fallback("device_to_wire", "local_move_failed", info.get("request_id"))
        device_ok = self._device_ok(len(want))
        if stream:
            imported = await self._pull_stream(address, want, traceparent, info, device_ok)
            return (have + imported) * alloc.block_size
        req: Dict[str, Any] = {"hashes": [int(h) for h in want],
                               "native_ok": native_available()}
        if traceparent:
            req["traceparent"] = traceparent
        if device_ok:
            req["device_ok"] = True
            req["device_shards"] = 1
        t_pull = time.monotonic()
        item = await self._fetch_item(address, req)
        matched = item.get("matched", 0)
        if matched == 0:
            return have * alloc.block_size
        if "device" in item:
            got = await self._device_pull(address, item, list(want[:matched]))
            if got is not None:
                info.update(wire="device", blocks=got, bytes=matched * self._block_nbytes(),
                            xfer_s=time.monotonic() - t_pull)
                return (have + got) * alloc.block_size
            # the device pull failed: one retry over the wire
            self._fallback("device_to_wire", "pull_failed", info.get("request_id"))
            req.pop("device_ok", None)
            item = await self._fetch_item(address, req)
            matched = item.get("matched", 0)
            if matched == 0 or "device" in item:
                return have * alloc.block_size
        elif device_ok:
            self._fallback("device_to_wire", "not_offered", info.get("request_id"))
        if "native" in item:
            block_major = await self._native_fetch(address, item, matched, info, t_pull)
            if block_major is None:
                return have * alloc.block_size
            info.update(wire="native", bytes=matched * int(item["block_bytes"]))
            imported = await self.engine.import_blocks(list(want[:matched]), block_major)
        else:
            pages, scales = wire_pages_from_item(item)
            info.update(wire="inline",
                        bytes=len(item.get("data", b"")) + len(item.get("scales", b"")))
            imported = await self.engine.import_blocks(
                list(want[:matched]), pages if scales is None else (pages, scales), wire=True)
        info["blocks"] = imported
        return (have + imported) * alloc.block_size

    async def _local_stream(self, src_engine, want: List[int],
                            info: Dict[str, Any]) -> Optional[int]:
        """Streamed in-process transfer: move the committed prefix window
        by window, waiting on the source engine's commit signal while its
        later prefill chunks compute. Returns blocks moved, or None when
        the first move fails outright (the caller takes the wire)."""
        mover = LocalKvMover(src_engine, self.engine)
        sig = getattr(src_engine, "kv_commits", None)
        moved_total = 0
        active_s = 0.0
        failed = False
        gen = sig.gen if sig is not None else 0
        t_window = time.monotonic()
        while moved_total < len(want):
            t_move = time.monotonic()
            moved = await mover.move(list(want[moved_total:]))
            if moved is None:
                failed = True
                break
            if moved:
                active_s += time.monotonic() - t_move
                moved_total += moved
                t_window = time.monotonic()
                continue
            waited = time.monotonic() - t_window
            if waited >= STREAM_WAIT_S or sig is None:
                break   # nothing more coming: the engine recomputes the rest
            gen = await sig.wait(gen, min(_STREAM_POLL_S, STREAM_WAIT_S - waited))
        info.update(bytes=moved_total * self._block_nbytes(), xfer_s=active_s)
        if failed and not moved_total:
            return None
        return moved_total

    async def _pull_stream(self, address: str, want: List[int], traceparent: Optional[str],
                           info: Dict[str, Any], device_ok: bool = False) -> int:
        """Consume the block-window protocol: import each window as it
        arrives, resume from the first un-imported block on any mid-stream
        loss (content addressing makes the re-request safe), and give the
        remaining suffix up after STREAM_MAX_RESUMES progress-less attempts:
        the engine then recomputes only the lost blocks. A device window
        that fails ends the device path for the rest of the pull."""
        n = len(want)
        imported = 0
        resumes = 0
        inline_counted = False   # device windows asked for, one came inline
        while imported < n:
            req: Dict[str, Any] = {"hashes": [int(h) for h in want[imported:]],
                                   "stream": True, "window": STREAM_WINDOW_BLOCKS,
                                   "wait_s": STREAM_WAIT_S, "native_ok": native_available()}
            if device_ok:
                req["device_ok"] = True
            if traceparent:
                req["traceparent"] = traceparent
            eof = False
            progressed = False
            try:
                await FAULTS.ainject("transfer.pull")
                stream = await self._tcp.call(address, req)
                t_prev = time.monotonic()
                async for item in stream:
                    if item.get("eof"):
                        eof = True
                        break
                    # an armed mid-stream window fault drops the stream
                    # through the real resume path (a no-op unarmed)
                    await FAULTS.ainject("transfer.stream_window")
                    m = int(item.get("matched", 0))
                    if m <= 0:
                        continue
                    w_hashes = list(want[imported:imported + m])
                    if "device" in item:
                        got = await self._device_pull(address, item, w_hashes)
                        if got is None:
                            device_ok = False
                            self._fallback("device_to_wire", "pull_failed", info.get("request_id"))
                            raise ConnectionError("device window pull failed mid-stream")
                        wire, nbytes = "device", m * self._block_nbytes()
                    elif "native" in item:
                        block_major = await self._native_fetch(address, item, m, info)
                        if block_major is None:
                            raise ConnectionError("native window fetch failed mid-stream")
                        got = await self.engine.import_blocks(w_hashes, block_major)
                        wire, nbytes = "native", m * int(item["block_bytes"])
                    else:
                        pages, scales = wire_pages_from_item(item)
                        nbytes = len(item.get("data", b"")) + len(item.get("scales", b""))
                        got = await self.engine.import_blocks(
                            w_hashes, pages if scales is None else (pages, scales), wire=True)
                        wire = "inline"
                        if device_ok and not inline_counted:
                            inline_counted = True
                            self._fallback("device_to_wire", "not_offered", info.get("request_id"))
                    # wire-active seconds: the gap between items less the
                    # server's commit wait for this window
                    wait_s = float(item.get("wait_s", 0.0))
                    leg = max(time.monotonic() - t_prev - wait_s, 1e-9)
                    info["wire"] = wire
                    info["bytes"] += nbytes
                    info["xfer_s"] += leg
                    info["waits"].append(wait_s)
                    info["windows"] = info.get("windows", 0) + 1
                    imported += got
                    progressed = progressed or got > 0
                    if got < m:
                        # the local pool is full: serve with what landed
                        info["blocks"] = imported
                        return imported
                    t_prev = time.monotonic()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("kv stream from %s lost after %d/%d blocks (%r); resuming from "
                            "the first missing block", address, imported, n, e)
            if eof:
                break
            if progressed:
                resumes = 0
            else:
                resumes += 1
                if resumes > STREAM_MAX_RESUMES:
                    log.warning("kv stream from %s exhausted %d resume attempts at %d/%d "
                                "blocks; recomputing the remaining suffix", address,
                                STREAM_MAX_RESUMES, imported, n)
                    break
                await asyncio.sleep(min(0.05 * resumes, 0.5))
        info["blocks"] = imported
        return imported

    async def _pull_tier(self, address: str, hashes: List[int], traceparent: Optional[str],
                         info: Dict[str, Any]) -> int:
        """Onboard blocks from a PEER's KVBM host and disk tiers (the tier
        stream): each window is checked and imported as it lands (ONE
        scatter_layers launch a window, through ``import_blocks``); a lost
        stream is asked again from the first un-imported block, and after
        STREAM_MAX_RESUMES attempts without progress the rest is left to
        the recompute. A checksum mismatch ends the fetch there (a torn
        read is never imported under a valid content hash)."""
        alloc = self.engine.allocator
        have = len(alloc.match_prefix(hashes))
        want = list(hashes[have:])
        n = len(want)
        if n == 0:
            return have * alloc.block_size
        imported = 0
        resumes = 0
        while imported < n:
            req: Dict[str, Any] = {"tier": True, "hashes": [int(h) for h in want[imported:]],
                                   "window": STREAM_WINDOW_BLOCKS}
            if traceparent:
                req["traceparent"] = traceparent
            eof = False
            progressed = False
            try:
                await FAULTS.ainject("fetch.peer_tier")
                stream = await self._tcp.call(address, req)
                t_prev = time.monotonic()
                async for item in stream:
                    if item.get("eof"):
                        eof = True
                        break
                    # an armed window fault drops the stream through the
                    # real resume path (a no-op unarmed)
                    await FAULTS.ainject("fetch.peer_tier")
                    m = int(item.get("matched", 0))
                    if m <= 0:
                        continue
                    raw = np.frombuffer(item.get("data", b""),
                                        dtype_from_name(item.get("dtype", "float32"))
                                        ).reshape(item.get("shape", []))
                    crcs = item.get("crc32")
                    if crcs is not None and any(
                            zlib.crc32(np.ascontiguousarray(raw[i]).view(np.uint8)) != crcs[i]
                            for i in range(m)):
                        log.warning("peer-tier window checksum mismatch from %s; abandoning "
                                    "the fetch at %d/%d blocks", address, imported, n)
                        info["blocks"] = imported
                        return (have + imported) * alloc.block_size
                    if item.get("fmt") == "int8":
                        L, _, bs, kvh, d = item["block_shape"]
                        codec = QuantizedBlockCodec(BlockShape(
                            num_layers=L, block_size=bs, num_kv_heads=kvh, head_dim=d,
                            dtype=np.dtype(np.int8)))
                        block_major = codec.decode_many(raw)
                    else:
                        block_major = raw   # the storage format is block-major
                    leg = max(time.monotonic() - t_prev, 1e-9)
                    got = await self.engine.import_blocks(list(want[imported:imported + m]),
                                                          block_major)
                    info["wire"] = "tier"
                    info["bytes"] += len(item.get("data", b""))
                    info["xfer_s"] += leg
                    info["windows"] = info.get("windows", 0) + 1
                    imported += got
                    progressed = progressed or got > 0
                    if got < m:
                        # the local pool is full: serve with what landed
                        info["blocks"] = imported
                        return (have + imported) * alloc.block_size
                    t_prev = time.monotonic()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                log.warning("peer-tier fetch from %s lost after %d/%d blocks (%r); resuming "
                            "from the first missing block", address, imported, n, e)
            if eof:
                break
            if progressed:
                resumes = 0
            else:
                resumes += 1
                if resumes > STREAM_MAX_RESUMES:
                    log.warning("peer-tier fetch from %s exhausted %d resume attempts at "
                                "%d/%d blocks; recomputing the remaining suffix", address,
                                STREAM_MAX_RESUMES, imported, n)
                    break
                await asyncio.sleep(min(0.05 * resumes, 0.5))
        info["blocks"] = imported
        return (have + imported) * alloc.block_size

    async def _device_pull(self, address: str, item: Dict[str, Any],
                           hashes: List[int]) -> Optional[int]:
        """Scatter offered pages straight out of the serving process's
        arena (CUDA IPC), wait for the scatter, then free the lease.
        Returns blocks imported, or None on failure (the caller takes the
        wire; the lease is left to expire, so the server counts it)."""
        from ..ops import cuda_ipc

        dev = item["device"]
        ipc = dev.get("ipc")
        eng = self.engine
        if (ipc is None or eng.device.type != "cuda" or ipc.get("pid") == os.getpid()
                or ipc.get("card") != card_uuid(eng.device)):
            log.warning("device offer from %s is not on this card or not IPC", address)
            return None
        L, n, bs, kvh, d = dev["shape"]
        loop = asyncio.get_running_loop()
        handle = bytes(ipc["handle"])
        try:
            base = await loop.run_in_executor(None, cuda_ipc.open_arena, handle, eng.device,
                                              address)
        except Exception:
            log.exception("device pull from %s failed; taking the wire", address)
            return None
        try:
            if dev["dtype"] == "int8":
                pages = QuantizedKV(
                    cuda_ipc.device_view(base + int(ipc["offset"]), eng.device, torch.int8,
                                         (L, 2, n, bs, kvh, d)),
                    cuda_ipc.device_view(base + int(ipc["scales_offset"]), eng.device,
                                         torch.float32, (L, 2, n, kvh)))
            else:
                pages = cuda_ipc.device_view(base + int(ipc["offset"]), eng.device,
                                             torch_dtype_from_name(dev["dtype"]),
                                             (L, 2, n, bs, kvh, d))
            got = await eng.import_blocks(hashes, pages, wire=True, sync=True)
        except Exception:
            log.exception("device pull from %s failed; taking the wire", address)
            cuda_ipc.release_arena(handle, failed=True)
            return None
        cuda_ipc.release_arena(handle)
        try:
            stream = await self._tcp.call(address, {"free_pull": int(dev["uuid"])})
            async for _ in stream:
                pass
        except Exception:
            pass   # the server's lease expiry reclaims the slots
        return got

    async def _native_fetch(self, address: str, item: Dict[str, Any], matched: int,
                            info: Dict[str, Any], t0: Optional[float] = None):
        """Read leased slots from the serving agent into a host buffer
        (pinned for a card's upload) on an executor thread, free the slots
        (beside the checks), and check every block's crc32. Returns the
        blocks in the server's storage format, ready for ``import_blocks``
        (ONE scatter_layers launch): pages ``[n, L, 2, bs, kvh, d]`` (a view
        of the buffer), or for an int8 server the codec's (payload, scales)
        pair; None on a failed read or a torn block (the caller recomputes,
        counted). With ``t0`` the pull's wire seconds run from ``t0`` to the
        end of the read (``info["xfer_s"]``)."""
        nat = item["native"]
        block_bytes = int(item["block_bytes"])
        slots = list(nat["slots"])[:matched]
        buf = torch.empty(matched * block_bytes, dtype=torch.uint8,
                          pin_memory=self.engine.device.type == "cuda")
        loop = asyncio.get_running_loop()

        async def free() -> None:
            try:
                stream = await self._tcp.call(
                    address, {"free_slots": nat["slots"], "token": nat.get("token")})
                async for _ in stream:
                    pass
            except Exception:
                pass   # the lease's expiry reclaims the slots

        try:
            await loop.run_in_executor(None, native_fetch, nat["host"], int(nat["port"]),
                                       int(nat["region"]), slots, block_bytes, buf)
        except Exception:
            log.exception("native kv fetch from %s:%s failed; recomputing the prefill "
                          "locally", nat["host"], nat["port"])
            await free()
            return None
        if t0 is not None:
            info["xfer_s"] = time.monotonic() - t0
        freeing = asyncio.ensure_future(free())
        try:
            return await self._checked_blocks(item, buf, matched, slots, address, info)
        finally:
            await freeing

    async def _checked_blocks(self, item: Dict[str, Any], buf: torch.Tensor, matched: int,
                              slots: List[int], address: str, info: Dict[str, Any]):
        """``_native_fetch``'s crc32 checks and decode of the read buffer."""
        block_shape = item["block_shape"]
        raw = buf.view(matched, int(item["block_bytes"])).numpy()
        expected = item["native"].get("crc32")

        def torn() -> Optional[int]:
            t0 = time.perf_counter()
            try:
                return next((i for i in range(matched) if expected is not None
                             and zlib.crc32(raw[i]) != expected[i]), None)
            finally:
                info["crc_s"] = info.get("crc_s", 0.0) + time.perf_counter() - t0

        bad = await asyncio.get_running_loop().run_in_executor(None, torn)
        if bad is not None:
            # the lease expired mid-read and the slots were gathered again
            # for another fetch: never import torn bytes under a valid hash
            log.warning("kv transfer checksum mismatch on slot %s from %s (a stale lease "
                        "overwritten?); recomputing the prefill locally", slots[bad], address)
            return None
        if item.get("kv_dtype") == "int8":
            L, _, bs, kvh, d = block_shape
            return QuantizedBlockCodec(BlockShape(
                num_layers=L, block_size=bs, num_kv_heads=kvh, head_dim=d,
                dtype=np.dtype(np.int8))).decode_many(raw)
        return buf.view(torch_dtype_from_name(item["dtype"])).view(matched, *block_shape)

    def snapshot(self) -> Dict[str, Any]:
        return {"pulls": list(self.pulls)}

    async def close(self) -> None:
        await self._tcp.close()

