"""Fleet-wide content-addressed KV block directory.

The port's copy of the reference package's kvbm/directory.py. A global map
``content hash -> {holder, tier, format}`` on the discovery plane
(runtime/discovery: MemKVStore in one process, the netstore or etcd across
processes), kept up incrementally as workers offload and evict blocks. On
a local miss the frontend prices a fetch from a peer's tier against a
recompute (ops/costs.fetch_vs_recompute) and, when the fetch wins, the
worker streams the blocks from the peer's G2/G3 tier over the block-window
protocol instead of prefilling them again (engine/transfer.py, the tier
stream).

Entries live under ``kvdir/<hash:016x>/<holder>``; their values go through
the port's byte-identical MessagePack codec, so a reference directory and
a port directory read each other's entries. An entry's lifetime has two
clocks:

- a **store lease** on every key a publisher writes: when the worker
  dies, lease expiry deletes its advertisements (etcd semantics;
  ``close`` revokes the lease on an orderly shutdown);
- a per-entry ``ts`` stamp from an **injected clock**: lookups drop
  entries older than ``ttl_s``; ``refresh`` stamps the live set again.

Dedupe: a hash that ``dedupe_replicas`` other live holders already
advertise is not advertised again (``dtpu_global_kv_dedup_blocks_total``
counts the skips).

Fetch leases: a fetch in flight holds a :class:`FetchLease` from
``begin_fetch``, which every path out discharges through ``commit_fetch``
or ``abort_fetch`` (an abort is a recompute).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from ..runtime import metrics as M
from ..runtime.config import (
    ENV_GLOBAL_KV,
    ENV_GLOBAL_KV_DEDUPE,
    ENV_GLOBAL_KV_FETCH_MARGIN,
    ENV_GLOBAL_KV_TTL_S,
    env_bool,
    env_float,
    env_int,
)
from ..runtime.faults import FAULTS
from ..runtime.logging import get_logger
from ..tokens.blocks import SequenceHash

log = get_logger("kvbm.directory")

# key layout: <prefix><hash:016x>/<holder> -> codec (MessagePack) entry
DEFAULT_PREFIX = "kvdir/"
DEFAULT_TTL_S = 120.0
DEFAULT_DEDUPE_REPLICAS = 2
DEFAULT_FETCH_MARGIN = 1.0


def directory_enabled() -> bool:
    """The master switch (``DTPU_GLOBAL_KV``)."""
    return env_bool(ENV_GLOBAL_KV, False)


def directory_ttl_s() -> float:
    return env_float(ENV_GLOBAL_KV_TTL_S, DEFAULT_TTL_S)


def directory_dedupe_replicas() -> int:
    return max(1, env_int(ENV_GLOBAL_KV_DEDUPE, DEFAULT_DEDUPE_REPLICAS))


def fetch_margin() -> float:
    """``fetch <= margin * recompute`` decision bound (ops/costs.py)."""
    return env_float(ENV_GLOBAL_KV_FETCH_MARGIN, DEFAULT_FETCH_MARGIN)


@dataclasses.dataclass(frozen=True)
class DirectoryEntry:
    """One advertisement: ``holder`` serves ``hash`` from ``tier`` in
    ``fmt`` ("model" float bytes or "int8" codec buffers) at ``address``
    (its KV-transfer endpoint)."""

    hash: int
    holder: str
    tier: str            # "g2" | "g3"
    fmt: str             # "model" | "int8"
    address: str
    ts: float


@dataclasses.dataclass
class FetchLease:
    """An in-flight peer-tier fetch, discharged through
    :meth:`GlobalKvDirectory.commit_fetch` or :meth:`abort_fetch` on every
    path out of the fetching function."""

    token: int
    holder: str
    hashes: List[int]
    started_at: float


class GlobalKvDirectory:
    """One worker's client on the shared directory plane.

    ``store`` is any runtime/discovery KVStore; ``holder`` is this
    publisher's fleet-unique identity (``worker/<instance id>``);
    ``clock`` injects time for deterministic ts aging (default
    ``time.monotonic``)."""

    def __init__(
        self,
        store,
        holder: str,
        *,
        address: str = "",
        ttl_s: Optional[float] = None,
        dedupe_replicas: Optional[int] = None,
        prefix: str = DEFAULT_PREFIX,
        clock: Optional[Callable[[], float]] = None,
        metrics=None,
    ):
        self.store = store
        self.holder = str(holder)
        self.address = address
        self.ttl_s = float(ttl_s if ttl_s is not None else directory_ttl_s())
        self.dedupe_replicas = int(
            dedupe_replicas if dedupe_replicas is not None
            else directory_dedupe_replicas()
        )
        self.prefix = prefix
        self.clock = clock or time.monotonic
        self._lease_id: Optional[str] = None
        # the hashes this publisher advertises now
        self._published: Dict[int, str] = {}   # hash -> tier
        self._fetch_token = 0
        self._fetches: Dict[int, FetchLease] = {}
        self.dedupe_skipped = 0
        self._m_hits = self._m_entries = self._m_dedup = None
        if metrics is not None:
            self._m_hits = metrics.counter(
                M.GLOBAL_KV_HITS_TOTAL,
                "fleet-level prefix-miss resolutions by outcome",
                extra_labels=("outcome",),
            )
            self._m_entries = metrics.gauge(
                M.GLOBAL_KV_DIRECTORY_ENTRIES,
                "directory entries this worker currently advertises",
            )
            self._m_dedup = metrics.counter(
                M.GLOBAL_KV_DEDUP_BLOCKS_TOTAL,
                "publishes skipped because enough holders already advertise",
            )

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "GlobalKvDirectory":
        """Create the store lease the advertisements ride on: a dead
        worker's entries age out with it (``keep_alive`` renews it)."""
        lease = await self.store.create_lease(max(self.ttl_s, 1.0))
        self._lease_id = lease.id
        return self

    async def keep_alive(self) -> bool:
        if self._lease_id is None:
            return False
        return await self.store.keep_alive(self._lease_id)

    async def close(self) -> None:
        """Orderly shutdown: revoke the lease, which deletes every
        advertisement this worker wrote in one call."""
        if self._lease_id is not None:
            try:
                await self.store.revoke_lease(self._lease_id)
            except Exception:
                log.warning("directory lease revoke failed", exc_info=True)
            self._lease_id = None
        elif self._published:
            # a lease-less client: nothing deletes the keys for us
            try:
                await self.withdraw_all()
            except Exception:
                log.warning("directory withdraw failed", exc_info=True)
        self._published.clear()
        if self._m_entries is not None:
            self._m_entries.set(0)

    # -- publish / unpublish -------------------------------------------------
    def _key(self, h: int, holder: Optional[str] = None) -> str:
        return f"{self.prefix}{int(h) & ((1 << 64) - 1):016x}/{holder or self.holder}"

    def _live(self, entries: Iterable[DirectoryEntry]) -> List[DirectoryEntry]:
        now = self.clock()
        return [e for e in entries if now - e.ts <= self.ttl_s]

    async def publish(
        self, hashes: Sequence[SequenceHash], tier: str, fmt: str = "model",
    ) -> int:
        """Advertise sealed blocks this worker can serve from ``tier``.
        Returns the number actually written; hashes already advertised by
        ``dedupe_replicas`` other live holders are skipped (dedupe)."""
        await FAULTS.ainject("directory.publish")
        wrote = 0
        for h in hashes:
            h = int(h)
            prev = self._published.get(h)
            if prev == tier:
                continue
            if prev is None and self.dedupe_replicas > 0:
                others = [
                    e for e in await self._lookup_raw(h)
                    if e.holder != self.holder
                ]
                if len(others) >= self.dedupe_replicas:
                    self.dedupe_skipped += 1
                    if self._m_dedup is not None:
                        self._m_dedup.inc()
                    continue
            await self.store.put_obj(
                self._key(h),
                {
                    "tier": tier, "fmt": fmt, "address": self.address,
                    "ts": float(self.clock()),
                },
                lease_id=self._lease_id,
            )
            self._published[h] = tier
            wrote += 1
        if self._m_entries is not None:
            self._m_entries.set(len(self._published))
        return wrote

    async def unpublish(self, hashes: Sequence[SequenceHash]) -> int:
        """Withdraw advertisements (eviction from every local tier)."""
        dropped = 0
        for h in hashes:
            h = int(h)
            if self._published.pop(h, None) is None:
                continue
            await self.store.delete(self._key(h))
            dropped += 1
        if self._m_entries is not None:
            self._m_entries.set(len(self._published))
        return dropped

    async def withdraw_all(self) -> int:
        """Delete every advertisement this client wrote: the lease-less
        form of :meth:`close`."""
        return await self.unpublish(list(self._published))

    async def refresh(self) -> int:
        """Re-stamp every live advertisement's ``ts`` (periodic, alongside
        the lease keep-alive) so held blocks outlive the entry ttl."""
        for h, tier in list(self._published.items()):
            await self.store.put_obj(
                self._key(h),
                {
                    "tier": tier, "fmt": "model", "address": self.address,
                    "ts": float(self.clock()),
                },
                lease_id=self._lease_id,
            )
        return len(self._published)

    @property
    def published_count(self) -> int:
        return len(self._published)

    # -- lookup --------------------------------------------------------------
    async def _lookup_raw(self, h: int) -> List[DirectoryEntry]:
        base = f"{self.prefix}{int(h) & ((1 << 64) - 1):016x}/"
        out: List[DirectoryEntry] = []
        for key, obj in (await self.store.list_obj(base)).items():
            if not isinstance(obj, dict):
                continue
            out.append(DirectoryEntry(
                hash=int(h),
                holder=key[len(base):],
                tier=str(obj.get("tier", "g2")),
                fmt=str(obj.get("fmt", "model")),
                address=str(obj.get("address", "")),
                ts=float(obj.get("ts", 0.0)),
            ))
        return self._live(out)

    async def lookup(self, h: SequenceHash) -> List[DirectoryEntry]:
        """Live holders of one hash (stale ``ts`` filtered; deterministic
        holder order)."""
        await FAULTS.ainject("directory.lookup")
        return sorted(await self._lookup_raw(int(h)), key=lambda e: e.holder)

    async def lookup_run(
        self, hashes: Sequence[SequenceHash], exclude_holder: Optional[str] = None,
    ) -> List[DirectoryEntry]:
        """The longest contiguous leading run of ``hashes`` fetchable from
        a SINGLE holder (one wire, one stream: the fetch planner's unit).
        The holder serving the first hash with the longest continuation
        wins; ties break by holder id for determinism."""
        await FAULTS.ainject("directory.lookup")
        if not hashes:
            return []
        first = await self._lookup_raw(int(hashes[0]))
        best: List[DirectoryEntry] = []
        for head in sorted(first, key=lambda e: e.holder):
            if exclude_holder is not None and head.holder == exclude_holder:
                continue
            run = [head]
            for h in hashes[1:]:
                nxt = [
                    e for e in await self._lookup_raw(int(h))
                    if e.holder == head.holder
                ]
                if not nxt:
                    break
                run.append(nxt[0])
            if len(run) > len(best):
                best = run
        return best

    # -- fetch leases --------------------------------------------------------
    def begin_fetch(
        self, holder: str, hashes: Sequence[SequenceHash],
    ) -> FetchLease:
        """Open a fetch lease for an onboard-from-peer attempt; the caller
        routes it to :meth:`commit_fetch` (blocks imported) or
        :meth:`abort_fetch` (the fetch failed: recompute) on every path."""
        self._fetch_token += 1
        lease = FetchLease(
            token=self._fetch_token, holder=str(holder),
            hashes=[int(h) for h in hashes], started_at=float(self.clock()),
        )
        self._fetches[lease.token] = lease
        return lease

    def commit_fetch(self, lease: FetchLease, imported_blocks: int) -> None:
        self._fetches.pop(lease.token, None)
        self.record_outcome("fetched")

    def abort_fetch(self, lease: FetchLease) -> None:
        self._fetches.pop(lease.token, None)
        self.record_outcome("recomputed")

    @property
    def inflight_fetches(self) -> int:
        return len(self._fetches)

    def record_outcome(self, outcome: str) -> None:
        """Count one fleet-miss resolution (outcome: fetched|recomputed)."""
        if self._m_hits is not None:
            self._m_hits.inc(outcome=outcome)
