"""Worker-side publishers: KV cache events + load metrics onto the event plane.

The port's copy of the reference package's kv_router/publisher.py, the
counterpart of Dynamo's KvEventPublisher (lib/llm/src/kv_router/publisher.rs:112)
and WorkerMetricsPublisher (publisher.rs:957). Topic scheme::

    kv.events.<namespace>.<component>     RouterEvent (MessagePack)
    kv.metrics.<namespace>.<component>    WorkerMetrics (MessagePack)

Payloads are encoded with the port's codec (runtime/codec.py), which writes
msgpack's bytes: an event is the same payload in both packages.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

from ..runtime import codec
from ..runtime.event_plane.base import EventPlane
from ..tokens import SequenceHash
from .protocols import KvCacheEvent, KvEventKind, RouterEvent, WorkerMetrics, WorkerWithDpRank


def events_topic(namespace: str, component: str) -> str:
    return f"kv.events.{namespace}.{component}"


def metrics_topic(namespace: str, component: str) -> str:
    return f"kv.metrics.{namespace}.{component}"


class KvEventPublisher:
    def __init__(
        self,
        event_plane: EventPlane,
        namespace: str,
        component: str,
        worker_id: int,
        dp_rank: int = 0,
        block_size: int = 16,
    ):
        self._plane = event_plane
        self._topic = events_topic(namespace, component)
        self.worker = WorkerWithDpRank(worker_id, dp_rank)
        self.block_size = block_size
        self._next_event_id = 1
        # events published by kind (the worker's exit report reads them)
        self.counts = {kind.value: 0 for kind in KvEventKind}

    async def _publish(self, event: KvCacheEvent) -> None:
        ev = RouterEvent(worker=self.worker, event=event, event_id=self._next_event_id)
        self._next_event_id += 1
        self.counts[event.kind.value] += 1
        await self._plane.publish(self._topic, codec.packb(ev.to_obj()))

    async def stored(
        self, block_hashes: Iterable[SequenceHash], parent_hash: Optional[SequenceHash] = None
    ) -> None:
        await self._publish(
            KvCacheEvent(
                kind=KvEventKind.STORED,
                block_hashes=list(block_hashes),
                parent_hash=parent_hash,
                block_size=self.block_size,
            )
        )

    async def removed(self, block_hashes: Iterable[SequenceHash]) -> None:
        await self._publish(
            KvCacheEvent(kind=KvEventKind.REMOVED, block_hashes=list(block_hashes))
        )

    async def cleared(self) -> None:
        await self._publish(KvCacheEvent(kind=KvEventKind.CLEARED))


class WorkerMetricsPublisher:
    """Load snapshots on the metrics topic; the engine calls publish() when
    its load or its adapter keys change."""

    def __init__(
        self,
        event_plane: EventPlane,
        namespace: str,
        component: str,
        worker_id: int,
        dp_rank: int = 0,
        clock: Callable[[], float] = time.time,
    ):
        self._plane = event_plane
        self._topic = metrics_topic(namespace, component)
        self.worker = WorkerWithDpRank(worker_id, dp_rank)
        # metric freshness is judged against the consumer's clock (the
        # router's scheduler stamps arrival time); an injected clock keeps
        # both sides on one timeline
        self._clock = clock

    async def publish(
        self,
        active_decode_blocks: int = 0,
        active_prefill_tokens: int = 0,
        num_requests_waiting: int = 0,
        num_requests_active: int = 0,
        total_blocks: int = 0,
        waiting_prefill_blocks: int = 0,
        adapters: Optional[Dict[str, str]] = None,
    ) -> None:
        m = WorkerMetrics(
            worker=self.worker,
            active_decode_blocks=active_decode_blocks,
            active_prefill_tokens=active_prefill_tokens,
            num_requests_waiting=num_requests_waiting,
            num_requests_active=num_requests_active,
            total_blocks=total_blocks,
            waiting_prefill_blocks=waiting_prefill_blocks,
            ts=self._clock(),
            adapters=adapters,
        )
        await self._plane.publish(self._topic, codec.packb(m.to_obj()))
