"""KV-cache-aware routing: prefix index + cost-based worker selection.

The port's copy of the reference package's kv_router: workers publish their
KV cache events and load (publisher.py) on the event plane; the frontend's
``KvRouter`` (router.py) indexes them (indexer.py, radix_tree.py) and sends
each request to the worker whose cached prefix and load cost least
(scheduler.py)."""

from .indexer import ApproxKvIndexer, KvIndexer
from .protocols import (
    KvCacheEvent,
    KvEventKind,
    OverlapScores,
    RouterEvent,
    WorkerMetrics,
    WorkerWithDpRank,
)
from .publisher import KvEventPublisher, WorkerMetricsPublisher, events_topic, metrics_topic
from .radix_tree import RadixTree
from .router import KvRouter
from .scheduler import KvRouterConfig, KvScheduler, SchedulingDecision

__all__ = [
    "ApproxKvIndexer",
    "KvCacheEvent",
    "KvEventKind",
    "KvEventPublisher",
    "KvIndexer",
    "KvRouter",
    "KvRouterConfig",
    "KvScheduler",
    "OverlapScores",
    "RadixTree",
    "RouterEvent",
    "SchedulingDecision",
    "WorkerMetrics",
    "WorkerMetricsPublisher",
    "WorkerWithDpRank",
    "events_topic",
    "metrics_topic",
]
