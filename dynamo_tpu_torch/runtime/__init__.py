"""Distributed runtime of the port: component model, request and event
planes, discovery, metrics. Standard library only (and the port's own
MessagePack codec)."""

from .component import (
    Client,
    Component,
    Endpoint,
    Instance,
    Namespace,
    RouterMode,
    ServedEndpoint,
)
from .config import RuntimeConfig
from .discovery.store import (
    EventType,
    FileKVStore,
    KVStore,
    MemKVStore,
    WatchEvent,
    make_store,
)
from .distributed import DistributedRuntime
from .engine import AsyncEngine, Context, FnEngine, Operator, collect
from .errors import ContextLengthError, GuidedRejectedError, InvalidRequestError
from .event_plane.base import EventPlane, InProcEventPlane, Subscription
from .faults import FAULTS, FaultInjected, FaultRegistry, InjectedDrop
from .logging import get_logger, init_logging
from .metrics import MetricsScope
from .request_plane.tcp import NoResponders, RequestPlaneError, TcpClient, TcpRequestServer
from .resilience import CircuitBreaker, CircuitOpenError, RetryPolicy

__all__ = [
    "AsyncEngine",
    "CircuitBreaker",
    "CircuitOpenError",
    "Client",
    "Component",
    "Context",
    "ContextLengthError",
    "DistributedRuntime",
    "Endpoint",
    "EventPlane",
    "EventType",
    "FAULTS",
    "FaultInjected",
    "FaultRegistry",
    "FileKVStore",
    "FnEngine",
    "GuidedRejectedError",
    "InProcEventPlane",
    "InjectedDrop",
    "Instance",
    "InvalidRequestError",
    "KVStore",
    "MemKVStore",
    "MetricsScope",
    "Namespace",
    "NoResponders",
    "Operator",
    "RequestPlaneError",
    "RetryPolicy",
    "RouterMode",
    "RuntimeConfig",
    "ServedEndpoint",
    "Subscription",
    "TcpClient",
    "TcpRequestServer",
    "WatchEvent",
    "collect",
    "get_logger",
    "init_logging",
    "make_store",
]
