"""Component model: Namespace -> Component -> Endpoint -> Instance.

The port's copy of the reference package's runtime/component.py: the
component hierarchy and the client-side round-robin / random / direct
selection of ``RouterMode``; in KV mode the caller (llm/discovery.py's
KV router) picks the instance and passes its id. The reference's
``Client.kv_selector`` hook, which nothing there sets, is left out.

A worker *serves* an endpoint (registers an Instance in the discovery store
under ``v1/instances/...`` tied to its lease); a frontend builds a *Client*
on the same endpoint which watches that prefix and routes requests to live
instances over the request plane.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import random
import uuid
from typing import Any, AsyncIterator, Dict, List, Optional

from . import codec
from .discovery.store import EventType, KVStore, Watcher
from .engine import Context
from .logging import get_logger
from .request_plane.tcp import Handler, NoResponders, TcpClient, TcpRequestServer
from .tasks import spawn_bg

log = get_logger("runtime.component")

INSTANCES_PREFIX = "v1/instances"


def instance_key(namespace: str, component: str, endpoint: str, instance_id: int) -> str:
    return f"{INSTANCES_PREFIX}/{namespace}/{component}/{endpoint}/{instance_id:016x}"


def new_instance_id() -> int:
    return uuid.uuid4().int & ((1 << 63) - 1)


@dataclasses.dataclass
class Instance:
    """A live serving unit."""

    instance_id: int
    namespace: str
    component: str
    endpoint: str
    address: str          # request-plane address, e.g. "127.0.0.1:4431"
    transport: str = "tcp"
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_obj(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "Instance":
        return cls(**obj)


class RouterMode(enum.Enum):
    ROUND_ROBIN = "round-robin"
    RANDOM = "random"
    DIRECT = "direct"
    KV = "kv"


class Namespace:
    def __init__(self, runtime: "DistributedRuntimeBase", name: str):
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self, name)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Namespace({self.name})"


class Component:
    def __init__(self, namespace: Namespace, name: str):
        self.namespace = namespace
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntimeBase":
        return self.namespace.runtime

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    @property
    def path(self) -> str:
        return f"{self.namespace.name}/{self.name}"

    def __repr__(self) -> str:  # pragma: no cover
        return f"Component({self.path})"


class Endpoint:
    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name

    @property
    def runtime(self) -> "DistributedRuntimeBase":
        return self.component.runtime

    @property
    def path(self) -> str:
        return f"{self.component.path}/{self.name}"

    @property
    def subject_prefix(self) -> str:
        ns = self.component.namespace.name
        return f"{INSTANCES_PREFIX}/{ns}/{self.component.name}/{self.name}/"

    async def serve(
        self,
        handler: Handler,
        instance_id: Optional[int] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> "ServedEndpoint":
        """Start a request-plane server for ``handler`` and register it."""
        rt = self.runtime
        iid = instance_id if instance_id is not None else new_instance_id()
        if getattr(rt.config, "request_plane", "tcp") == "http":
            from .request_plane.http import HttpRequestServer

            server = HttpRequestServer(handler, host=rt.config.host_ip)
        else:
            server = TcpRequestServer(handler, host=rt.config.host_ip)
        address = await server.start()
        inst = Instance(
            instance_id=iid,
            namespace=self.component.namespace.name,
            component=self.component.name,
            endpoint=self.name,
            address=address,
            metadata=metadata or {},
        )
        key = instance_key(inst.namespace, inst.component, inst.endpoint, iid)
        await rt.store.put_obj(key, inst.to_obj(), rt.lease_id)
        log.info("serving %s as instance %016x at %s", self.path, iid, address)
        served = ServedEndpoint(self, inst, server, key)
        getattr(rt, "served", []).append(served)
        return served

    async def client(self, router_mode: RouterMode = RouterMode.ROUND_ROBIN) -> "Client":
        client = Client(self, router_mode)
        await client.start()
        return client


class ServedEndpoint:
    def __init__(self, endpoint: Endpoint, instance: Instance, server: TcpRequestServer, key: str):
        self.endpoint = endpoint
        self.instance = instance
        self.server = server
        self._key = key
        # additional lease-attached keys (e.g. model cards) that live and die
        # with this endpoint: key -> MessagePack-able object
        self.extra_objs: Dict[str, Any] = {}

    @property
    def instance_id(self) -> int:
        return self.instance.instance_id

    @property
    def address(self) -> str:
        return self.instance.address

    async def update_metadata(self, metadata: Dict[str, Any]) -> None:
        """Merge ``metadata`` into the instance record and republish it (a
        worker advertises its status port's address so)."""
        self.instance.metadata.update(metadata)
        rt = self.endpoint.runtime
        await rt.store.put_obj(self._key, self.instance.to_obj(), rt.lease_id)

    async def publish_extra(self, key: str, obj: Any) -> None:
        rt = self.endpoint.runtime
        self.extra_objs[key] = obj
        await rt.store.put_obj(key, obj, rt.lease_id)

    async def stop(self, graceful_timeout_s: float = 5.0) -> None:
        rt = self.endpoint.runtime
        if self in getattr(rt, "served", []):
            rt.served.remove(self)
        for key in self.extra_objs:
            await rt.store.delete(key)
        await rt.store.delete(self._key)
        await self.server.stop(graceful_timeout_s)


class _TaggedStream:
    """Response stream that knows which instance serves it.

    Transport errors get ``instance_id`` stamped on them mid-iteration, and
    the attribute itself lets consumers (the migration operator) attribute a
    CLEAN stream EOF — a worker teardown that closes the stream without a
    finish frame raises no exception, yet the retry still must exclude the
    dead instance."""

    def __init__(self, stream: AsyncIterator[Any], instance_id: int):
        self._stream = stream
        self.instance_id = instance_id

    def __aiter__(self) -> "_TaggedStream":
        return self

    async def __anext__(self) -> Any:
        try:
            return await self._stream.__anext__()
        except StopAsyncIteration:
            raise
        except (NoResponders, ConnectionError) as e:
            if getattr(e, "instance_id", None) is None:
                e.instance_id = self.instance_id  # type: ignore[attr-defined]
            raise


class Client:
    """Endpoint client with live instance tracking + push routing."""

    def __init__(self, endpoint: Endpoint, router_mode: RouterMode = RouterMode.ROUND_ROBIN):
        self.endpoint = endpoint
        self.router_mode = router_mode
        self.instances: Dict[int, Instance] = {}
        self._rr_index = 0
        self._watcher: Optional[Watcher] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._rt = endpoint.runtime
        self._instances_event = asyncio.Event()

    async def start(self) -> None:
        store = self.endpoint.runtime.store
        self._watcher = await store.watch(self.endpoint.subject_prefix)
        # spawn_bg: a watch loop that dies must log — a silently-dead loop
        # leaves this client routing to a stale instance table forever
        self._watch_task = spawn_bg(self._watch_loop())

    async def _watch_loop(self) -> None:
        assert self._watcher is not None
        async for ev in self._watcher:
            try:
                self._apply_event(ev)
            except Exception:
                # per-event isolation: one corrupt instance record must not
                # kill the loop and freeze the instance table (every later
                # PUT/DELETE would be lost while requests keep routing on
                # stale entries)
                log.exception(
                    "%s: bad instance event (%s)", self.endpoint.path, ev.key
                )

    def _apply_event(self, ev) -> None:
        if ev.type == EventType.PUT and ev.value is not None:
            inst = Instance.from_obj(codec.unpackb(ev.value))
            self.instances[inst.instance_id] = inst
            self._instances_event.set()
        elif ev.type == EventType.DELETE:
            iid_hex = ev.key.rsplit("/", 1)[-1]
            try:
                self.instances.pop(int(iid_hex, 16), None)
            except ValueError:
                pass
            if not self.instances:
                self._instances_event.clear()

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> List[Instance]:
        deadline = asyncio.get_event_loop().time() + timeout
        while len(self.instances) < n:
            remaining = deadline - asyncio.get_event_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"{self.endpoint.path}: {len(self.instances)}/{n} instances after {timeout}s"
                )
            try:
                await asyncio.wait_for(self._instances_event.wait(), remaining)
            except asyncio.TimeoutError:
                pass
            if len(self.instances) < n:
                self._instances_event.clear()
        return list(self.instances.values())

    def instance_ids(self) -> List[int]:
        return sorted(self.instances)

    # -- selection ----------------------------------------------------------
    def _select(self, request: Any, instance_id: Optional[int]) -> Instance:
        if not self.instances:
            raise NoResponders(f"no instances for {self.endpoint.path}")
        if instance_id is not None:
            inst = self.instances.get(instance_id)
            if inst is None:
                raise NoResponders(f"instance {instance_id:016x} gone")
            return inst
        ids = sorted(self.instances)
        if self.router_mode == RouterMode.RANDOM:
            return self.instances[random.choice(ids)]
        # ROUND_ROBIN default (KV mode resolves instance_id upstream)
        inst = self.instances[ids[self._rr_index % len(ids)]]
        self._rr_index += 1
        return inst

    async def generate(
        self,
        request: Any,
        context: Optional[Context] = None,
        instance_id: Optional[int] = None,
    ) -> AsyncIterator[Any]:
        """Route a request and stream back responses.

        Failures carry the chosen ``instance_id`` (set on the exception), at
        call time AND mid-stream: the migration operator excludes that worker
        on retry — without the tag, a "connection lost" mid-stream retry
        could round-robin straight back onto the dead worker.
        """
        inst = self._select(request, instance_id)
        try:
            stream = await self._rt.plane_client(inst.address).call(
                inst.address, request, context
            )
        except (NoResponders, ConnectionError) as e:
            if getattr(e, "instance_id", None) is None:
                e.instance_id = inst.instance_id  # type: ignore[attr-defined]
            raise
        return _TaggedStream(stream, inst.instance_id)

    async def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()


class DistributedRuntimeBase:
    """Interface Namespace/Component/Endpoint expect; impl in distributed.py."""

    store: KVStore
    tcp_client: TcpClient
    lease_id: Optional[str]
    config: Any

    def plane_client(self, address: str):
        """The transport by the address's scheme: http(s):// the HTTP plane,
        else TCP."""
        if address.startswith("http"):
            return self.http_client
        return self.tcp_client

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)
