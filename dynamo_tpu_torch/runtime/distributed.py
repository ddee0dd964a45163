"""DistributedRuntime: the per-process root object.

The port's copy of the reference package's runtime/distributed.py: owns
the discovery store connection, a primary lease with keepalive, the
request-plane client, the event plane (in-process, or under ``zmq`` the
port's own broker, event_plane/tcp_plane.py), and the process metrics
registry. Everything else (namespaces, components, endpoints) hangs off it.
The shared retry policies and breakers of runtime/resilience.py export their
series through the first runtime's registry (the process's /metrics), and
``shutdown`` drains the runtime's task tracker (in a worker, its health-event
publishes) for up to ``RuntimeConfig.graceful_shutdown_timeout_s`` before it
cancels what is left and closes the event plane.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .component import DistributedRuntimeBase
from .config import RuntimeConfig
from .discovery.store import KVStore, make_store
from .event_plane.base import EventPlane, InProcEventPlane
from .faults import FAULTS
from .logging import get_logger, init_logging
from .metrics import MetricsScope
from .request_plane.tcp import TcpClient
from .resilience import adopt_metrics_scope, retry_policy
from .tasks import TaskTracker

log = get_logger("runtime.distributed")


class DistributedRuntime(DistributedRuntimeBase):
    def __init__(
        self,
        config: Optional[RuntimeConfig] = None,
        store: Optional[KVStore] = None,
        event_plane: Optional[EventPlane] = None,
    ):
        init_logging()
        self.config = config or RuntimeConfig.from_env()
        self._owns_store = store is None
        self.store = store if store is not None else make_store(self.config.store, self.config.store_path)
        self._event_plane = event_plane
        self._owns_event_plane = event_plane is None
        self.tcp_client = TcpClient()
        self._http_client = None  # the HTTP plane's client, made on first use
        self.metrics = MetricsScope()
        # shared retry policies / breakers created after this point export
        # their series through this runtime's registry (-> /metrics)
        adopt_metrics_scope(self.metrics)
        # supervised background work: components spawn under runtime.tasks,
        # and shutdown() drains the whole tree
        self.tasks = TaskTracker(name="runtime")
        self.lease_id: Optional[str] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self._started = False
        # ServedEndpoints register here so their instance keys can be re-put
        # if the lease is ever lost and re-acquired
        self.served: list = []

    @property
    def http_client(self):
        if self._http_client is None:
            from .request_plane.http import HttpClient

            self._http_client = HttpClient()
        return self._http_client

    async def start(self) -> "DistributedRuntime":
        if self._started:
            return self
        self._started = True
        lease = await self.store.create_lease(self.config.lease_ttl_s)
        self.lease_id = lease.id
        self._keepalive_task = asyncio.create_task(self._keepalive_loop(lease.ttl_s))
        if self._event_plane is None:
            if self.config.event_plane == "zmq":
                from .event_plane.tcp_plane import event_plane_from_store

                self._event_plane = await event_plane_from_store(self.store, self.lease_id)
            elif self.config.event_plane == "inproc":
                self._event_plane = InProcEventPlane()
            else:
                raise ValueError(f"event plane {self.config.event_plane!r}: zmq or inproc")
        log.debug("runtime started (lease=%s, store=%s)", lease.id[:8], self.config.store)
        return self

    @property
    def event_plane(self) -> EventPlane:
        assert self._event_plane is not None, "runtime not started"
        return self._event_plane

    async def _keepalive_loop(self, ttl_s: float) -> None:
        interval = max(ttl_s / 3.0, 0.2)
        try:
            while True:
                await asyncio.sleep(interval)
                if self.lease_id is None:
                    continue
                try:
                    await FAULTS.ainject("discovery.lease_keepalive")
                    ok = await self.store.keep_alive(self.lease_id)
                except Exception as e:
                    # a raising heartbeat must not kill the loop — treat it
                    # as a missed beat and let the lease path recover
                    log.warning("lease keepalive error: %s", e)
                    ok = False
                if not ok:
                    log.warning("lease %s lost; re-acquiring", self.lease_id[:8])
                    try:
                        # shared policy (scope discovery.lease): the store
                        # may be mid-restart; back off instead of hot-looping
                        lease = await retry_policy(
                            "discovery.lease",
                            max_attempts=4, base_delay_s=0.1, max_delay_s=2.0,
                            retryable=(Exception,),
                        ).acall(self.store.create_lease, ttl_s)
                    except Exception:
                        log.exception(
                            "lease re-acquire failed; retrying next beat"
                        )
                        continue
                    self.lease_id = lease.id
                    # lease expiry deleted our instance keys: re-register
                    # every endpoint this runtime still serves
                    for served in list(self.served):
                        try:
                            await self.store.put_obj(
                                served._key, served.instance.to_obj(), self.lease_id
                            )
                            for k, obj in served.extra_objs.items():
                                await self.store.put_obj(k, obj, self.lease_id)
                        except Exception:
                            log.exception("re-register %s failed", served._key)
        except asyncio.CancelledError:
            pass

    async def shutdown(self) -> None:
        await self.tasks.graceful_shutdown(
            timeout=self.config.graceful_shutdown_timeout_s)
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
            await asyncio.gather(self._keepalive_task, return_exceptions=True)
        if self.lease_id is not None:
            try:
                await self.store.revoke_lease(self.lease_id)
            except Exception:  # best effort during teardown
                pass
            self.lease_id = None
        if self._event_plane is not None and self._owns_event_plane:
            await self._event_plane.close()
        await self.tcp_client.close()
        if self._http_client is not None:
            await self._http_client.close()
        if self._owns_store:
            await self.store.close()
        self._started = False

    async def __aenter__(self) -> "DistributedRuntime":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.shutdown()
