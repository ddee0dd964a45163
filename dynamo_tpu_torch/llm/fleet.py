"""One-call fleet snapshot: the frontend's ``/debug/fleet`` fan-out.

The port's copy of the reference package's llm/fleet.py; its default fetch
is a standard-library HTTP GET.

Every worker exposes its full observability document on its status server's
``/debug/worker`` route (runtime/health.py StatusServer) and advertises the
server's address in its discovery metadata (``status_address``, stamped by
``engine/__main__.py`` after the side port binds). ``fleet_snapshot`` fans
out to every discovered worker — bounded concurrency, per-worker timeout —
and merges the answers with the frontend's own view (SLO ledger, attribution
windows, per-model breakers) into one JSON document: "what is the fleet
doing right now" in one call instead of N scrapes plus a join by hand.

Partial results are a feature, not a failure: a worker that times out, is
mid-restart, or never advertised an address gets a ``stale: true`` entry
carrying the error, and the merge proceeds — a degraded fleet is exactly
when the snapshot matters most, so a dead worker must never turn the whole
endpoint into a 500.

Knobs: ``DTPU_FLEET_FANOUT`` bounds concurrent worker fetches (default 8);
``DTPU_FLEET_TIMEOUT_S`` is the per-worker fetch timeout (default 2.0 s).
The fetch itself is injectable so tests drive the real fan-out/merge logic
without sockets.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional

from ..runtime.config import (
    ENV_FLEET_FANOUT,
    ENV_FLEET_TIMEOUT_S,
    env_float,
    env_int,
)
from ..runtime.logging import get_logger

log = get_logger("llm.fleet")

DEFAULT_FANOUT = 8
DEFAULT_TIMEOUT_S = 2.0

FetchFn = Callable[[str], Awaitable[Dict[str, Any]]]


async def _http_fetch(address: str, timeout_s: float) -> Dict[str, Any]:
    """Default fetch: GET http://<address>/debug/worker (one connection,
    ``Connection: close``; the status server answers with a
    Content-Length body)."""

    async def get() -> Dict[str, Any]:
        host, port = address.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            writer.write(f"GET /debug/worker HTTP/1.1\r\nHost: {address}\r\n"
                         "Connection: close\r\n\r\n".encode())
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
        head, _, body = raw.partition(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        if status >= 400:
            raise RuntimeError(f"HTTP {status} from {address}")
        return json.loads(body)

    return await asyncio.wait_for(get(), timeout_s)


def _discover_workers(pipelines) -> List[Dict[str, Any]]:
    """Flatten every pipeline's discovery records into fetch targets."""
    targets = []
    for pipe in pipelines:
        client = getattr(pipe, "client", None)
        instances = getattr(client, "instances", None) or {}
        for iid, rec in sorted(instances.items()):
            md = getattr(rec, "metadata", None) or {}
            targets.append({
                "worker_id": f"{iid:016x}" if isinstance(iid, int) else str(iid),
                "model": pipe.card.name,
                "state": md.get("state", "ready"),
                "status_address": md.get("status_address"),
            })
    return targets


async def fleet_snapshot(
    pipelines,
    fetch: Optional[FetchFn] = None,
    fanout: Optional[int] = None,
    timeout_s: Optional[float] = None,
    frontend: Optional[Dict[str, Any]] = None,
    clock: Callable[[], float] = time.time,
) -> Dict[str, Any]:
    """Fan out to every discovered worker's ``/debug/worker`` and merge.

    ``pipelines``: iterable of llm/discovery.py ModelPipeline (duck-typed:
    ``.card.name``, ``.client.instances``, ``._worker_breakers``).
    ``fetch``: injectable ``async (address) -> dict`` (tests); the
    default does a real HTTP GET with the per-worker timeout applied
    around the call either way.
    """
    if fanout is None:
        fanout = env_int(ENV_FLEET_FANOUT, DEFAULT_FANOUT)
    if timeout_s is None:
        timeout_s = env_float(ENV_FLEET_TIMEOUT_S, DEFAULT_TIMEOUT_S)
    targets = _discover_workers(pipelines)
    sem = asyncio.Semaphore(max(1, fanout))

    async def _one(target: Dict[str, Any]) -> Dict[str, Any]:
        entry = dict(target, stale=False)
        address = target["status_address"]
        if not address:
            entry["stale"] = True
            entry["error"] = "no status_address advertised"
            return entry
        try:
            async with sem:
                if fetch is not None:
                    doc = await asyncio.wait_for(fetch(address), timeout_s)
                else:
                    doc = await _http_fetch(address, timeout_s)
            entry["snapshot"] = doc
        except asyncio.TimeoutError:
            entry["stale"] = True
            entry["error"] = f"timed out after {timeout_s}s"
        except Exception as e:
            entry["stale"] = True
            entry["error"] = f"{type(e).__name__}: {e}"
        return entry

    workers = list(await asyncio.gather(*(_one(t) for t in targets)))
    stale = sum(1 for w in workers if w["stale"])
    if stale:
        log.warning("fleet snapshot: %d/%d workers stale", stale, len(workers))

    # per-model rollup: instance counts, frontend breaker, per-worker
    # breaker states (open circuits are the routing plane's own view of
    # worker health — worth seeing next to the workers' self-reports)
    models: Dict[str, Any] = {}
    for pipe in pipelines:
        name = pipe.card.name
        breakers = {
            f"{iid:016x}" if isinstance(iid, int) else str(iid): cb.state
            for iid, cb in sorted(
                getattr(pipe, "_worker_breakers", {}).items()
            )
        }
        models[name] = {
            "instances": len(
                getattr(getattr(pipe, "client", None), "instances", None) or {}
            ),
            "worker_breakers": breakers,
            "open_circuits": sum(1 for s in breakers.values() if s == "open"),
        }

    doc: Dict[str, Any] = {
        "generated_at": round(clock(), 3),
        "fleet": {
            "workers_total": len(workers),
            "workers_live": len(workers) - stale,
            "workers_stale": stale,
            "draining": sum(1 for w in workers if w["state"] == "draining"),
        },
        "models": models,
        "workers": workers,
    }
    doc.update(_merge_worker_sections(workers))
    if frontend is not None:
        doc["frontend"] = frontend
    return doc


def _merge_worker_sections(workers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet-level rollups computed from the live worker documents."""
    kv = {"active_blocks": 0, "free_blocks": 0, "total_blocks": 0}
    gkv = {"published": 0, "inflight_fetches": 0, "dedupe_skipped": 0}
    restore_modes: Dict[str, int] = {}
    health_active: List[Dict[str, Any]] = []
    saw_kv = saw_gkv = False
    for w in workers:
        snap = w.get("snapshot")
        if not isinstance(snap, dict):
            continue
        wkv = snap.get("kv")
        if isinstance(wkv, dict):
            saw_kv = True
            for k in kv:
                v = wkv.get(k)
                if isinstance(v, (int, float)):
                    kv[k] += int(v)
        wgkv = snap.get("global_kv")
        if isinstance(wgkv, dict):
            saw_gkv = True
            for k in gkv:
                v = wgkv.get(k)
                if isinstance(v, (int, float)):
                    gkv[k] += int(v)
        mode = snap.get("restore_mode")
        if isinstance(mode, str):
            restore_modes[mode] = restore_modes.get(mode, 0) + 1
        health = snap.get("health")
        if isinstance(health, dict):
            for item in health.get("active", []) or []:
                health_active.append(dict(item, worker_id=w["worker_id"]))
    merged: Dict[str, Any] = {}
    if saw_kv:
        merged["kv"] = kv
    if saw_gkv:
        merged["global_kv"] = gkv
    if restore_modes:
        merged["restore_modes"] = dict(sorted(restore_modes.items()))
    if health_active:
        merged["health_active"] = health_active
    return merged
