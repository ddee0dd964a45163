"""Planned worker death: the drain coordinator.

The port's copy of the reference package's engine/drain.py. A reclaim
notice (a spot reclaim, a rolling upgrade) arrives with a deadline, on the
worker's ``POST /drain`` (runtime/health.py) or from a supervisor calling
``DrainCoordinator.begin``. The coordinator then:

1. flips the worker's discovery record to ``state=draining``: frontends
   stop routing new work and migration retries here (llm/discovery.py
   ``_draining``);
2. lets short in-flight requests finish inside the deadline, less a margin
   (``DTPU_DRAIN_MARGIN_S``). Longer ones are the frontend's: when the
   worker dies their error frames carry an evacuation plan that points the
   retry at this worker's sealed KV (``TorchEngine._evacuation_plan``);
3. checkpoints the warm state (the prefix cache's sealed pages, their LRU
   order, the queue, the weights by reference) to the G3 directory
   (``DTPU_CKPT_DIR``, engine/checkpoint.py), from which the replacement
   restores warm;
4. calls ``on_drained`` (the worker wires its stop event there: it exits).

The drain lease (``DrainLedger``) brackets the whole run; every path out of
``begin`` releases it, so that no worker stays ``draining`` with no drain
running. The run's steps are a flight timeline under the id ``drain``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Dict, List, Optional

from ..runtime import metrics as M
from ..runtime.config import (
    ENV_CKPT_DIR,
    ENV_DRAIN_DEADLINE_S,
    ENV_DRAIN_MARGIN_S,
    env_float,
    env_str,
)
from ..runtime.faults import FAULTS
from ..runtime.flight_recorder import get_flight_recorder
from ..runtime.logging import get_logger

log = get_logger("engine.drain")

# the drain's timeline: notice -> quiesce -> checkpoint on one
# /debug/requests?id=drain record
DRAIN_FLIGHT_ID = "drain"


class DrainLedger:
    """At most one live drain lease per worker process."""

    def __init__(self):
        self._leases: Dict[int, float] = {}
        self._next = 1

    def acquire_drain(self, deadline_s: float) -> Optional[int]:
        """A lease token, or None while a drain is in flight."""
        if self._leases:
            return None
        token = self._next
        self._next += 1
        self._leases[token] = deadline_s
        return token

    def release_drain(self, token: int) -> None:
        self._leases.pop(token, None)

    @property
    def draining(self) -> bool:
        return bool(self._leases)


class DrainCoordinator:
    """One worker's planned-death pipeline. ``served`` is its registered
    endpoint (runtime/component.ServedEndpoint), whose metadata update
    flips the discovery record; ``engine`` the TorchEngine drained."""

    def __init__(self, engine, served, *, ckpt_dir: Optional[str] = None,
                 weights_ref: str = "", metrics_scope=None,
                 on_drained: Optional[Callable[[], None]] = None):
        self.engine = engine
        self.served = served
        self.ckpt_dir = (ckpt_dir if ckpt_dir is not None
                         else (env_str(ENV_CKPT_DIR, "") or None))
        self.weights_ref = weights_ref
        self.ledger = DrainLedger()
        self.on_drained = on_drained
        # the last drain's summary, for /debug/worker and the exit report
        self.last: Optional[Dict[str, Any]] = None
        self._evacuated = (metrics_scope.counter(
            M.DRAIN_EVACUATED_BLOCKS, "sealed KV blocks evacuated/checkpointed during drains")
            if metrics_scope is not None else None)
        self._margin = (metrics_scope.gauge(
            M.DRAIN_DEADLINE_MARGIN,
            "seconds left on the reclaim deadline when the drain finished")
            if metrics_scope is not None else None)

    def _queue_manifest(self) -> List[Dict[str, Any]]:
        """The requests in flight at the checkpoint, for the record (the
        frontend's Migration replays them; the restore does not)."""
        out: List[Dict[str, Any]] = []
        for state_name, seqs in (("running", getattr(self.engine, "_slots", None) or []),
                                 ("waiting", getattr(self.engine, "_waiting", None) or [])):
            for st in seqs:
                rid = getattr(getattr(st, "req", None), "request_id", None)
                if rid is None:
                    continue
                out.append({"request_id": rid, "state": state_name,
                            "produced": int(getattr(st, "produced", 0) or 0)})
        return out

    async def _await_quiesce(self, budget_s: float, t0: float) -> bool:
        """Let short in-flight requests finish inside the budget: True when
        the engine went idle, False when the budget ran out."""
        while time.monotonic() - t0 < budget_s:
            snap = self.engine.snapshot()
            if snap["running"] + snap["waiting"] == 0:
                return True
            await asyncio.sleep(0.05)
        return False

    async def begin(self, deadline_s: Optional[float] = None) -> Dict[str, Any]:
        """Run the drain. A second notice while one runs reports
        ``already=True`` and changes nothing."""
        await FAULTS.ainject("drain.notice")
        if deadline_s is None:
            deadline_s = env_float(ENV_DRAIN_DEADLINE_S, 30.0)
        margin_s = env_float(ENV_DRAIN_MARGIN_S, 2.0)
        token = self.ledger.acquire_drain(deadline_s)
        if token is None:
            return {"state": "draining", "already": True}
        flight = get_flight_recorder()
        flight.record(DRAIN_FLIGHT_ID, "drain_notice", deadline_s=deadline_s)
        t0 = time.monotonic()
        try:
            await self.served.update_metadata({"state": "draining",
                                               "drain_deadline_s": deadline_s})
            log.info("draining: deadline=%.1fs", deadline_s)
            quiesced = await self._await_quiesce(max(0.0, deadline_s - margin_s), t0)
            flight.record(DRAIN_FLIGHT_ID, "drain_quiesce", quiesced=quiesced,
                          elapsed_s=round(time.monotonic() - t0, 3))
            ckpt_blocks = 0
            t_ckpt = time.monotonic()
            if self.ckpt_dir:
                from .checkpoint import checkpoint_engine

                manifest = await checkpoint_engine(self.engine, self.ckpt_dir,
                                                   queue=self._queue_manifest(),
                                                   weights_ref=self.weights_ref)
                ckpt_blocks = len(manifest.get("blocks", ()))
                if self._evacuated is not None and ckpt_blocks:
                    self._evacuated.inc(ckpt_blocks)
            checkpoint_s = time.monotonic() - t_ckpt
            flight.record(DRAIN_FLIGHT_ID, "drain_checkpoint", blocks=ckpt_blocks)
            margin = deadline_s - (time.monotonic() - t0)
            if self._margin is not None:
                self._margin.set(margin)
            log.info("drain complete: quiesced=%s ckpt_blocks=%d margin=%.2fs", quiesced,
                     ckpt_blocks, margin)
            self.last = {"state": "draining", "deadline_s": deadline_s, "quiesced": quiesced,
                         "checkpoint_blocks": ckpt_blocks, "deadline_margin_s": margin,
                         "checkpoint_s": checkpoint_s,
                         "seconds": time.monotonic() - t0}
            if self.on_drained is not None:
                self.on_drained()
            return dict(self.last)
        finally:
            self.ledger.release_drain(token)
