"""Request migration: replay in-flight requests to another worker on failure.

The port's copy of the reference package's llm/migration.py: if the worker
dies before or during generation (NoResponders / dropped stream / an error
finish), re-send the request to a different worker carrying the tokens
already generated (``prior_token_ids``) so decode resumes where it stopped,
bounded by ``migration_limit`` attempts; each migration lands on the
request's flight-recorder timeline. A worker whose engine died attaches an
evacuation plan to the request's error frame (``TorchEngine.
_evacuation_plan``: its transfer address and the request's full-block
hashes); the retry carries it as its ``kv_transfer``, so that the next
worker pulls those pages from the dying worker's host tier instead of
recomputing them, and routing prices destinations by that pull
(llm/discovery.py ``_evacuation_costs``).
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Awaitable, Callable, Dict, List, Optional

from ..runtime.engine import Context
from ..runtime.flight_recorder import get_flight_recorder
from ..runtime.logging import get_logger
from ..runtime.request_plane.tcp import NoResponders
from .protocols.common import BackendOutput, PreprocessedRequest

log = get_logger("llm.migration")

# send(request, context, exclude_instance_ids) -> response stream
SendFn = Callable[[PreprocessedRequest, Context, List[int]], Awaitable[AsyncIterator[Any]]]


class Migration:
    def __init__(self, send: SendFn, migration_limit: int = 0):
        self.send = send
        # DTPU_MIGRATION_LIMIT applies at the worker CLI boundary (the
        # --migration-limit argparse default) so an explicit 0 here still
        # means "migration disabled" — don't re-consult the env
        self.migration_limit = migration_limit

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[BackendOutput]:
        attempts_left = self.migration_limit
        accumulated: List[int] = list(request.prior_token_ids)
        excluded: List[int] = []
        # the evacuation plan of the last failed worker's error frame
        evacuation: Optional[Dict[str, Any]] = None

        while True:
            req = request
            if accumulated != list(request.prior_token_ids) or evacuation is not None:
                # re-issue with progress so the new worker resumes decode
                req = PreprocessedRequest.from_obj(request.to_obj())
                req.prior_token_ids = list(accumulated)
                if req.stop.max_tokens is not None:
                    req.stop.max_tokens = max(
                        1, req.stop.max_tokens - (len(accumulated) - len(request.prior_token_ids))
                    )
                if evacuation is not None:
                    req.kv_transfer = dict(evacuation)
            try:
                stream = await self.send(req, context, excluded)
                async for item in stream:
                    out = item if isinstance(item, BackendOutput) else BackendOutput.from_obj(item)
                    if out.finish_reason == "error" and attempts_left > 0:
                        # a worker-delivered error finish is the engine dying
                        # with the courtesy of a last frame (a loop crash):
                        # migrate like any other worker loss instead of
                        # surfacing the error
                        err = NoResponders("worker reported error finish")
                        iid = getattr(stream, "instance_id", None)
                        if iid is not None:
                            err.instance_id = iid  # type: ignore[attr-defined]
                        evac = out.kv_transfer or out.annotations.get("evacuation")
                        if evac:
                            err.evacuation = evac  # type: ignore[attr-defined]
                        raise err
                    accumulated.extend(out.token_ids)
                    # a resumed worker counts only ITS OWN tokens: normalize
                    # to the original request so usage accounting survives
                    # migration (completion = everything past the original
                    # prior tokens)
                    out.cumulative_tokens = max(
                        out.cumulative_tokens,
                        len(accumulated) - len(request.prior_token_ids),
                    )
                    yield out
                    if out.finish_reason is not None:
                        return
                # stream ended without finish_reason: worker died mid-request.
                # Attribute the instance (the request plane's _TaggedStream
                # carries it) so the retry excludes the dead worker even on a
                # clean EOF with no transport exception.
                eof = NoResponders("stream ended without finish")
                iid = getattr(stream, "instance_id", None)
                if iid is not None:
                    eof.instance_id = iid  # type: ignore[attr-defined]
                raise eof
            except (NoResponders, ConnectionError) as e:
                if context.is_stopped() or attempts_left <= 0:
                    if attempts_left <= 0 and not context.is_stopped():
                        log.warning("migration limit exhausted: %s", e)
                        raise
                    return
                attempts_left -= 1
                # exclude the failed worker on ANY transport loss — a
                # ConnectionError retry that can re-route to the same dead
                # instance defeats the whole operator (the request plane tags
                # instance_id on the exception, runtime/component.py)
                worker_id: Optional[int] = getattr(e, "instance_id", None)
                if worker_id is not None and worker_id not in excluded:
                    excluded.append(worker_id)
                evac = getattr(e, "evacuation", None)
                if evac:
                    evacuation = dict(evac)
                get_flight_recorder().record(
                    request.request_id, "migration",
                    tokens_so_far=len(accumulated), attempts_left=attempts_left,
                    from_worker=(f"{worker_id:016x}" if worker_id is not None else "unknown"),
                    evacuated=bool(evac), error=str(e)[:200],
                )
                log.info(
                    "migrating request %s (%d tokens so far, %d attempts left): %s",
                    req.request_id, len(accumulated), attempts_left, e,
                )
