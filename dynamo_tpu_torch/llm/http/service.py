"""OpenAI-compatible HTTP frontend with SSE streaming.

The port's copy of the reference package's llm/http/service.py, on the
port's own HTTP server (server.py) in place of aiohttp:
/v1/chat/completions, /v1/completions, /v1/embeddings, /v1/responses,
/v1/models plus /health, /live and /metrics, with the reference's
operational behaviours:
a client that disconnects mid-stream cancels its request (the frontend
kills the request's contexts, the request plane carries the cancel to the
worker, whose engine frees the slot), the busy threshold answers 503,
``n`` > 1 fans into n engine streams, and TTFT / ITL / token metrics are
observed per model. Chat and text completions share one request path; the
only per-endpoint differences are request parsing and delta generation.
Chat replies go through the card's reasoning and tool-call parsers
(parsers/), a fresh pair for each choice; an unknown parser name on a card
passes text through with a warning. /v1/responses converts its request to
a chat request, runs it through the same pipeline and answers a Response
object, or streams the Responses SSE events. A request template
(llm/request_template.py, the frontend's ``--request-template``) fills a
chat or completions body's model, temperature and max_completion_tokens
where the client left them unset.

Each model has a circuit breaker over worker availability
(runtime/resilience.py, scope ``DTPU_CB_FRONTEND``): only worker loss (a
503) counts against it, and while it is open, chat, completions,
embeddings and responses answer 503 ``service_unavailable`` with a
``Retry-After`` header after preprocessing, without a send, until a
half-open probe succeeds.

Observability, as the reference's: each generation runs under an
``http.generate`` span (parented on a client ``traceparent`` header; its id
rides the request's annotations to the router and the worker), leaves a
flight-recorder timeline (``/debug/requests[?id=]``), is accounted against
its SLA class (the body's ``sla``, the ``x-dtpu-sla`` header or
``DTPU_SLA_DEFAULT``; an unknown class is a 400) in the frontend's SLO
ledger (``/debug/slo``) and attribution aggregates, and is audited per
``DTPU_AUDIT_SINKS`` (llm/audit.py). ``/debug/fleet`` merges every
worker's ``/debug/worker`` (llm/fleet.py) with each model's breaker and
its workers' breakers.

``POST /clear_kv_blocks`` resets the workers' KV caches (g1 device prefix
cache, g2 / g3 KVBM tiers) through each worker's ``clear_kv_blocks``
endpoint. With ``tls_cert`` and ``tls_key`` it serves HTTPS (an
``ssl.SSLContext`` on the server's listener). /v1/images waits for the
diffusion slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import asyncio
import base64
import copy
import json
import struct
import time
from typing import AsyncIterator, Optional

from ...runtime import metrics as M
from ...runtime.attribution import AttributionAggregator
from ...runtime.engine import Context
from ...runtime.flight_recorder import debug_requests_payload, get_flight_recorder
from ...runtime.errors import InvalidRequestError, http_status_for
from ...runtime.logging import get_logger
from ...parsers import get_reasoning_parser, get_tool_parser
from ...runtime.request_plane.tcp import NoResponders
from ...runtime.resilience import CircuitBreaker
from ...runtime.slo import (
    ANNOTATION_SLA,
    SLA_HEADER,
    SloAccountant,
    SlaSpec,
    debug_slo_payload,
    resolve_sla,
)
from ...runtime.tracing import Tracer, get_tracer
from ..audit import AuditBus
from ..discovery import ModelManager, ModelPipeline
from ..protocols.common import BackendOutput, PreprocessedRequest
from ..protocols.delta import (
    ChatDeltaGenerator,
    CompletionDeltaGenerator,
    aggregate_chat,
    aggregate_chat_multi,
    aggregate_completion,
    aggregate_completion_multi,
    merge_usage,
)
from ..protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    CompletionRequest,
    CompletionResponse,
    EmbeddingData,
    EmbeddingRequest,
    EmbeddingResponse,
    ModelInfo,
    ModelList,
    ResponseMessage,
    ResponseObject,
    ResponseOutputText,
    ResponsesRequest,
    ResponseUsage,
    Usage,
    new_request_id,
)
from .server import (
    DISCONNECT,
    HttpServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)

log = get_logger("llm.http")

SSE_HEADERS = {
    "Content-Type": "text/event-stream",
    "Cache-Control": "no-cache",
    "X-Accel-Buffering": "no",
}


def _safe_parser(factory, name):
    """A bad parser name on a model card must degrade to pass-through, not
    turn every chat request into a 500."""
    try:
        return factory(name)
    except ValueError:
        log.warning("unknown parser %r on model card; passing text through", name)
        return None


def _preprocess_err_type(e: Exception) -> str:
    """OpenAI-style error type for a preprocess-stage failure: typed errors
    carry their own wire type; a plain ValueError is a generic invalid
    request."""
    if isinstance(e, InvalidRequestError):
        return e.err_type
    return "invalid_request_error"


def _error(status: int, message: str, err_type: str = "invalid_request_error",
           headers: Optional[dict] = None) -> Response:
    return json_response(
        {"error": {"message": message, "type": err_type, "code": status}},
        status=status, headers=headers,
    )


def _sse_error_event(message: str, err_type: str) -> bytes:
    payload = json.dumps({"error": {"message": message, "type": err_type}})
    return f"data: {payload}\n\n".encode()


def _sse(chunk) -> bytes:
    return f"data: {chunk.to_json()}\n\n".encode()


class _DataEvents:
    """The SSE framing of chat and completions streams: each chunk a
    ``data:`` event, ``[DONE]`` last."""

    def head(self) -> bytes:
        return b""

    def frame(self, chunk) -> bytes:
        return _sse(chunk)

    def tail(self) -> bytes:
        return b"data: [DONE]\n\n"


def _named_event(name: str, data: dict) -> bytes:
    return f"event: {name}\ndata: {json.dumps(data)}\n\n".encode()


class _ResponsesStream:
    """One /v1/responses request for ``HttpService._run``: its delta
    generator (each output's text a ``response.output_text.delta`` event),
    its SSE framing (``response.created`` first, ``response.completed`` with
    the whole Response object last) and, aggregated, its result."""

    def __init__(self, rid: str, model: str):
        self.rid = rid
        self.model = model
        self.created = int(time.time())
        self.text: list = []
        self.prompt_tokens = 0
        self.completion_tokens = 0

    def on_output(self, out: BackendOutput) -> list:
        self.completion_tokens = out.cumulative_tokens or self.completion_tokens
        if out.annotations and "input_tokens" in out.annotations:
            self.prompt_tokens = out.annotations["input_tokens"]
        if not out.text:
            return []
        self.text.append(out.text)
        return [("response.output_text.delta", {
            "type": "response.output_text.delta",
            "item_id": self.rid + "-msg0", "delta": out.text})]

    async def aggregate(self, streams) -> "_ResponsesStream":
        async for out in streams[0]:
            self.on_output(out)
        return self

    @property
    def usage(self) -> Usage:
        return Usage(prompt_tokens=self.prompt_tokens,
                     completion_tokens=self.completion_tokens,
                     total_tokens=self.prompt_tokens + self.completion_tokens)

    def to_obj(self) -> dict:
        return ResponseObject(
            id=self.rid, created_at=self.created, model=self.model, status="completed",
            output=[ResponseMessage(id=self.rid + "-msg0",
                                    content=[ResponseOutputText(text="".join(self.text))])],
            usage=ResponseUsage(input_tokens=self.prompt_tokens,
                                output_tokens=self.completion_tokens,
                                total_tokens=self.prompt_tokens + self.completion_tokens),
        ).to_obj()

    def head(self) -> bytes:
        return _named_event("response.created", {
            "type": "response.created",
            "response": {"id": self.rid, "object": "response",
                         "status": "in_progress", "model": self.model}})

    def frame(self, event) -> bytes:
        return _named_event(*event)

    def tail(self) -> bytes:
        return _named_event("response.completed", {"type": "response.completed",
                                                   "response": self.to_obj()})


class HttpService:
    def __init__(
        self,
        manager: ModelManager,
        metrics_scope: Optional[M.MetricsScope] = None,
        busy_threshold: Optional[int] = None,
        host: str = "0.0.0.0",
        port: int = 8000,
        tracer: Optional[Tracer] = None,
        audit_bus: Optional[AuditBus] = None,
        request_template=None,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
    ):
        # HTTPS (the frontend's --tls-cert-path / --tls-key-path)
        if bool(tls_cert) != bool(tls_key):
            raise ValueError("tls_cert and tls_key must be given together")
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self.manager = manager
        self.host = host
        self.port = port
        self.busy_threshold = busy_threshold
        # W3C traceparent in -> spans out; audit records per policy
        self.tracer = tracer if tracer is not None else get_tracer()
        self.audit = audit_bus if audit_bus is not None else AuditBus()
        self.inflight = 0
        self.metrics = metrics_scope or M.MetricsScope()
        self._requests = self.metrics.counter(
            M.REQUESTS_TOTAL, "requests", extra_labels=(M.LABEL_MODEL, "status")
        )
        self._inflight_g = self.metrics.gauge(M.INFLIGHT_REQUESTS, "in-flight requests")
        self._duration = self.metrics.histogram(
            M.REQUEST_DURATION_SECONDS, "end-to-end request duration",
            extra_labels=(M.LABEL_MODEL, M.LABEL_SLA_CLASS),
            buckets=(0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0),
        )
        # the client-observed SLO ledger per (model, sla_class), fed from
        # the stream observation below and served on /debug/slo; workers
        # keep their own from the engine's milestones
        self.slo = SloAccountant(metrics=self.metrics)
        # every finished request's timeline decomposed into phases, rolled
        # up per (model, class): served in /debug/fleet
        self.attribution = AttributionAggregator(metrics=self.metrics)
        self._ttft = self.metrics.histogram(
            M.TTFT_SECONDS, "time to first token",
            extra_labels=(M.LABEL_MODEL, M.LABEL_SLA_CLASS),
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
        )
        self._itl = self.metrics.histogram(
            M.ITL_SECONDS, "inter-token latency",
            extra_labels=(M.LABEL_MODEL, M.LABEL_SLA_CLASS),
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
        )
        self._input_tokens = self.metrics.counter(
            M.INPUT_TOKENS, "input tokens", extra_labels=(M.LABEL_MODEL,)
        )
        self._output_tokens = self.metrics.counter(
            M.OUTPUT_TOKENS, "output tokens", extra_labels=(M.LABEL_MODEL,)
        )
        # optional llm.request_template.RequestTemplate: fills model /
        # temperature / max_completion_tokens on requests that omit them
        self.request_template = request_template
        # per-model circuit breaker over worker availability: repeated
        # no-responders (migration exhausted) trip it, and while it is open
        # the frontend sheds load with busy-503 + Retry-After instead of
        # burning a full migration cycle per doomed request. Tunable via
        # DTPU_CB_FRONTEND; its state / transition series ride this
        # service's /metrics registry
        self._model_breakers: dict = {}
        ssl_ctx = None
        if tls_cert:
            import ssl

            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(tls_cert, tls_key)
        self.server = HttpServer(host, port, ssl_context=ssl_ctx)
        for method, path, handler in (
                ("POST", "/v1/chat/completions", self.chat_completions),
                ("POST", "/v1/completions", self.completions),
                ("POST", "/v1/embeddings", self.embeddings),
                ("POST", "/v1/responses", self.responses),
                ("GET", "/v1/models", self.models),
                ("GET", "/health", self.health),
                ("GET", "/live", self.live),
                ("GET", "/metrics", self.metrics_handler),
                ("GET", "/debug/requests", self.debug_requests),
                ("GET", "/debug/slo", self.debug_slo),
                ("GET", "/debug/fleet", self.debug_fleet),
                ("POST", "/clear_kv_blocks", self.clear_kv_blocks)):
            self.server.add_route(method, path, handler)

    def _breaker(self, model: str) -> CircuitBreaker:
        cb = self._model_breakers.get(model)
        if cb is None:
            cb = self._model_breakers[model] = CircuitBreaker.from_env(
                "frontend", name=f"frontend.{model}",
                failure_threshold=5, failure_rate=0.5, window_s=10.0,
                reset_timeout_s=2.0, metrics=self.metrics,
            )
        return cb

    def _check_circuit(self, model: str) -> Optional[Response]:
        """Busy-503 with Retry-After (whole seconds, at least 1) while the
        model's circuit is open."""
        cb = self._breaker(model)
        if cb.allow():
            return None
        retry_after = max(1, int(cb.retry_after_s() + 0.999))
        self._requests.inc(model=model, status="503")
        return _error(503, f"no workers responding for {model!r} (circuit open)",
                      "service_unavailable", headers={"Retry-After": str(retry_after)})

    async def start(self) -> str:
        self.port = await self.server.start()
        log.info("OpenAI %s frontend listening on %s:%d",
                 "HTTPS" if self.tls_cert else "HTTP", self.host, self.port)
        return f"{self.host}:{self.port}"

    async def stop(self) -> None:
        await self.server.stop()
        # a short-lived process would drop a partial span batch
        self.tracer.shutdown()

    # -- aux handlers --------------------------------------------------------
    async def health(self, request: Request) -> Response:
        return json_response({"status": "healthy", "models": self.manager.list_models()})

    async def live(self, request: Request) -> Response:
        return json_response({"status": "live"})

    async def metrics_handler(self, request: Request) -> Response:
        # attainment / burn gauges follow the scrape clock
        self.slo.export_metrics()
        return Response(self.metrics.expose(),
                        content_type="text/plain; version=0.0.4; charset=utf-8")

    async def debug_requests(self, request: Request) -> Response:
        """Flight-recorder timelines, most recent first; ``?id=`` one
        timeline (404 once evicted), ``?limit=`` how many."""
        status, payload = debug_requests_payload(
            get_flight_recorder(), request.query.get("id"), request.query.get("limit"))
        return json_response(payload, status=status)

    async def debug_slo(self, request: Request) -> Response:
        """This frontend's client-observed SLO ledger."""
        return json_response(debug_slo_payload(self.slo))

    async def debug_fleet(self, request: Request) -> Response:
        """Every discovered worker's ``/debug/worker`` merged with this
        frontend's SLO, attribution and breaker views; an unreachable
        worker comes back ``stale``, never as a 500."""
        from ..fleet import fleet_snapshot

        doc = await fleet_snapshot(
            self.manager.pipelines(),
            frontend={"slo": self.slo.snapshot(),
                      "attribution": self.attribution.snapshot(),
                      "model_breakers": {m: cb.state for m, cb in
                                         sorted(self._model_breakers.items())}})
        return json_response(doc)

    def _resolve_sla(self, request: Request, body_class: Optional[str],
                     pipeline: ModelPipeline):
        """(spec, error response): the request's SLA class from the body's
        ``sla``, the x-dtpu-sla header or the default class, with the
        model card's per-class overrides. An unknown class is a 400."""
        name = body_class or request.headers.get(SLA_HEADER)
        spec = resolve_sla(name, pipeline.card.runtime_config.sla_classes)
        if spec is None:
            return None, _error(400, f"unknown SLA class {name!r}", "invalid_request_error")
        return spec, None

    async def clear_kv_blocks(self, request: Request) -> Response:
        """Runtime cache reset across workers. Body (all optional):
        {"model": name, "levels": ["g1", "g2", "g3"]}. Fans out to every
        instance's ``clear_kv_blocks`` endpoint (served beside generate under
        the same instance id) and reports per-worker results; a worker
        without the endpoint is reported, not fatal."""
        try:
            body = request.json() if request.body else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _error(400, "invalid JSON body")
        model = body.get("model")
        levels = body.get("levels")
        if levels is not None and (
            not isinstance(levels, list)
            or not all(isinstance(lv, str) for lv in levels)
        ):
            # a bare string would iterate character-wise downstream and
            # silently clear nothing
            return _error(400, 'levels must be a list of strings, e.g. ["g1"]')
        pipelines = [self.manager.get(model)] if model else self.manager.pipelines()
        if model and pipelines[0] is None:
            return _error(404, f"model {model!r} not found", "model_not_found")
        results: dict = {}
        for pipe in pipelines:
            if pipe is None or pipe.client is None:
                continue
            card = pipe.card
            endpoint = (pipe.runtime.namespace(card.namespace).component(card.component)
                        .endpoint("clear_kv_blocks"))
            client = await endpoint.client()
            per_worker: dict = {}
            try:
                targets = pipe.client.instance_ids()
                # the fresh client's discovery snapshot arrives async
                try:
                    await client.wait_for_instances(len(targets), timeout=5.0)
                except TimeoutError:
                    pass
                for iid in targets:
                    wk = f"{iid:016x}"
                    if iid not in client.instances:
                        per_worker[wk] = {"error": "no clear_kv_blocks endpoint"}
                        continue
                    try:
                        async for item in await client.generate({"levels": levels},
                                                                instance_id=iid):
                            per_worker[wk] = item
                    except (NoResponders, ConnectionError, OSError) as e:
                        per_worker[wk] = {"error": str(e)}
            finally:
                await client.stop()
            results[card.name] = per_worker
        return json_response({"cleared": results})

    async def models(self, request: Request) -> Response:
        data = ModelList(
            data=[ModelInfo(id=m, created=int(time.time()))
                  for m in self.manager.list_models()]
        )
        return json_response(data.to_obj())

    # -- shared request path -------------------------------------------------
    def _observed(self, stream: AsyncIterator[BackendOutput], model: str,
                  t_start: float, request_id: str = "",
                  sla: Optional[SlaSpec] = None) -> AsyncIterator[BackendOutput]:
        """Wrap the token stream with TTFT/ITL observation (one ITL sample
        per output after the first: an output may carry several tokens).
        With an ``sla`` spec the samples are class-labelled and the
        stream's outcome feeds the SLO ledger."""
        cls = sla.sla_class if sla is not None else ""

        async def gen():
            first_at = None
            last_at = None
            n_tokens = 0
            try:
                async for out in stream:
                    if "prefill_worker_id" in (out.annotations or {}):
                        # disaggregation: the prefill router stamps the
                        # remote prefill worker on its output
                        get_flight_recorder().record(
                            request_id, "prefill_done",
                            prefill_worker_id=out.annotations["prefill_worker_id"])
                    if out.token_ids:
                        now = time.monotonic()
                        n_tokens += len(out.token_ids)
                        if first_at is None:
                            first_at = now
                            self._ttft.observe(now - t_start, model=model, sla_class=cls)
                            ann = out.annotations or {}
                            wid = ({"worker_id": ann["worker_id"]} if "worker_id" in ann
                                   else {})
                            get_flight_recorder().record(
                                request_id, "first_token",
                                ttft_ms=round((now - t_start) * 1e3, 3), **wid)
                        elif last_at is not None:
                            self._itl.observe(now - last_at, model=model, sla_class=cls)
                        last_at = now
                    yield out
            finally:
                if sla is not None and first_at is not None:
                    itl = ((last_at - first_at) / (n_tokens - 1) if n_tokens > 1 else None)
                    self.slo.record(model, sla, ttft_s=first_at - t_start, itl_s=itl,
                                    output_tokens=n_tokens,
                                    e2e_s=time.monotonic() - t_start)

        return gen()

    @staticmethod
    def _fan_choices(preq: PreprocessedRequest, n: int) -> list:
        """One PreprocessedRequest per choice, each with its own request id;
        a set seed is offset per choice so choices actually differ."""
        if n <= 1:
            return [preq]
        preqs = []
        for i in range(n):
            p = copy.deepcopy(preq)
            p.request_id = f"{preq.request_id}-c{i}"
            if p.sampling.seed is not None:
                p.sampling.seed += i
            preqs.append(p)
        return preqs

    @staticmethod
    async def _merged(streams):
        """Interleave n token streams as (stream_index, output) pairs in
        arrival order. One failing stream fails the merge (the caller's
        error path kills the surviving contexts)."""
        q: asyncio.Queue = asyncio.Queue()
        done_marker = object()

        async def pump(i, s):
            try:
                async for out in s:
                    await q.put((i, out, None))
            except BaseException as e:  # noqa: BLE001 — relayed, not dropped
                await q.put((i, done_marker, e))
            else:
                await q.put((i, done_marker, None))

        tasks = [asyncio.create_task(pump(i, s)) for i, s in enumerate(streams)]
        done = 0
        try:
            while done < len(streams):
                i, out, err = await q.get()
                if out is done_marker:
                    if err is not None:
                        raise err
                    done += 1
                    continue
                yield i, out
        finally:
            for t in tasks:
                t.cancel()

    async def _run(self, request: Request, preqs, pipeline: ModelPipeline, model: str,
                   stream_mode: bool, delta_gens, aggregator, usage_chunk_factory=None,
                   audit_handle=None, sla: Optional[SlaSpec] = None,
                   events=None, span_name: str = "http.generate"):
        """Execute one generation request: routing, streaming, metrics, errors.

        ``preqs`` / ``delta_gens`` are parallel lists, one entry per choice.
        ``aggregator`` receives the list of streams; ``usage_chunk_factory``
        builds the single trailing usage chunk of a multi-choice stream.
        ``events`` frames a streamed body (``head`` / ``frame`` per chunk /
        ``tail``): ``data:`` chunks and ``[DONE]`` unless given."""
        events = events or _DataEvents()
        circuit = self._check_circuit(model)
        if circuit is not None:
            return circuit
        cb = self._breaker(model)
        ctxs = [Context(p.request_id) for p in preqs]
        self.inflight += 1
        self._inflight_g.set(self.inflight)
        status = "200"
        resp: Optional[StreamResponse] = None
        prompt_tokens = completion_tokens = 0
        rid = preqs[0].request_id
        # the span parents on the client's traceparent header when there is
        # one; the hops downstream get its id through the annotations
        span = self.tracer.span(span_name,
                                traceparent=request.headers.get("traceparent"),
                                request_id=rid, model=model, streaming=stream_mode,
                                n=len(preqs))
        sla_ann = sla.to_annotation() if sla is not None else None
        for p in preqs:
            p.annotations["traceparent"] = span.traceparent()
            if sla_ann is not None:
                # the promise rides the request plane like the traceparent
                p.annotations[ANNOTATION_SLA] = dict(sla_ann)
        span.__enter__()
        flight = get_flight_recorder()
        flight.record(rid, "received", model=model, streaming=stream_mode,
                      choices=len(preqs),
                      **({"sla_class": sla.sla_class} if sla is not None else {}))
        flight.record(rid, "tokenized", prompt_tokens=len(preqs[0].token_ids))
        fail_msg: Optional[str] = None
        fail_type = "internal_error"
        t0 = time.monotonic()
        streams = [self._observed(pipeline.generate_tokens(p, c), model, t0,
                                  request_id=rid, sla=sla)
                   for p, c in zip(preqs, ctxs)]
        try:
            if stream_mode:
                resp = StreamResponse(request, headers=SSE_HEADERS)
                await resp.prepare()
                # disconnect -> cancel: the contexts' cancel reaches the
                # worker over the request plane and frees the engine slot
                request.on_disconnect(lambda: [c.kill() for c in ctxs])
                try:
                    head = events.head()
                    if head:
                        await resp.write(head)
                    if len(streams) == 1:
                        # hot path: no queue hop per output
                        async for out in streams[0]:
                            for chunk in delta_gens[0].on_output(out):
                                await resp.write(events.frame(chunk))
                    else:
                        async for i, out in self._merged(streams):
                            for chunk in delta_gens[i].on_output(out):
                                await resp.write(events.frame(chunk))
                        if usage_chunk_factory is not None:
                            chunk = usage_chunk_factory()
                            if chunk is not None:
                                await resp.write(events.frame(chunk))
                    await resp.write(events.tail())
                    await resp.write_eof()
                except DISCONNECT:
                    status = "499"
                    for c in ctxs:
                        c.kill()
                finally:
                    prompt_tokens = max(g.prompt_tokens for g in delta_gens)
                    completion_tokens = sum(g.completion_tokens for g in delta_gens)
                    if audit_handle is not None:
                        audit_handle.set_response({
                            "streamed": True, "completion_tokens": completion_tokens,
                            "prompt_tokens": prompt_tokens})
                return resp
            result = await aggregator(streams)
            usage = result.usage
            if usage is not None:
                prompt_tokens, completion_tokens = usage.prompt_tokens, usage.completion_tokens
            if audit_handle is not None:
                audit_handle.set_response(result.to_obj())
            return json_response(result.to_obj())
        except NoResponders:
            status = "503"
            fail_msg, fail_type = "no workers available", "service_unavailable"
            return await self._fail(resp, 503, "no workers available", "service_unavailable")
        except asyncio.CancelledError:
            status = "499"
            for c in ctxs:
                c.kill()
            raise
        except Exception as e:
            log.exception("request %s failed", rid[:16])
            code, etype = http_status_for(e)
            status = str(code)
            fail_msg, fail_type = str(e), etype
            return await self._fail(resp, code, str(e), etype)
        finally:
            for s in streams:
                try:
                    await s.aclose()
                except RuntimeError:
                    pass  # still running in a cancelled merge pump: it ends there
            self.inflight -= 1
            self._inflight_g.set(self.inflight)
            # only worker loss (503) counts against the circuit: an
            # application error means the workers ARE responding
            cb.record(status != "503")
            failed = status not in ("200", "499")
            if sla is not None and failed and completion_tokens == 0:
                # died before a first token: the stream observation never
                # accounted it, and a promise broken by an outage is what
                # the client-observed ledger is for
                self.slo.record(model, sla, ttft_s=None, output_tokens=0,
                                e2e_s=time.monotonic() - t0)
            self._requests.inc(model=model, status=status)
            self._duration.observe(time.monotonic() - t0, model=model,
                                   sla_class=sla.sla_class if sla is not None else "")
            self._input_tokens.inc(prompt_tokens, model=model)
            self._output_tokens.inc(completion_tokens, model=model)
            for c in ctxs:
                c.stop_generating()
            span.set(status=status, completion_tokens=completion_tokens)
            if failed:
                # errors became responses before the span closes
                span.status = "ERROR"
            span.__exit__(None, None, None)
            # a failed request dumps its timeline; 499 is the client
            # hanging up, not a failure
            flight.finish(rid, error=fail_msg if failed else None, error_class=fail_type,
                          status=status, completion_tokens=completion_tokens)
            self._observe_attribution(model, sla, rid, flight)
            if audit_handle is not None:
                audit_handle.emit()
                await self.audit.drain_async_sinks()

    def _observe_attribution(self, model, sla, rid, flight) -> None:
        """Fold the finished request's timeline into the rolling phase
        aggregates (read back after finish(), so milestones stamped by an
        engine in this process are in it)."""
        try:
            timeline = flight.timeline(rid)
            if timeline is not None:
                self.attribution.observe_flight(
                    model, sla.sla_class if sla is not None else "unclassified", timeline)
        except Exception:
            log.exception("attribution observe failed for %s", rid[:16])

    async def _fail(self, resp: Optional[StreamResponse], status: int, msg: str,
                    err_type: str):
        """Error path that respects an already-started SSE stream: once the
        head went out, only an error event can be appended."""
        if resp is None:
            return _error(status, msg, err_type)
        try:
            await resp.write(_sse_error_event(msg, err_type))
            await resp.write_eof()
        except DISCONNECT:
            pass
        return resp

    def _check_capacity(self) -> Optional[Response]:
        if self.busy_threshold is not None and self.inflight >= self.busy_threshold:
            return _error(503, "service busy", "service_unavailable")
        return None

    # -- endpoints -----------------------------------------------------------
    async def chat_completions(self, request: Request):
        busy = self._check_capacity()
        if busy is not None:
            return busy
        try:
            body = request.json()
            if self.request_template is not None:
                body = self.request_template.apply(body)
            req = ChatCompletionRequest.from_obj(body)
        except ValueError as e:
            return _error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return _error(404, f"model '{req.model}' not found", "model_not_found")
        sla, sla_err = self._resolve_sla(request, req.sla, pipeline)
        if sla_err is not None:
            return sla_err
        try:
            preq = await pipeline.preprocessor.apreprocess_chat(req)
        except ValueError as e:
            return _error(400, str(e), _preprocess_err_type(e))

        include_usage = bool(req.stream_options and req.stream_options.include_usage)
        card = pipeline.card
        rid = preq.request_id
        preqs = self._fan_choices(preq, req.n)
        # parsers are stateful stream machines: one instance per choice
        reasoning_factory = lambda: _safe_parser(get_reasoning_parser, card.reasoning_parser)  # noqa: E731
        tool_factory = lambda: _safe_parser(get_tool_parser, card.tool_parser)  # noqa: E731
        # multi-choice: one merged usage chunk at stream end instead of one
        # per choice
        gens = [ChatDeltaGenerator(rid, req.model, include_usage and len(preqs) == 1,
                                   reasoning_parser=reasoning_factory(),
                                   tool_parser=tool_factory(),
                                   tool_choice=req.tool_choice, index=i)
                for i in range(len(preqs))]
        usage_chunk_factory = None
        if include_usage and len(preqs) > 1:
            usage_chunk_factory = lambda: ChatCompletionChunk(  # noqa: E731
                id=rid, created=gens[0].created, model=req.model, choices=[],
                usage=merge_usage(gens),
            )
        if len(preqs) == 1:
            aggregator = lambda ss: aggregate_chat(  # noqa: E731
                rid, req.model, ss[0], reasoning_parser=reasoning_factory(),
                tool_parser=tool_factory(), tool_choice=req.tool_choice)
        else:
            aggregator = lambda ss: aggregate_chat_multi(  # noqa: E731
                rid, req.model, ss, reasoning_parser_factory=reasoning_factory,
                tool_parser_factory=tool_factory, tool_choice=req.tool_choice)
        audit_handle = self.audit.create_handle(body, rid, req.model, req.stream)
        return await self._run(request, preqs, pipeline, req.model, req.stream, gens,
                               aggregator, usage_chunk_factory=usage_chunk_factory,
                               audit_handle=audit_handle, sla=sla)

    async def completions(self, request: Request):
        busy = self._check_capacity()
        if busy is not None:
            return busy
        try:
            body = request.json()
            if self.request_template is not None:
                body = self.request_template.apply(body)
            req = CompletionRequest.from_obj(body)
        except ValueError as e:
            return _error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return _error(404, f"model '{req.model}' not found", "model_not_found")
        sla, sla_err = self._resolve_sla(request, req.sla, pipeline)
        if sla_err is not None:
            return sla_err
        prompt = req.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], (list, str)):
            if len(prompt) > 1 or isinstance(prompt[0], list):
                return _error(400, "batched prompts not supported; send one request "
                                   "per prompt")
            prompt = prompt[0]
        try:
            preq = pipeline.preprocessor.preprocess_completion(req, prompt)
        except ValueError as e:
            return _error(400, str(e), _preprocess_err_type(e))

        include_usage = bool(req.stream_options and req.stream_options.include_usage)
        rid = preq.request_id
        preqs = self._fan_choices(preq, req.n)
        echo_text = prompt if (req.echo and isinstance(prompt, str)) else ""
        gens = [CompletionDeltaGenerator(rid, req.model, include_usage and len(preqs) == 1,
                                         text_offset=len(echo_text), index=i)
                for i in range(len(preqs))]
        usage_chunk_factory = None
        if include_usage and len(preqs) > 1:
            usage_chunk_factory = lambda: CompletionResponse(  # noqa: E731
                id=rid, created=gens[0].created, model=req.model, choices=[],
                usage=merge_usage(gens),
            )
        if len(preqs) == 1:
            aggregator = lambda ss: aggregate_completion(  # noqa: E731
                rid, req.model, ss[0], echo_text)
        else:
            aggregator = lambda ss: aggregate_completion_multi(  # noqa: E731
                rid, req.model, ss, echo_text)
        audit_handle = self.audit.create_handle(body, rid, req.model, req.stream)
        return await self._run(request, preqs, pipeline, req.model, req.stream, gens,
                               aggregator, usage_chunk_factory=usage_chunk_factory,
                               audit_handle=audit_handle, sla=sla)

    async def embeddings(self, request: Request) -> Response:
        """/v1/embeddings off a pooled forward: a string, a list of strings,
        or pre-tokenized int lists."""
        busy = self._check_capacity()
        if busy is not None:
            return busy
        try:
            req = EmbeddingRequest.from_obj(request.json())
        except ValueError as e:
            return _error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return _error(404, f"model '{req.model}' not found", "model_not_found")
        inputs = req.input
        if isinstance(inputs, str) or (inputs and isinstance(inputs[0], int)):
            inputs = [inputs]
        if not inputs or any(
            (isinstance(item, (str, list)) and len(item) == 0) for item in inputs
        ):
            return _error(400, "input must not be empty")
        model = req.model
        # preprocess up front so client mistakes are 400s, not worker errors
        preqs = []
        try:
            for item in inputs:
                preq = pipeline.preprocessor.preprocess_completion(
                    CompletionRequest(model=model, prompt=item, max_tokens=1), item
                )
                preq.request_id = new_request_id("embd")
                preq.annotations["op"] = "embed"
                preqs.append(preq)
        except ValueError as e:
            return _error(400, str(e), _preprocess_err_type(e))
        circuit = self._check_circuit(model)
        if circuit is not None:
            return circuit
        cb = self._breaker(model)
        self.inflight += 1
        self._inflight_g.set(self.inflight)
        status = "200"
        prompt_tokens = 0

        async def one(preq) -> tuple:
            ctx = Context(preq.request_id)
            try:
                async for out in pipeline.generate_tokens(preq, ctx):
                    if out.annotations and "embedding" in out.annotations:
                        return (
                            out.annotations["embedding"],
                            out.annotations.get("input_tokens", len(preq.token_ids)),
                        )
            finally:
                ctx.stop_generating()
            return None, 0

        try:
            # independent pooled forwards: fan out, assemble by index
            results = await asyncio.gather(*[one(p) for p in preqs], return_exceptions=True)
            for r in results:
                if isinstance(r, BaseException):
                    raise r
            data = []
            for i, (emb, n_toks) in enumerate(results):
                if emb is None:
                    status = "500"
                    return _error(500, "worker returned no embedding (model may not "
                                       "support embeddings)", "internal_error")
                prompt_tokens += n_toks
                if req.dimensions:
                    # renormalize after Matryoshka-style truncation (OpenAI
                    # semantics: unit vectors)
                    emb = emb[: req.dimensions]
                    norm = sum(v * v for v in emb) ** 0.5
                    if norm > 0:
                        emb = [v / norm for v in emb]
                if req.encoding_format == "base64":
                    emb = base64.b64encode(struct.pack(f"<{len(emb)}f", *emb)).decode()
                data.append(EmbeddingData(index=i, embedding=emb))
            resp = EmbeddingResponse(
                data=data, model=model,
                usage=Usage(prompt_tokens=prompt_tokens, total_tokens=prompt_tokens),
            )
            return json_response(resp.to_obj())
        except NoResponders:
            status = "503"
            return _error(503, "no workers available", "service_unavailable")
        except Exception as e:
            log.exception("embeddings request failed")
            status = "500"
            return _error(500, str(e), "internal_error")
        finally:
            self.inflight -= 1
            self._inflight_g.set(self.inflight)
            cb.record(status != "503")
            self._requests.inc(model=model, status=status)
            self._input_tokens.inc(prompt_tokens, model=model)

    async def responses(self, request: Request):
        """/v1/responses: the request converted to a chat completion, run
        through the normal pipeline, and the result converted back to a
        Response object; streamed, the Responses SSE events
        (response.created, response.output_text.delta per output,
        response.completed)."""
        busy = self._check_capacity()
        if busy is not None:
            return busy
        try:
            body = request.json()
            rreq = ResponsesRequest.from_obj(body)
            chat = rreq.to_chat()
        except ValueError as e:
            return _error(400, f"invalid request: {e}")
        pipeline = self.manager.get(rreq.model)
        if pipeline is None:
            return _error(404, f"model '{rreq.model}' not found", "model_not_found")
        sla, sla_err = self._resolve_sla(request, rreq.sla, pipeline)
        if sla_err is not None:
            return sla_err
        try:
            preq = await pipeline.preprocessor.apreprocess_chat(chat)
        except ValueError as e:
            return _error(400, str(e), _preprocess_err_type(e))
        gen = _ResponsesStream(preq.request_id.replace("chatcmpl-", "resp_"), rreq.model)
        audit_handle = self.audit.create_handle(body, preq.request_id, rreq.model, rreq.stream)
        return await self._run(request, [preq], pipeline, rreq.model, rreq.stream, [gen],
                               gen.aggregate, audit_handle=audit_handle, sla=sla,
                               events=gen, span_name="http.responses")
