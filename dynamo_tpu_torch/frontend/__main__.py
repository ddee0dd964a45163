"""python -m dynamo_tpu_torch.frontend — the OpenAI HTTP frontend.

The port's counterpart of the reference's ``python -m dynamo_tpu.frontend``:
one process running the OpenAI HTTP server, the model-card watcher, the
preprocessor and the round-robin, random or KV-aware router over the
workers (``python -m dynamo_tpu_torch.engine``) it discovers on the store:

    python -m dynamo_tpu_torch.frontend --store tcp --store-path 127.0.0.1:7460 --port 8000
    python -m dynamo_tpu_torch.frontend --store tcp --store-path 127.0.0.1:7460 \\
        --router-mode kv --event-plane zmq

In ``--router-mode kv`` each model's KV router (kv_router/) follows the
workers' KV events and load on the event plane (``--event-plane zmq``: the
port's own broker, runtime/event_plane/tcp_plane.py; the workers take the
same flag) and sends a request to the worker whose cached prefix and load
cost least; ``--no-kv-events`` predicts the caches from the routing
decisions instead.

It serves /v1/chat/completions, /v1/completions, /v1/embeddings and
/v1/responses; ``--request-template FILE`` (a JSON object with ``model``,
``temperature`` and ``max_completion_tokens``) fills those fields of chat
and completions requests that leave them unset. Routing steers around
workers whose circuit is open (``DTPU_CB_WORKER``), and while a model's
own circuit is open (``DTPU_CB_FRONTEND``) its requests get 503 with
``Retry-After``. ``DTPU_FAULTS`` arms the fault-injection plane
(runtime/faults.py) in this process, e.g.
``DTPU_FAULTS="request_plane.send:drop@p=0.3@seed=11"``.

Prints ``TORCH_FRONTEND_READY <host>:<port>`` once it listens (``--port 0``
takes a free port and prints it). On SIGTERM or SIGINT it stops and prints
``TORCH_FRONTEND_EXIT {json}``: ``router``, for each model in KV mode, the
router's view of each worker (``block_set_view``: block count, digest and
hashes, which a worker's exit line prints for its own prefix cache) and the
events the router applied; ``faults``, the armed points' call counts and
the fired-fault log (``[point, action, call]`` each).

``--grpc-port P`` (0: any free port) also serves the KServe v2 gRPC
frontend (llm/grpc/, on the port's own HTTP/2) over the same models and
prints ``KSERVE_GRPC_READY <port>``; ``--tls-cert-path`` and
``--tls-key-path`` (PEM files, given together) serve the OpenAI frontend
over HTTPS. ``POST /clear_kv_blocks`` resets the workers' KV caches.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
from typing import List, Optional

from ..kv_router import KvRouterConfig
from ..llm.discovery import ModelManager, ModelWatcher
from ..llm.grpc import KserveGrpcService
from ..llm.http.service import HttpService
from ..llm.request_template import RequestTemplate
from ..runtime.component import RouterMode
from ..runtime.config import (
    ENV_BUSY_THRESHOLD,
    ENV_HTTP_PORT,
    ENV_NAMESPACE,
    RuntimeConfig,
    env_int,
    env_str,
)
from ..runtime.distributed import DistributedRuntime
from ..runtime.faults import FAULT_POINTS, FAULTS
from ..runtime.logging import init_logging

READY = "TORCH_FRONTEND_READY"
EXIT = "TORCH_FRONTEND_EXIT"
GRPC_READY = "KSERVE_GRPC_READY"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo_tpu_torch.frontend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=env_int(ENV_HTTP_PORT, 8000))
    p.add_argument("--router-mode", choices=["round-robin", "random", "kv"],
                   default="round-robin")
    p.add_argument("--event-plane", default=None, help="zmq|inproc (default: DTPU_EVENT_PLANE)")
    p.add_argument("--namespace", default=env_str(ENV_NAMESPACE, "dynamo"))
    p.add_argument("--store", default=None, help="mem|file|tcp|etcd (default: DTPU_STORE)")
    p.add_argument("--store-path", default=None)
    p.add_argument("--busy-threshold", type=int,
                   default=(env_int(ENV_BUSY_THRESHOLD, 0) or None),
                   help="answer 503 once this many requests are in flight")
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--no-kv-events", action="store_true")
    p.add_argument("--grpc-port", type=int, default=-1,
                   help="KServe v2 gRPC frontend port (0 = ephemeral, -1 = off)")
    p.add_argument("--tls-cert-path", default=None,
                   help="serve HTTPS with this PEM cert (requires --tls-key-path)")
    p.add_argument("--tls-key-path", default=None)
    p.add_argument("--request-template", default=None,
                   help="JSON file with default model/temperature/"
                        "max_completion_tokens applied to requests that "
                        "omit them")
    args = p.parse_args(argv)
    if bool(args.tls_cert_path) != bool(args.tls_key_path):
        p.error("--tls-cert-path and --tls-key-path must be given together")
    return args


def router_views(manager: ModelManager) -> dict:
    """Each KV-routed model's view of its workers: {model: {"workers":
    {worker id (hex): block_set_view}, "events_applied", "events_dropped"}}."""
    return {pipe.card.name: pipe.kv_router.view() for pipe in manager.pipelines()
            if pipe.kv_router is not None}


def fault_report() -> dict:
    """This process's fault-injection record: each armed point's call
    count and the fired log, in firing order."""
    return {"calls": {p: FAULTS.calls(p) for p in FAULT_POINTS if FAULTS.calls(p)},
            "fired": [list(f) for f in FAULTS.fired]}


async def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    init_logging()
    # a bad template file fails the start, before anything listens
    template = RequestTemplate.load(args.request_template) if args.request_template else None
    cfg = RuntimeConfig.from_env(store=args.store, store_path=args.store_path,
                                 event_plane=args.event_plane)
    runtime = await DistributedRuntime(cfg).start()
    manager = ModelManager()
    kv_cfg = KvRouterConfig(
        overlap_score_weight=args.kv_overlap_score_weight,
        router_temperature=args.router_temperature,
        use_kv_events=not args.no_kv_events,
    )
    watcher = await ModelWatcher(runtime, manager, RouterMode(args.router_mode),
                                 kv_cfg).start()
    service = HttpService(manager, runtime.metrics, busy_threshold=args.busy_threshold,
                          host=args.host, port=args.port, request_template=template,
                          tls_cert=args.tls_cert_path, tls_key=args.tls_key_path)
    await service.start()
    print(f"{READY} {args.host}:{service.port}", flush=True)
    grpc_service = None
    if args.grpc_port >= 0:
        grpc_service = KserveGrpcService(manager, host=args.host, port=args.grpc_port)
        await grpc_service.start()
        print(f"{GRPC_READY} {grpc_service.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if grpc_service is not None:
        await grpc_service.stop()
    await service.stop()
    print(f"{EXIT} {json.dumps({'router': router_views(manager), 'faults': fault_report()})}",
          flush=True)
    await watcher.stop()
    await runtime.shutdown()


if __name__ == "__main__":
    asyncio.run(main())
