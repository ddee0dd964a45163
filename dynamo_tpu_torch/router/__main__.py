"""python -m dynamo_tpu_torch.router — the standalone KV-router service.

The port's counterpart of the reference's ``python -m dynamo_tpu.router``
(Dynamo's ``python -m dynamo.router``): KV-aware worker selection for a
component's worker set, served as its own endpoint
(``{component}-router/route``, router/service.py), so that prefill
orchestrators and several frontends share one routing brain:

    python -m dynamo_tpu_torch.router --store tcp --store-path 127.0.0.1:7460 \\
        --event-plane zmq --record-events /tmp/kv_events.jsonl

It follows the workers' KV events and load on the event plane, as a
frontend in ``--router-mode kv`` does (``--no-kv-events``: the approximate
indexer instead); several services with ``--replica-sync`` keep one load
and prefix view. ``--record-events PATH`` writes every KV event it ingests
to a JSONL recording (runtime/recorder.py) that ``Recorder.load`` /
``replay`` read back.

Prints ``ROUTER_READY <router_id>`` once it serves. On SIGTERM or SIGINT it
stops and prints ``ROUTER_EXIT {json}``: its view of each worker
(``block_set_view``, as ``TORCH_FRONTEND_EXIT`` prints a KV frontend's),
the events it applied and the events it recorded.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
from typing import List, Optional

from ..kv_router import KvRouterConfig
from ..runtime.config import RuntimeConfig
from ..runtime.distributed import DistributedRuntime
from ..runtime.logging import init_logging
from ..runtime.recorder import Recorder
from .service import RouterService

READY = "ROUTER_READY"
EXIT = "ROUTER_EXIT"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo_tpu_torch.router")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--store", default=None, help="mem|file|tcp|etcd (default: DTPU_STORE)")
    p.add_argument("--store-path", default=None)
    p.add_argument("--event-plane", default=None, help="zmq|inproc (default: DTPU_EVENT_PLANE)")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--no-kv-events", action="store_true",
                   help="use the ApproxKvIndexer instead of worker KV events")
    p.add_argument("--replica-sync", action="store_true",
                   help="sync decisions + state with other router instances")
    p.add_argument("--record-events", default=None, metavar="PATH",
                   help="record the ingested KV-event stream to a JSONL file "
                        "(runtime/recorder.py; replayable with Recorder.replay)")
    return p.parse_args(argv)


async def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    init_logging()
    cfg = RuntimeConfig.from_env(store=args.store, store_path=args.store_path,
                                 event_plane=args.event_plane)
    runtime = await DistributedRuntime(cfg).start()
    recorder = await Recorder(args.record_events).start() if args.record_events else None
    service = await RouterService(
        runtime,
        namespace=args.namespace,
        component=args.component,
        endpoint=args.endpoint,
        block_size=args.block_size,
        config=KvRouterConfig(
            overlap_score_weight=args.overlap_score_weight,
            router_temperature=args.router_temperature,
            use_kv_events=not args.no_kv_events,
            replica_sync=args.replica_sync,
        ),
        recorder=recorder,
    ).start()
    print(f"{READY} {service.router.router_id}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    report = service.router.view()
    await service.stop()
    if recorder is not None:
        await recorder.stop()
        report["recorded"] = recorder.event_count
    await runtime.shutdown()
    print(f"{EXIT} {json.dumps(report)}", flush=True)


if __name__ == "__main__":
    asyncio.run(main())
