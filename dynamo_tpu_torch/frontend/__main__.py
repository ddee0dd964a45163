"""python -m dynamo_tpu_torch.frontend — the OpenAI HTTP frontend.

The port's counterpart of the reference's ``python -m dynamo_tpu.frontend``:
one process running the OpenAI HTTP server, the model-card watcher, the
preprocessor and the round-robin (or random) router over the workers
(``python -m dynamo_tpu_torch.engine``) it discovers on the store:

    python -m dynamo_tpu_torch.frontend --store tcp --store-path 127.0.0.1:7460 --port 8000

Prints ``TORCH_FRONTEND_READY <host>:<port>`` once it listens (``--port 0``
takes a free port and prints it). The KV router, gRPC and TLS are later
slices (ROADMAP item 4b).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
from typing import List, Optional

from ..llm.discovery import ModelManager, ModelWatcher
from ..llm.http.service import HttpService
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
from ..runtime.logging import init_logging

READY = "TORCH_FRONTEND_READY"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("dynamo_tpu_torch.frontend")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=env_int(ENV_HTTP_PORT, 8000))
    p.add_argument("--router-mode", choices=["round-robin", "random"], default="round-robin")
    p.add_argument("--namespace", default=env_str(ENV_NAMESPACE, "dynamo"))
    p.add_argument("--store", default=None, help="mem|file|tcp (default: DTPU_STORE)")
    p.add_argument("--store-path", default=None)
    p.add_argument("--busy-threshold", type=int,
                   default=(env_int(ENV_BUSY_THRESHOLD, 0) or None),
                   help="answer 503 once this many requests are in flight")
    return p.parse_args(argv)


async def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    init_logging()
    cfg = RuntimeConfig.from_env(store=args.store, store_path=args.store_path)
    runtime = await DistributedRuntime(cfg).start()
    manager = ModelManager()
    watcher = await ModelWatcher(runtime, manager, RouterMode(args.router_mode)).start()
    service = HttpService(manager, runtime.metrics, busy_threshold=args.busy_threshold,
                          host=args.host, port=args.port)
    await service.start()
    print(f"{READY} {args.host}:{service.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await service.stop()
    await watcher.stop()
    await runtime.shutdown()


if __name__ == "__main__":
    asyncio.run(main())
