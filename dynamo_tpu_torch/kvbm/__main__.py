"""python -m dynamo_tpu_torch.kvbm — the standalone G4 remote block-store service.

The port's counterpart of ``python -m dynamo_tpu.kvbm``: the fleet-shared
KV tier. Workers point at it with ``--kvbm-remote HOST:PORT``, and a prefix
prefilled on any of them can be onboarded on every other. With ``--store``
it registers under its runtime's lease in the discovery store, as a member
of the sharded fleet (kvbm/distributed.py), and prints ``KVBM_FLEET_MEMBER
<address>``; it prints ``KVBM_REMOTE_READY <address>`` once it listens.
"""

import argparse
import asyncio
import signal

from dynamo_tpu_torch.kvbm.remote import RemoteBlockStoreServer
from dynamo_tpu_torch.runtime import init_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser("dynamo_tpu_torch.kvbm")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7440)
    p.add_argument("--capacity-gb", type=float, default=2.0)
    p.add_argument("--disk", default=None,
                   help="persist block payloads under this directory "
                        "(RAM index over disk payloads)")
    p.add_argument("--store", default=None,
                   help="register in this discovery store to join the sharded "
                        "fleet (kvbm/distributed.py): clients consistent-hash "
                        "blocks across its members")
    p.add_argument("--store-path", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--advertise", default=None,
                   help="address to register (default: host:port with the bound port)")
    return p.parse_args(argv)


async def main(argv=None) -> None:
    args = parse_args(argv)
    init_logging()
    server = RemoteBlockStoreServer(host=args.host, port=args.port,
                                    capacity_bytes=int(args.capacity_gb * (1 << 30)),
                                    disk_path=args.disk)
    addr = await server.start()
    runtime = None
    if args.store:
        from dynamo_tpu_torch.kvbm.distributed import register_store
        from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

        runtime = await DistributedRuntime(
            RuntimeConfig.from_env(store=args.store, store_path=args.store_path)).start()
        advertise = args.advertise or addr
        await register_store(runtime.store, args.namespace, advertise, runtime.lease_id)
        print(f"KVBM_FLEET_MEMBER {advertise}", flush=True)
    print(f"KVBM_REMOTE_READY {addr}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()
    if runtime is not None:
        await runtime.shutdown()


if __name__ == "__main__":
    asyncio.run(main())
