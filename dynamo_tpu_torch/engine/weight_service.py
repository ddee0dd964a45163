"""Weights that outlive a worker: the weight owner and its clients.

The port's copy of the reference package's engine/weight_service.py, the
counterpart of NVIDIA Dynamo's gpu_memory_service with the reference's
host-side design:

- a **weight owner** process parses a checkpoint ONCE and publishes each
  tensor as a file in a tmpfs directory (``DTPU_WEIGHT_SHM``, default
  ``/dev/shm/dtpu_weights``): host shared memory with file names, in the
  port's warm-cache layout (engine/warm.py: one raw-bytes file a tensor and
  a manifest);
- a worker **imports** over a unix socket: the owner answers with the
  manifest's directory, and the worker maps the files and copies the bytes
  to its card (``warm.load_manifest_dir``): no safetensors parse, no dtype
  cast, no disk read. The mapped pages are pageable, so the upload runs at
  pageable-copy speed;
- imports are leased per connection: a worker killed with SIGKILL drops
  its socket, and the owner takes back its references. A weight set with
  live references refuses eviction.

A device-resident owner (weights kept in the card's memory and shared with
CUDA IPC, as NVIDIA's gpu_memory_service) is a feature the reference lacks
and is not here.

Wire protocol: JSON lines over a unix socket; ops import, release, evict,
stat and shutdown. ``python -m dynamo_tpu_torch.engine.weight_service
--sock PATH [--root DIR] [--preload CHECKPOINT ...]`` runs an owner; it
prints ``WEIGHT_OWNER_READY <sock>`` once its preloads are resident.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import shutil
import socket
import time
from typing import Any, Dict, Optional

import torch

from ..runtime.config import ENV_WEIGHT_SERVICE, ENV_WEIGHT_SHM
from ..runtime.logging import get_logger
from .warm import WarmWeightCache, load_manifest_dir

log = get_logger("engine.weight_service")

READY = "WEIGHT_OWNER_READY"


def default_root() -> str:
    return os.environ.get(ENV_WEIGHT_SHM) or "/dev/shm/dtpu_weights"


def _config_classes() -> Dict[str, type]:
    from ..models.gemma import GemmaConfig
    from ..models.gptoss import GptOssConfig
    from ..models.llama import LlamaConfig
    from ..models.mla import MlaConfig
    from ..models.moe import MoeConfig

    return {c.__name__: c for c in (LlamaConfig, GemmaConfig, GptOssConfig, MlaConfig,
                                    MoeConfig)}


def _cfg_to_obj(cfg: Any) -> Optional[Dict[str, Any]]:
    if cfg is None:
        return None
    d = dataclasses.asdict(cfg)
    d["__kind__"] = type(cfg).__name__
    if isinstance(d.get("dtype"), torch.dtype):
        d["dtype"] = str(d["dtype"]).removeprefix("torch.")
    return d


def _cfg_from_obj(obj: Optional[Dict[str, Any]]) -> Any:
    if obj is None:
        return None
    d = dict(obj)
    cls = _config_classes()[d.pop("__kind__", "LlamaConfig")]
    if isinstance(d.get("dtype"), str):
        d["dtype"] = getattr(torch, d["dtype"])
    for f in dataclasses.fields(cls):
        if isinstance(d.get(f.name), list) and str(f.type).startswith("Tuple"):
            d[f.name] = tuple(d[f.name])
    return cls(**d)


@dataclasses.dataclass
class _WeightSet:
    source: str
    dir: str
    refs: int = 0
    bytes: int = 0
    loaded_at: float = 0.0
    load_s: float = 0.0


class WeightOwner:
    """The owner process's server."""

    def __init__(self, sock_path: str, root: Optional[str] = None):
        self.sock_path = sock_path
        self.root = root or default_root()
        self.cache = WarmWeightCache(self.root)
        self._sets: Dict[str, _WeightSet] = {}
        self._loads: Dict[str, asyncio.Lock] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._stop = asyncio.Event()

    async def start(self) -> "WeightOwner":
        os.makedirs(self.root, exist_ok=True)
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        self._server = await asyncio.start_unix_server(self._handle, path=self.sock_path)
        log.info("weight owner on %s (root %s)", self.sock_path, self.root)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if os.path.exists(self.sock_path):
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass

    async def wait_shutdown(self) -> None:
        await self._stop.wait()

    # -- load -----------------------------------------------------------------
    async def _ensure_loaded(self, source: str, cfg_obj) -> _WeightSet:
        ws = self._sets.get(source)
        if ws is not None:
            return ws
        lock = self._loads.setdefault(source, asyncio.Lock())
        async with lock:
            ws = self._sets.get(source)
            if ws is not None:
                return ws
            t0 = time.monotonic()
            cfg = _cfg_from_obj(cfg_obj)

            def load() -> str:
                from .weights import config_from_hf, load_params

                c = cfg if cfg is not None else config_from_hf(source)
                if not self.cache.has(source, c):
                    free = shutil.disk_usage(self.root).free
                    log.info("parsing %s into %s (%.1f GB free there)", source, self.root,
                             free / 1e9)
                    self.cache.save(source, c, load_params(source, c, "cpu"))
                return self.cache._dir(source, c)

            d = await asyncio.get_running_loop().run_in_executor(None, load)
            nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            ws = _WeightSet(source=source, dir=d, bytes=nbytes, loaded_at=time.time(),
                            load_s=time.monotonic() - t0)
            self._sets[source] = ws
            log.info("weights resident: %s -> %s (%.1f MB, %.2fs)", source, d, nbytes / 1e6,
                     ws.load_s)
            return ws

    # -- connection -------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        # source -> [weight set, count]: the set is pinned, so that a forced
        # eviction and a new import between this worker's import and its
        # disconnect cannot move its references onto the NEW set
        conn_refs: Dict[str, list] = {}
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    resp = await self._dispatch(json.loads(line), conn_refs)
                except Exception as e:   # a protocol error is a reply
                    resp = {"ok": False, "error": str(e)}
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            # the lease's end: a worker killed without a release returns
            # every reference it held when its socket closes; only the set
            # the references were taken on is decremented
            for src, (ws, n) in conn_refs.items():
                if self._sets.get(src) is ws:
                    ws.refs = max(0, ws.refs - n)
            writer.close()

    async def _dispatch(self, req: dict, conn_refs: Dict[str, list]) -> dict:
        op = req.get("op")
        if op == "import":
            source = req["source"]
            ws = await self._ensure_loaded(source, req.get("cfg"))
            ws.refs += 1
            ent = conn_refs.get(source)
            if ent is not None and ent[0] is ws:
                ent[1] += 1
            else:
                # a first import, or the set imported before was evicted
                # from under this connection (its references died with it)
                conn_refs[source] = [ws, 1]
            return {"ok": True, "dir": ws.dir, "bytes": ws.bytes, "load_s": ws.load_s,
                    "refs": ws.refs}
        if op == "release":
            source = req["source"]
            ws = self._sets.get(source)
            if ws is None:
                return {"ok": False, "error": "unknown weight set"}
            ent = conn_refs.get(source)
            if ent is None or ent[0] is not ws or ent[1] <= 0:
                return {"ok": False, "error": "no reference held"}
            ent[1] -= 1
            ws.refs = max(0, ws.refs - 1)
            return {"ok": True, "refs": ws.refs}
        if op == "evict":
            source = req["source"]
            ws = self._sets.get(source)
            if ws is None:
                return {"ok": False, "error": "unknown weight set"}
            if ws.refs > 0 and not req.get("force"):
                return {"ok": False, "error": f"{ws.refs} live references"}
            del self._sets[source]
            shutil.rmtree(ws.dir, ignore_errors=True)
            return {"ok": True}
        if op == "stat":
            return {"ok": True, "sets": [
                {"source": w.source, "dir": w.dir, "refs": w.refs, "bytes": w.bytes,
                 "load_s": w.load_s} for w in self._sets.values()]}
        if op == "shutdown":
            self._stop.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


class WeightServiceClient:
    """A worker's side, synchronous (the engine's build is). The connection
    is the lease: keep the client open for the worker's life."""

    def __init__(self, sock_path: str, timeout: float = 600.0):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        self._sock.connect(sock_path)
        self._buf = b""

    def _call(self, req: dict) -> dict:
        self._sock.sendall(json.dumps(req).encode() + b"\n")
        while b"\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("weight owner closed the connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        resp = json.loads(line)
        if not resp.get("ok"):
            raise RuntimeError(f"weight service: {resp.get('error')}")
        return resp

    def import_params(self, source: str, cfg: Any = None, device=None):
        """(the parameters, copied to ``device`` from the owner's mapped
        files, and the owner's reply)."""
        resp = self._call({"op": "import", "source": source, "cfg": _cfg_to_obj(cfg)})
        return load_manifest_dir(resp["dir"], device), resp

    def release(self, source: str) -> None:
        self._call({"op": "release", "source": source})

    def stat(self) -> list:
        return self._call({"op": "stat"})["sets"]

    def evict(self, source: str, force: bool = False) -> None:
        self._call({"op": "evict", "source": source, "force": force})

    def shutdown_owner(self) -> None:
        self._call({"op": "shutdown"})

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def load_params_served(source: str, cfg: Any = None, sock_path: Optional[str] = None,
                       warm_fallback: bool = True, device=None):
    """The engine's loader: an import from the weight owner when one is
    configured (``sock_path``, else ``DTPU_WEIGHT_SERVICE``) and answers,
    else the local warm cache (or, without ``warm_fallback``, a plain
    checkpoint parse). Returns (parameters on ``device``, the client or
    None): the caller keeps the client open (it is the lease) and closes it
    at a clean shutdown."""
    sock_path = sock_path or os.environ.get(ENV_WEIGHT_SERVICE)
    if sock_path:
        try:
            client = WeightServiceClient(sock_path)
            params, info = client.import_params(source, cfg, device)
            log.info("weights imported from the owner (%.1f MB shared, owner load %.2fs)",
                     info["bytes"] / 1e6, info["load_s"])
            return params, client
        except (OSError, ConnectionError, RuntimeError) as e:
            log.warning("weight service unavailable (%s); loading locally", e)
    if warm_fallback:
        from .warm import load_params_warm

        return load_params_warm(source, cfg, device=device), None
    from .weights import load_params

    return load_params(source, cfg, device), None


def main(argv=None) -> None:
    """``python -m dynamo_tpu_torch.engine.weight_service``: a weight owner.
    It needs no card: the parse and the shared files are host work."""
    import argparse

    p = argparse.ArgumentParser(description="dynamo_tpu_torch weight owner")
    p.add_argument("--sock", required=True, help="unix socket path")
    p.add_argument("--root", default=None,
                   help=f"the shared directory (default: ${ENV_WEIGHT_SHM} or "
                        "/dev/shm/dtpu_weights)")
    p.add_argument("--preload", action="append", default=[],
                   help="checkpoint directories to load at start")
    args = p.parse_args(argv)

    async def run():
        owner = await WeightOwner(args.sock, args.root).start()
        usage = shutil.disk_usage(owner.root)
        print(f"WEIGHT_OWNER_SHM {owner.root} free_bytes={usage.free} "
              f"total_bytes={usage.total}", flush=True)
        for src in args.preload:
            ws = await owner._ensure_loaded(src, None)
            print(f"WEIGHT_OWNER_LOADED {src} bytes={ws.bytes} load_s={ws.load_s:.3f}",
                  flush=True)
        print(f"{READY} {args.sock}", flush=True)
        try:
            await owner.wait_shutdown()
        finally:
            await owner.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
