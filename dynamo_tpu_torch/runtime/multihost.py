"""Multi-process execution of one tensor-parallel group.

The port's copy of the reference's runtime/multihost.py. A PyTorch TP
group is one process per rank, and each rank must issue the same device
work in the same order, since every layer ends in a collective: so, as in
the reference's multi-controller JAX,

  - process 0 (the leader) owns the control plane: discovery
    registration, the request-plane endpoint, the scheduler, the status
    port and every host-side decision;
  - processes 1..N-1 (the followers) join the same ``torch.distributed``
    group (``torch.distributed.init_process_group`` in the place of
    ``jax.distributed.initialize``), hold their own shards of the
    parameters, KV caches and sampling tables, and replay each dispatch
    the leader broadcasts, so that the collectives line up across
    processes.

The broadcast channel is a plain TCP fan-out of length-prefixed MessagePack
frames (runtime/codec.py, byte-equal to the reference's ``msgpack`` frames
for the same arguments), not the request plane: dispatch replay is a
lockstep data-path concern, ordered and point to point, with no discovery
or retry.

Wire format: one frame per dispatch ``{"op": name, "a": [encoded args]}``.
numpy arrays ride as ``{"__nd__": [dtype name, shape, bytes]}``, numpy
scalars as ``{"__nd0__": [dtype name, bytes]}``; the sentinel
``{"__carry__": key}`` tells the follower to substitute its own
device-resident carry (a chained decode horizon never round-trips its
carry through the host).

``MultihostSpec.parse`` reads ``--multihost coord:port,nprocs,proc_id[,
control:port]``; ``local_group_specs`` and ``spawn_followers`` start a
group on one host (the worker's ``--tp N``: the leader starts N-1
follower processes of its own module, on free ports).
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .codec import packb, unpackb
from .logging import get_logger

log = get_logger("runtime.multihost")

_LEN = struct.Struct("!I")
_TRACE = os.environ.get("DTPU_MH_TRACE") == "1"


def _trace(fmt: str, *args) -> None:
    if _TRACE:
        print("[mh] " + (fmt % args), file=sys.stderr, flush=True)


@dataclass
class MultihostSpec:
    """Parsed ``--multihost coord:port,nprocs,proc_id[,control:port]``."""

    coordinator: str
    num_processes: int
    process_id: int
    control: str  # host:port the leader's control channel binds/dials

    @classmethod
    def parse(cls, text: str) -> "MultihostSpec":
        parts = text.split(",")
        if len(parts) < 3:
            raise ValueError(
                "--multihost wants coord_host:port,num_processes,process_id"
                "[,control_host:port]"
            )
        coord, nprocs, pid = parts[0], int(parts[1]), int(parts[2])
        if len(parts) > 3:
            control = parts[3]
        else:
            # default control port: coordinator port + 1 on the same host
            host, _, port = coord.rpartition(":")
            control = f"{host}:{int(port) + 1}"
        return cls(coord, nprocs, pid, control)

    def text(self) -> str:
        return f"{self.coordinator},{self.num_processes},{self.process_id},{self.control}"


def _encode_arg(a: Any) -> Any:
    # dtype.name (not .str): extension dtypes have no char code, but their
    # registered name round-trips through np.dtype()
    if isinstance(a, np.ndarray):
        return {"__nd__": [a.dtype.name, list(a.shape), a.tobytes()]}
    if isinstance(a, (np.generic,)):  # 0-d scalar (np.int32(3), np.bool_(True))
        arr = np.asarray(a)
        return {"__nd0__": [arr.dtype.name, arr.tobytes()]}
    return a


def _decode_arg(a: Any) -> Any:
    # arrays come back writable (torch takes no read-only array)
    if isinstance(a, dict):
        if "__nd__" in a:
            dt, shape, raw = a["__nd__"]
            return np.frombuffer(bytearray(raw), dtype=np.dtype(dt)).reshape(shape)
        if "__nd0__" in a:
            dt, raw = a["__nd0__"]
            return np.frombuffer(raw, dtype=np.dtype(dt))[0]
    return a


def encode_frame(op: str, args: Sequence[Any]) -> bytes:
    """One dispatch frame: the length prefix, then ``{"op", "a"}``."""
    payload = packb({"op": op, "a": [_encode_arg(a) for a in args]})
    return _LEN.pack(len(payload)) + payload


def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def local_group_specs(tp: int, host: str = "127.0.0.1") -> List[MultihostSpec]:
    """The specs of a ``tp``-process group on this host, one per rank, on
    free ports (the coordinator's and the control channel's)."""
    coord, control = f"{host}:{free_port(host)}", f"{host}:{free_port(host)}"
    return [MultihostSpec(coord, tp, r, control) for r in range(tp)]


def spawn_followers(module: str, argv: Sequence[str], specs: Sequence[MultihostSpec],
                    stdout=None) -> List[subprocess.Popen]:
    """Start ranks 1.. of a local group: ``python -m module *argv
    --multihost <spec>`` each, writing to ``stdout`` (a file; None: this
    process's stdout), their stderr this process's."""
    return [subprocess.Popen([sys.executable, "-m", module, *argv, "--multihost", s.text()],
                             stdout=stdout) for s in specs[1:]]


def join_group(tp: int, multihost: Optional[str], module: str, argv: Sequence[str],
               device=None, stdout=None):
    """Join a ``tp``-process group as the rank ``multihost`` names, or,
    without it, as the leader of a group on this host, starting its
    followers (``spawn_followers(module, argv, ..., stdout)``). Returns (the
    context, its group joined and its control channel up; this rank's
    device, parallel/mesh.rank_device; the followers started)."""
    from ..parallel.mesh import rank_device

    followers: List[subprocess.Popen] = []
    if multihost:
        spec = MultihostSpec.parse(multihost)
    else:
        specs = local_group_specs(tp)
        spec = specs[0]
        followers = spawn_followers(module, argv, specs, stdout)
    if spec.num_processes != tp:
        raise ValueError(f"--multihost names {spec.num_processes} processes, tp is {tp}")
    dev = rank_device(spec.process_id, device)
    mh = MultihostContext(spec)
    try:
        mh.initialize(dev)
        mh.start_control()
    except BaseException:
        for p in followers:
            p.kill()
        raise
    return mh, dev, followers


def reap(followers: Sequence[subprocess.Popen], timeout_s: float = 30.0) -> List[int]:
    """Wait for started followers to exit (each has been told to stop, or
    lost its leader), killing any still running after ``timeout_s``;
    returns their exit codes."""
    deadline = time.monotonic() + timeout_s
    codes = []
    for p in followers:
        try:
            codes.append(p.wait(max(deadline - time.monotonic(), 0.1)))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


class MultihostContext:
    """Owns the ``torch.distributed`` membership, the rank's collectives
    (``comm``, parallel/comm.py) and the dispatch broadcast channel."""

    def __init__(self, spec: MultihostSpec):
        self.spec = spec
        self.comm = None
        self._socks: List[socket.socket] = []  # leader: one per follower
        self._sock: Optional[socket.socket] = None  # follower: to leader
        self._rbuf = b""
        self._lock = threading.Lock()
        self._closed = False
        self._router: Optional["MultihostRouter"] = None

    @property
    def router(self) -> "MultihostRouter":
        """The process-wide dispatch router (one per group membership)."""
        if self._router is None:
            self._router = MultihostRouter(self)
        return self._router

    # ------------------------------------------------------------ membership
    @property
    def is_leader(self) -> bool:
        return self.spec.process_id == 0

    @property
    def num_processes(self) -> int:
        return self.spec.num_processes

    def initialize(self, device: torch.device):
        """Join the ``torch.distributed`` group (must run before any
        collective); returns and keeps the rank's ``TpComm``."""
        from ..parallel.comm import init_group

        self.comm = init_group(self.spec.process_id, self.spec.num_processes,
                               f"tcp://{self.spec.coordinator}", device)
        return self.comm

    # --------------------------------------------------------- control plane
    def start_control(self, timeout_s: float = 60.0) -> None:
        """Leader: accept one connection per follower. Follower: dial."""
        host, _, port = self.spec.control.rpartition(":")
        port = int(port)
        if self.is_leader:
            srv = socket.create_server((host, port), reuse_port=False)
            deadline = time.monotonic() + timeout_s
            try:
                pending = self.spec.num_processes - 1
                seen: Dict[int, socket.socket] = {}
                while len(seen) < pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"only {len(seen)}/{pending} followers dialed in"
                        )
                    srv.settimeout(remaining)
                    conn, _addr = srv.accept()
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    # bound the hello read too: a stray connection must not
                    # wedge startup; drop it and keep accepting
                    conn.settimeout(5.0)
                    try:
                        hello = b""
                        while len(hello) < 4:
                            part = conn.recv(4 - len(hello))
                            if not part:
                                raise ConnectionError("hello truncated")
                            hello += part
                        (pid,) = _LEN.unpack(hello)
                    except (OSError, ConnectionError) as e:
                        log.warning("control dial-in rejected: %s", e)
                        conn.close()
                        continue
                    conn.settimeout(None)  # dispatch gaps are unbounded
                    seen[pid] = conn
                # deterministic fan-out order
                self._socks = [seen[k] for k in sorted(seen)]
            finally:
                srv.close()
        else:
            deadline = time.monotonic() + timeout_s
            last: Optional[Exception] = None
            while time.monotonic() < deadline:
                try:
                    s = socket.create_connection((host, port), timeout=5.0)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    # recv() blocks across arbitrarily long idle gaps
                    s.settimeout(None)
                    s.sendall(_LEN.pack(self.spec.process_id))
                    self._sock = s
                    return
                except OSError as e:  # leader not up yet
                    last = e
                    time.sleep(0.2)
            raise TimeoutError(f"control channel dial failed: {last}")

    def broadcast(self, op: str, args: List[Any]) -> None:
        """Leader: fan one dispatch out to every follower, in order.

        Fails fast on the first dead socket: the leader will not run the op
        either, so delivering the frame to later survivors would only push
        them into a collective the leader (and the dead peer) never join.
        Survivors that already received it may wedge mid-collective; the
        follower-death teardown (``watch_followers``: the engine stops and
        the worker leaves discovery) handles the rest."""
        frame = encode_frame(op, args)
        with self._lock:
            for s in self._socks:
                try:
                    s.sendall(frame)
                except OSError as e:
                    raise ConnectionError(
                        f"follower unreachable during broadcast of {op!r}: {e}"
                    ) from e

    def watch_followers(self, on_death: Callable[[], None]) -> None:
        """Leader: detect follower death between dispatches.

        Followers never send after their hello, so a readable control socket
        means EOF (the process died, or its connection reset). One
        background thread select()s on every follower socket; the first
        death fires ``on_death`` once and the thread exits: the group is
        unrecoverable (the dead process held shards; any later collective
        would fail or hang), so the caller stops the engine and leaves
        discovery, for a supervisor to restart the group."""
        import select

        def run() -> None:
            socks = list(self._socks)
            while not self._closed and socks:
                try:
                    r, _, x = select.select(socks, [], socks, 1.0)
                except (OSError, ValueError):
                    return  # sockets closed under us: normal group stop
                dead = False
                for s in set(r) | set(x):
                    try:
                        if not s.recv(1):
                            dead = True
                    except OSError:
                        dead = True
                if dead:
                    if not self._closed:
                        log.error("multihost follower died; tearing down group")
                        on_death()
                    return

        threading.Thread(target=run, daemon=True, name="mh-follower-watch").start()

    def recv(self) -> Dict[str, Any]:
        """Follower: block for the next dispatch frame."""
        if self._sock is None:
            raise RuntimeError("recv() before start_control()")
        while True:
            if len(self._rbuf) >= 4:
                (n,) = _LEN.unpack(self._rbuf[:4])
                if len(self._rbuf) >= 4 + n:
                    raw = self._rbuf[4: 4 + n]
                    self._rbuf = self._rbuf[4 + n:]
                    msg = unpackb(raw)
                    msg["a"] = [_decode_arg(a) for a in msg.get("a", [])]
                    return msg
            chunk = self._sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("control channel closed by leader")
            self._rbuf += chunk

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.is_leader:
            try:
                self.broadcast("__stop__", [])
            except OSError:
                pass
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def shutdown(self) -> None:
        """Leave the ``torch.distributed`` group."""
        from ..parallel.comm import destroy_group

        destroy_group()


CARRY = "__carry__"


class MultihostRouter:
    """Process-level dispatch fabric: ONE broadcast channel, one total order,
    any number of engine replay tables multiplexed by a namespace prefix on
    the op name (``dp1:decode``).

    Dispatches come from more than one thread (the engine's step executor
    and the asyncio loop thread); broadcast and local execution happen
    under ONE process-wide lock, so every process executes the same total
    order."""

    def __init__(self, mh: MultihostContext):
        self.mh = mh
        self._tables: Dict[str, "MultihostOps"] = {}
        self._closed = False
        self.dispatch_lock = threading.Lock()

    def table(
        self,
        state_get: Dict[str, Callable[[], Any]],
        state_set: Dict[str, Callable[[Any], None]],
        ns: str = "",
    ) -> "MultihostOps":
        if ns in self._tables:
            raise ValueError(f"multihost namespace {ns!r} already registered")
        ops = MultihostOps(self, ns, state_get, state_set)
        self._tables[ns] = ops
        return ops

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the group, serialized against in-flight dispatches.

        Taking the dispatch lock means any dispatch racing this close either
        fully broadcast and executed BEFORE the __stop__ frame (the follower
        replays it, then exits) or is rejected after: a late collective run
        by the leader alone would block waiting for its peers. Idempotent.

        The lock acquire is bounded: on a follower-death teardown a dispatch
        may be wedged mid-broadcast holding the lock; after ``timeout_s``
        the sockets close anyway, which fails that dispatch."""
        got = self.dispatch_lock.acquire(timeout=timeout_s)
        try:
            if self._closed:
                return
            self._closed = True
            self.mh.close()
        finally:
            if got:
                self.dispatch_lock.release()

    @property
    def closed(self) -> bool:
        return self._closed

    def follow(self) -> None:
        """Follower body: replay dispatches (all namespaces) until stop."""
        while True:
            msg = self.mh.recv()
            op = msg["op"]
            _trace("follower: recv %s", op)
            if op == "__stop__":
                return
            ns, _, name = op.rpartition(":")
            self._tables[ns].replay(name, msg)


class MultihostOps:
    """Per-engine dispatch replay table (one namespace of the router).

    Each op is registered with:
      - ``state_in``:  {arg_pos: state_name}: args the follower substitutes
        with its OWN state (its shards, caches, ...);
      - ``state_out``: {out_pos: state_name}: outputs both sides store back
        (``carry_*`` names go to the follower's carry table);
      - ``carry_in``:  {arg_pos: state_name}: args that are EITHER a host
        value (numpy, broadcast by value) or the device carry of the
        previous dispatch (a tensor, broadcast as a carry sentinel).

    The leader-side wrapper converts every other argument to host numpy before both the
    broadcast and the local call, so that both sides compute from the same
    values. A Python scalar or None stays as it is."""

    def __init__(self, router: MultihostRouter, ns: str,
                 state_get: Dict[str, Callable[[], Any]],
                 state_set: Dict[str, Callable[[Any], None]]):
        self.router = router
        self.ns = ns
        self.mh = router.mh
        self._get = state_get
        self._set = state_set
        self._ops: Dict[str, tuple] = {}
        self._carry: Dict[str, Any] = {}

    def close(self) -> None:
        self.router.close()

    def register(self, name: str, fn: Callable, state_in: Optional[Dict[int, str]] = None,
                 state_out: Optional[Dict[int, str]] = None,
                 carry_in: Optional[Dict[int, str]] = None):
        self._ops[name] = (fn, state_in or {}, state_out or {}, carry_in or {})

    # ------------------------------------------------------------- leader side
    def leader_fn(self, name: str) -> Callable:
        fn, state_in, state_out, carry_in = self._ops[name]
        mh = self.mh
        wire_name = f"{self.ns}:{name}"

        def dispatch(*args):
            send: List[Any] = []
            call: List[Any] = list(args)
            for i, a in enumerate(args):
                if i in state_in:
                    continue  # the follower substitutes its own
                if i in carry_in and isinstance(a, torch.Tensor):
                    send.append({CARRY: carry_in[i]})
                    continue
                host = (
                    a if isinstance(a, (int, float, bool, type(None)))
                    else np.asarray(a)
                )
                send.append(host)
                call[i] = host
            with self.router.dispatch_lock:
                if self.router.closed:
                    raise RuntimeError(
                        f"multihost group stopped; dropping dispatch {name!r}"
                    )
                _trace("leader: broadcast %s", wire_name)
                mh.broadcast(wire_name, send)
                out = fn(*call)
                _trace("leader: dispatched %s", wire_name)
                return out

        return dispatch

    # ----------------------------------------------------------- follower side
    def replay(self, op: str, msg: Dict[str, Any]) -> None:
        fn, state_in, state_out, carry_in = self._ops[op]
        data = msg["a"]
        n_args = len(data) + len(state_in)
        args: List[Any] = [None] * n_args
        it = iter(data)
        for i in range(n_args):
            if i in state_in:
                args[i] = self._get[state_in[i]]()
            else:
                a = next(it)
                if isinstance(a, dict) and CARRY in a:
                    args[i] = self._carry[a[CARRY]]
                else:
                    args[i] = a
        out = fn(*args)
        _trace("follower: executed %s:%s", self.ns, op)
        outs = out if isinstance(out, tuple) else (out,)
        for pos, sname in state_out.items():
            if sname.startswith("carry_"):
                self._carry[sname] = outs[pos]
            else:
                self._set[sname](outs[pos])

    def follow(self) -> None:
        """Single-table convenience: replay until stop (delegates to the
        router; valid when this is the only namespace)."""
        self.router.follow()
