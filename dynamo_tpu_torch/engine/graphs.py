"""The decode horizon's device state and its CUDA graphs.

Counterpart of the reference's jit-compiled ``decode_multi`` program
(dynamo_tpu/engine/engine.py:1469): where the reference compiles the
horizon once and calls it, the port captures the horizon body
(``TorchEngine._decode_multi``, N decode steps on device tensors only) as
one CUDA graph per key and replays it.

- ``HorizonState`` holds the static buffers every horizon reads and
  writes: the carry (tokens, seq_lens, steps), which each horizon updates
  in place so that a chained horizon needs no copy; the per-dispatch
  inputs (block tables, active mask, seeds, sampling and penalty
  parameters), laid out in one device buffer that ONE host-to-device copy
  from pinned memory fills; the unified kernel's constant row arrays and
  windows (Gemma); and the packed results ``[N, B, 2 + 2K]``. A
  speculative engine's state also holds the spec horizon's packed results
  ``[R, B, 1 + 2k]`` (``TorchEngine._spec_multi``: R rounds of k draft
  tokens each). An engine with per-request features (logits processors,
  guided decoding, LoRA) adds their per-dispatch fields: each guided row's
  FSM state in the carry (chained horizons continue each row's grammar),
  and the guided rows, each slot's adapter id and the processor opt-ins in
  the inputs. The grammar and adapter tables themselves are the engine's,
  written in place.
- ``HorizonGraphs`` captures the body once per key (a ``max_seq_len``
  bucket: ``DEC_SPLIT_KEYS`` times a power of two, up to ``max_context``;
  and whether any row samples, since the Gumbel draw over ``[B, V]`` is
  the body's one costly optional part; and, on an engine with features,
  whether any row of the dispatch uses one, so that a batch without such
  rows replays the plain body), all keys at engine start, before any
  traffic, into one shared memory pool. A capture that fails raises.
  On a speculative engine the spec body is captured too, once per
  ``max_seq_len`` bucket (spec rows are greedy: no sampled key), into the
  same pool; its replays are counted apart (``spec_replays``).
  Each run copies ``packed`` to a slot of a pinned host ring (one slot per
  horizon in flight) on the same stream and records an event per slot,
  which the engine's fetch thread waits on.

On the CPU, and on the card when the engine runs the eager horizon, the
same body runs eagerly on the same buffers. A rank of a tensor-parallel
group captures its horizon only over NCCL, whose collectives a graph
can hold (``capture_allowed``); ranks that share a card run it eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _build

_ALIGN = 16   # the kernels take 16-byte-aligned tensors


class _Staged:
    """Named device tensors laid out in one byte buffer, each with a numpy
    view per ring slot of a host copy (pinned on CUDA), so that filling
    them is ONE host-to-device copy."""

    def __init__(self, fields: Sequence[Tuple[str, torch.dtype, tuple]], device: torch.device,
                 slots: int):
        layout, total = [], 0
        for name, dtype, shape in fields:
            n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            layout.append((name, dtype, shape, total, n))
            total += -(-n // _ALIGN) * _ALIGN
        self.dev = torch.zeros(total, dtype=torch.uint8, device=device)
        pin = device.type == "cuda"
        self.host = [torch.zeros(total, dtype=torch.uint8, pin_memory=pin) for _ in range(slots)]
        self.views: Dict[str, torch.Tensor] = {}
        self.host_views: List[Dict[str, np.ndarray]] = [{} for _ in range(slots)]
        for name, dtype, shape, off, n in layout:
            self.views[name] = self.dev[off:off + n].view(dtype).view(shape)
            for h, hv in zip(self.host, self.host_views):
                hv[name] = h[off:off + n].view(dtype).view(shape).numpy()

    def upload(self, slot: int) -> None:
        self.dev.copy_(self.host[slot], non_blocking=True)


class HorizonState:
    """The static buffers of the decode horizon (see the module docstring).
    ``windows``: the sliding windows the model's layers ask for, each
    kept as a constant [B] array for the unified kernel."""

    def __init__(self, batch: int, max_blocks: int, steps: int, vocab: int, top_k: int,
                 device: torch.device, windows: Sequence[int] = (), slots: int = 1,
                 spec: Optional[Tuple[int, int]] = None, guided: bool = False,
                 lora: bool = False, processors: int = 0):
        B = batch
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        # the per-request features this state carries fields for
        self.guided, self.lora, self.processors = guided, lora, processors
        self.features = guided or lora or processors > 0
        self.carry = _Staged([("tokens", i64, (B,)), ("seq_lens", i32, (B,)),
                              ("steps", i64, (B,))]
                             + ([("g_state", i32, (B,))] if guided else []), device, slots)
        self.inputs = _Staged([
            ("tables", i32, (B, max_blocks)), ("active", torch.bool, (B,)),
            ("count_rows", torch.bool, (B,)), ("sample_rows", torch.bool, (B,)),
            ("seeds", i64, (B,)), ("temps", f32, (B,)), ("top_ks", i64, (B,)),
            ("top_ps", f32, (B,)), ("min_ps", f32, (B,)), ("pres", f32, (B,)),
            ("freqs", f32, (B,)), ("reps", f32, (B,)),
        ] + ([("g_active", torch.bool, (B,))] if guided else [])
          + ([("lora_ids", i64, (B,))] if lora else [])
          + ([("proc_masks", torch.bool, (B, processors))] if processors else []),
            device, slots)
        for name, t in {**self.carry.views, **self.inputs.views}.items():
            setattr(self, name, t)
        # the unified kernel's q_len = 1 rows: row b's token is q[b]
        self.q_starts = torch.arange(B, dtype=i32, device=device)
        self.windows = {w: torch.full((B,), w, dtype=i32, device=device) for w in windows}
        # per step and row: token, its logprob, TOP_LOGPROBS_K ids, their logprobs
        self.packed = torch.zeros((steps, B, 2 + 2 * top_k), dtype=f32, device=device)
        # spec (rounds R, draft tokens k): per round and row the advance,
        # the k verified tokens and their logprobs; the candidates' offsets
        self.spec_packed = self.spec_offsets = None
        if spec is not None:
            R, k = spec
            self.spec_packed = torch.zeros((R, B, 1 + 2 * k), dtype=f32, device=device)
            self.spec_offsets = torch.arange(k + 1, dtype=torch.int64, device=device)

    def attrs(self, window: Optional[int] = None, **extra) -> dict:
        """A layer's attention attributes as the unified kernel takes them:
        its sliding window (None: full) as this state's [B] windows array."""
        if window:
            extra["windows"] = self.windows[window]
        return extra


def capture_allowed(device: torch.device, cuda_graphs: bool, comm=None) -> bool:
    """Whether the horizon is captured: on CUDA with ``cuda_graphs`` on,
    and for a rank of a TP group (``comm``, parallel/comm.TpComm) only
    over NCCL: gloo copies each collective through the host, which no
    graph can hold."""
    if device.type != "cuda" or not cuda_graphs:
        return False
    return comm is None or comm.backend == "nccl"


def seq_len_buckets(max_context: int, unit: int) -> List[int]:
    """``unit`` times the powers of two below ``max_context``, then
    ``max_context``: the ``max_seq_len`` bounds the graphs are captured at."""
    out, b = [], unit
    while b < max_context:
        out.append(b)
        b *= 2
    return out + [max_context]


class HorizonGraphs:
    """Runs the horizon body (``body(state, max_seq_len, sampled, feat)``)
    or the spec body (``spec_body(state, max_seq_len)``) on ``state``: one
    CUDA-graph replay per run when ``capture`` (call ``capture_all`` before
    traffic), else eagerly."""

    def __init__(self, body: Callable[[HorizonState, int, bool, bool], None],
                 state: HorizonState,
                 buckets: Sequence[int], device: torch.device, capture: bool,
                 reserve: Optional[Callable[[], None]] = None,
                 spec_body: Optional[Callable[[HorizonState, int], None]] = None):
        self.body = body
        self.spec_body = spec_body
        self.state = state
        self.buckets = list(buckets)
        self.device = device
        self.capture = capture
        self._reserve = reserve
        self.graphs: Dict[Tuple[int, bool, bool], Tuple[torch.cuda.CUDAGraph, dict]] = {}
        self.spec_graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, dict]] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        self.spec_replays = 0
        slots = len(state.carry.host)
        pin = device.type == "cuda"
        self._host = [torch.empty(state.packed.shape, dtype=torch.float32, pin_memory=pin)
                      for _ in range(slots)]
        self._spec_host = [] if spec_body is None else [
            torch.empty(state.spec_packed.shape, dtype=torch.float32, pin_memory=pin)
            for _ in range(slots)]
        self._slot = 0

    def key(self, max_seq_len: int, sampled: bool,
            feat: bool = False) -> Tuple[int, bool, bool]:
        for b in self.buckets:
            if max_seq_len <= b:
                return b, bool(sampled), bool(feat)
        raise ValueError(f"max_seq_len {max_seq_len} above the largest bucket {self.buckets[-1]}")

    def _capture(self, fn, pool, stream) -> Tuple[torch.cuda.CUDAGraph, dict]:
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as launched:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                fn()
        return graph, launched

    def capture_all(self) -> None:
        """Capture every key's graph on a side stream into one pool. Runs
        the body once eagerly first (lazy library set-up; the state's rows
        are all inactive, so its writes land in scratch block 0).
        ``pool_bytes``: device memory reserved after the captures beyond
        before, with the allocator's unused cache released both times: the
        graphs' pool (and the decode scratch reserved for them)."""
        dev = self.device
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        feats = (False, True) if self.state.features else (False,)
        with torch.cuda.stream(stream):
            if self._reserve is not None:
                self._reserve()
            for feat in feats:
                self.body(self.state, self.buckets[-1], True, feat)
            if self.spec_body is not None:
                self.spec_body(self.state, self.buckets[-1])
        stream.synchronize()
        pool = torch.cuda.graph_pool_handle()
        for b in self.buckets:
            for sampled in (False, True):
                for feat in feats:
                    self.graphs[(b, sampled, feat)] = self._capture(
                        lambda: self.body(self.state, b, sampled, feat), pool, stream)
            if self.spec_body is not None:
                self.spec_graphs[b] = self._capture(
                    lambda: self.spec_body(self.state, b), pool, stream)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0

    def next_slot(self) -> int:
        """The ring slot of the next run: its staging buffers and host
        copy are free (the run that last used them has been fetched)."""
        slot = self._slot
        self._slot = (slot + 1) % len(self._host)
        return slot

    def run(self, slot: int, max_seq_len: int, sampled: bool, spec: bool = False,
            feat: bool = False):
        """One horizon (the spec body when ``spec``; the feature body when
        ``feat``) on the current stream, its packed results copied to host
        slot ``slot``; returns (that host tensor, an event recorded after
        the copy, or None off CUDA)."""
        key = self.key(max_seq_len, sampled, feat)
        if self.capture:
            graph, launched = self.spec_graphs[key[0]] if spec else self.graphs[key]
            graph.replay()
            _build.add_replayed(launched)
            self.replays += 1
            self.spec_replays += spec
        elif spec:
            self.spec_body(self.state, key[0])
        else:
            self.body(self.state, *key)
        host = (self._spec_host if spec else self._host)[slot]
        host.copy_(self.state.spec_packed if spec else self.state.packed, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def fetch(host: torch.Tensor, event) -> np.ndarray:
        """Fetch thread: wait for a run's copy and take its results."""
        if event is not None:
            event.synchronize()
        return host.numpy().copy()

    def stats(self) -> dict:
        return {"graphs": len(self.graphs) + len(self.spec_graphs),
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "replays": self.replays, "spec_replays": self.spec_replays}
