"""TorchEngine: continuous-batching paged-KV serving engine on PyTorch/CUDA.

Counterpart of the reference's engine/engine.py ``TpuEngine``, for the
llama, gemma, gpt-oss, Qwen3-MoE and DeepSeek (MLA) families on one GPU
(models/registry.py picks the family's functions):

- the paged KV cache lives on the device as ``[num_blocks, block_size,
  kv_heads, head_dim]`` per layer; block 0 is scratch;
- device-side prefix-cache reuse: the host ``BlockAllocator``
  content-addresses sealed blocks by chained sequence hash; admission pins
  the longest cached prefix and prefill feeds only the uncached suffix;
- chunked, bucketed prefill: one bounded chunk per loop tick (so resident
  decodes keep moving), padded to a bucket with the reference's conventions
  (pad positions at ``max_context - 1``, pad rows writing scratch block 0);
- the decode horizon (``decode_steps`` > 1, ``_decode_multi``): several
  decode steps per dispatch on device tensors only, each step's sampled
  token fed back on the device, the results read back once per horizon as
  one packed ``[N, B, 2 + 2K]`` array; up to ``decode_pipeline`` horizons
  in flight, each chained on the last one's device carry; stop conditions
  applied on the host afterwards (the tokens after a stop are a discarded
  speculative tail). On CUDA each horizon is one replay of a CUDA graph
  captured at engine start (engine/graphs.py). ``autotune_decode_schedule``
  picks both knobs when they are None. A tick with requests waiting, or
  with no pages to book a horizon, runs ONE eager decode step instead;
- the fused mixed step: when a prefill chunk and resident decodes coexist,
  ONE forward serves both, with the chunk as row 0 and the decode slots as
  rows 1..B of one unified ragged attention launch;
- sampling on the device (only token ids, logprobs and top-logprob rows
  come back to the host);
- the int8 paged cache (``kv_dtype="int8"``, ops/quant.py): int8 pages plus
  f32 ``[num_blocks, kv_heads]`` scale rows per layer, quantized on write,
  read by the int8 forms of the three attention kernels;
- KVBM (``kvbm=KvbmTiers(...)``, kvbm/pool.py): sealed blocks are gathered
  off the device by the block-copy kernel, one launch per offload batch
  for every layer, and written through to the host (G2) and disk (G3)
  tiers on an offload thread; a prompt whose prefix missed the device
  cache onboards it from the tiers before admission, by one scatter
  launch of the block-copy kernel.

Attention runs through the wrappers of the hand-written CUDA kernels
(ops/cuda_attention, cuda_prefill, cuda_unified): on CUDA tensors they
launch the kernels, on CPU tensors (``device="cpu"``, how the tests hold
this engine to ``TpuEngine``) they run the plain PyTorch versions. A layer
that passes attention attributes (gemma's sliding window and softcap,
gpt-oss's window and per-head sinks) is served by the unified kernel in
every step kind, as the reference routes any call with a non-empty
``extra``: a decode step as ``q_len = 1`` rows, a prefill chunk as one
ragged row, and the mixed step as it is. The llama and Qwen3-MoE families
keep their decode and flash-extend kernels. An MLA model (one kv head of
576 latent lanes) is served by the latent kernel (ops/cuda_mla) in every
step kind, in the same ragged form; its cache holds bf16 only (an int8
cache is refused). The expert FFNs (gpt-oss, Qwen3-MoE, DeepSeek's
routed experts) run as grouped matrix products over the (token, slot)
pairs sorted by expert on the device (models/gptoss.experts_grouped,
models/moe.experts_grouped), inside the horizon's graphs too.

Device work runs on a single executor thread so the asyncio loop that
streams results never blocks behind the GPU; a horizon's readback waits on
a fetch thread.

Not in this slice (ROADMAP.md): spec decode, LoRA, guided decoding, logits
processors, vision, embeddings, the G4 remote KVBM tier, disaggregated
transfer, parallelism, and the KV-event / metrics / tracing / SLO hooks. A
request that asks for one of those is refused with
``UnsupportedRequestError``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, AsyncIterator, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..llm.protocols.common import (
    FINISH_CANCELLED,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_STOP,
    BackendOutput,
    PreprocessedRequest,
)
from ..kvbm.layout import (
    QuantizedBlockCodec,
    block_shape_for,
    from_host,
    storage_dtype,
    to_host,
)
from ..models import llama, moe, registry
from ..ops import attention as att
from ..ops import block_copy as bc
from ..ops import cuda_attention, cuda_mla, cuda_prefill, cuda_unified
from ..ops.quant import QuantizedKV, resolve_kv_dtype
from ..runtime.engine import Context
from ..tokens import TokenBlockSequence
from .allocator import BlockAllocator, OutOfBlocks
from .graphs import HorizonGraphs, HorizonState, seq_len_buckets
from .sampling import (
    TOP_LOGPROBS_K,
    apply_penalties,
    gumbel_noise,
    gumbel_noise_tensor,
    logprobs_of,
    sample_tokens,
    top_logprobs,
    update_counts,
)

log = logging.getLogger("dynamo_tpu_torch.engine")


class UnsupportedRequestError(ValueError):
    """The request asks for a feature this engine does not have."""


@dataclasses.dataclass
class TorchEngineConfig:
    model: llama.LlamaConfig
    num_blocks: int = 512
    block_size: int = 16
    max_batch_size: int = 8
    # prompts longer than the largest bucket prefill in chunks of it
    max_context: int = 2048
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    seed: int = 0
    # None = cuda (raises without a GPU); "cpu" runs the plain ops
    device: Optional[str] = None
    # paged-KV storage: "model" (the model dtype), "int8" (int8 pages plus
    # per-block-per-kv-head f32 scales, ops/quant.py), or "auto" (the
    # DTPU_KV_DTYPE env, default "model"), as the reference resolves it
    kv_dtype: str = "auto"
    # decode horizon: decode iterations per dispatch (1: one eager step per
    # tick), and horizons in flight, each chained on the last one's device
    # carry. None = auto-tune both at startup (autotune_decode_schedule),
    # as the reference does.
    decode_steps: Optional[int] = None
    decode_pipeline: Optional[int] = None
    # on CUDA each horizon replays a CUDA graph captured at engine start;
    # False runs the same horizon body eagerly on the card (to compare the
    # two). The CPU always runs it eagerly.
    cuda_graphs: bool = True

    def __post_init__(self):
        bad = [b for b in self.prefill_buckets if b % self.block_size]
        if bad:
            raise ValueError(
                f"prefill_buckets {bad} not multiples of block_size {self.block_size}"
            )
        for name in ("decode_steps", "decode_pipeline"):
            if getattr(self, name) is not None and getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1 (or None to auto-tune)")
        self.kv_dtype = resolve_kv_dtype(self.kv_dtype)

    @property
    def kv_quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def prefill_chunk(self) -> int:
        """Largest single prefill dispatch; longer prompts chunk at this."""
        return self.prefill_buckets[-1]

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_context + self.block_size - 1) // self.block_size


@dataclasses.dataclass
class _Seq:
    req: PreprocessedRequest
    context: Context
    out_queue: asyncio.Queue
    seq: TokenBlockSequence               # prompt + generated
    slot: int = -1
    block_ids: List[int] = dataclasses.field(default_factory=list)
    produced: int = 0
    last_token: int = 0
    cached_tokens: int = 0
    prefill_pos: int = 0                  # prompt tokens whose KV is written
    kv_written: int = 0                   # leading tokens whose KV a decode wrote
    commit_upto: int = 0                  # prompt blocks content-addressed so far
    prefilled: bool = False               # first token sampled -> decode eligible
    counting: bool = False                # keeps output_counts (penalties)
    done: bool = False


# (sequence, token, logprob, top-logprob ids or None, top-logprob values or None)
Accepted = Tuple[_Seq, int, float, Optional[List[int]], Optional[List[float]]]


def _has_penalties(s) -> bool:
    return (
        s.presence_penalty != 0.0
        or s.frequency_penalty != 0.0
        or s.repetition_penalty != 1.0
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_device_rtt(device, tries: int = 3) -> float:
    """Median launch -> readback round trip of a trivial op: the op, then a
    real copy of its result to the host (``.cpu()``), as the reference
    probes with ``np.asarray``."""
    x = torch.zeros(8, dtype=torch.float32, device=device)
    (x + 1).cpu()   # warm the op
    samples = []
    for _ in range(tries):
        t0 = time.perf_counter()
        (x + 1).cpu()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def measure_copy_rate(device, tries: int = 3) -> float:
    """Bytes per second the device reads and writes in a device-to-device
    copy, best of ``tries`` after a warm-up: the rate a decode step reads
    the weights at (256 MiB copied on CUDA, 32 MiB elsewhere)."""
    device = torch.device(device)
    nbytes = 1 << 28 if device.type == "cuda" else 1 << 25
    src = torch.ones(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    _sync(device)
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        dst.copy_(src)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return 2 * nbytes / best


def param_bytes(params) -> int:
    """Bytes of every tensor in a parameter tree (dicts and lists)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_bytes(p) for p in items)


def autotune_decode_schedule(params, device) -> Tuple[Tuple[int, int], dict]:
    """((decode_steps, decode_pipeline), the measurements): the reference's
    rule with this device's own numbers. A decode step reads every weight
    once, so t_step = weight bytes / the device's measured copy rate; the
    horizon is the power of two in [8, 64] nearest above RTT / t_step
    steps, so that its compute covers a readback's round trip; and a
    second horizon is kept in flight when the round trip is longer than
    two steps. (The reference's 816 GB/s and 0.45 are TPU calibrations and
    no prior here.)"""
    rate = measure_copy_rate(device)
    t_step = max(param_bytes(params) / rate, 1e-6)
    rtt = measure_device_rtt(device)
    steps = 8
    while steps < 64 and steps < rtt / t_step:
        steps *= 2
    pipeline = 2 if rtt > 2 * t_step else 1
    log.info("decode schedule auto-tuned: rtt=%.3fms copy rate=%.0f GB/s t_step~%.3fms "
             "-> steps=%d pipeline=%d", rtt * 1e3, rate / 1e9, t_step * 1e3, steps, pipeline)
    return (steps, pipeline), {"rtt_s": rtt, "copy_bytes_s": rate, "t_step_s": t_step}


@dataclasses.dataclass
class _Chain:
    """A decode horizon in flight: the host slot its packed [N, B, 2+2K]
    results are copied to and the event after that copy, the sequence
    snapshot taken at dispatch (results are never applied to a sequence
    admitted into a recycled slot later), the device carry's seq_lens
    after it (host mirror: what the next chained horizon starts from), and
    the fetch thread's future."""
    seqs: List[Optional["_Seq"]]
    host: torch.Tensor
    event: Any
    lens_after: np.ndarray
    fetch: Any = None


class _UnifiedRows:
    """One step's arguments of the unified kernel, each moved to the
    device on first use: the row arrays (q_starts, q_lens, seq_lens), and
    one [R] windows array per distinct window a layer asks for; and
    ``max_seq_len``, the host's bound on seq_lens that sizes the kernel's
    split-K grid."""

    def __init__(self, to_device, q_starts, q_lens, seq_lens):
        self._t = to_device
        self._host = (q_starts, q_lens, seq_lens)
        self._rows = None
        self._windows = {}
        self.max_seq_len = int(np.max(seq_lens, initial=0))

    def rows(self) -> List[torch.Tensor]:
        if self._rows is None:
            self._rows = [self._t(a, torch.int32) for a in self._host]
        return self._rows

    def attrs(self, window: Optional[int] = None, **extra) -> dict:
        """A layer's attention attributes as the kernel takes them: its
        sliding window (None: full) as an [R] windows array."""
        if window:
            if window not in self._windows:
                R = len(self._host[0])
                self._windows[window] = self._t(np.full(R, window), torch.int32)
            extra["windows"] = self._windows[window]
        return extra


class TorchEngine:
    """AsyncEngine serving PreprocessedRequests with a llama-, gemma-,
    gpt-oss-, Qwen3-MoE- or MLA-family model."""

    def __init__(self, config: TorchEngineConfig, params: Optional[llama.Params] = None,
                 kvbm=None):
        self.cfg = config
        self.mcfg = mcfg = config.model
        # an MLA model's attention runs on its latent cache (ops/cuda_mla)
        self._latent = registry.is_mla(mcfg)
        if self._latent and config.kv_quantized:
            raise ValueError("an MLA model's latent cache has no int8 form yet: "
                             "use kv_dtype='model'")
        self.device = resolve_device(config.device)
        self.kv_quantized = config.kv_quantized
        self.allocator = BlockAllocator(config.num_blocks, config.block_size)
        self._host_rng = np.random.default_rng(config.seed)
        dev = self.device
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(config.seed)
            params = registry.init_params(mcfg, gen, dev)
        self.params = params
        self._forward = registry.forward_fn(mcfg)
        self._lm_logits = registry.lm_logits_fn(mcfg)
        self.k_caches = self._init_caches()
        self.v_caches = self._init_caches()
        # the decode schedule (both knobs size the horizon's buffers and
        # graphs); the measurements behind an auto-tuned one
        self.schedule: Dict[str, Any] = {}
        if config.decode_steps is None or config.decode_pipeline is None:
            (steps, pipeline), self.schedule = autotune_decode_schedule(params, dev)
            if config.decode_steps is None:
                config.decode_steps = steps
            if config.decode_pipeline is None:
                config.decode_pipeline = pipeline

        # --- slot state (the decode batch is fixed-width) ---
        B, V = config.max_batch_size, mcfg.vocab_size
        self._slots: List[Optional[_Seq]] = [None] * B
        self._tokens = np.zeros(B, np.int64)
        self._block_tables = np.zeros((B, config.max_blocks_per_seq), np.int32)
        self._temps = np.zeros(B, np.float32)
        self._top_ks = np.zeros(B, np.int64)
        self._top_ps = np.ones(B, np.float32)
        self._min_ps = np.zeros(B, np.float32)
        self._pres = np.zeros(B, np.float32)
        self._freqs = np.zeros(B, np.float32)
        self._reps = np.ones(B, np.float32)
        self._lp_ns = np.zeros(B, np.int32)    # requested top-logprobs per slot
        self._seeds = np.zeros(B, np.uint32)   # the reference's uint32 seeds
        # penalty state tables (see engine/sampling.py)
        self.output_counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        self.prompt_masks = torch.zeros((B, V), dtype=torch.int8, device=dev)
        self._slot_dirty = np.zeros(B, bool)   # slot's penalty rows need reset

        self._waiting: List[_Seq] = []
        self._prefill_rr = 0  # round-robin cursor over prefilling sequences
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._idle = True   # the loop is parked with no request to serve
        # dispatches run so far, by kind ("prefill" | "decode" | "mixed" |
        # "horizon": one multi-step decode dispatch)
        self.step_counts: Dict[str, int] = {"prefill": 0, "decode": 0, "mixed": 0,
                                            "horizon": 0}
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-step")
        # horizons in flight, oldest first; their readbacks wait on the
        # fetch thread so the step thread keeps dispatching
        self._chains: Deque[_Chain] = deque()
        self._fetch_executor = ThreadPoolExecutor(max_workers=1,
                                                  thread_name_prefix="torch-fetch")

        # --- KVBM (kvbm/pool.py): sealed blocks write through to host/disk ---
        self.kvbm = kvbm
        # (block id, sequence hash, priority) whose KV is written and that
        # wait for the next offload batch: 0 = prompt blocks (highest reuse
        # odds), 1 = decode-sealed blocks
        self._offload_pending: List[Tuple[int, int, int]] = []
        # decode-sealed blocks whose last row is not written yet: (sequence,
        # block index, block id, sequence hash). A block enters the prefix
        # cache (and the offload queue) only once a step has written it
        # (_commit_written_blocks)
        self._sealed_unwritten: List[Tuple[_Seq, int, int, int]] = []
        # errors of the offload thread (device-to-host copy, encoding); the
        # gather kernels run on the step executor and raise into the loop
        self.offload_errors = 0
        self._offload_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-offload"
        )
        self._offload_stream = (
            torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        )
        self._codec = (
            QuantizedBlockCodec(block_shape_for(mcfg, config.block_size, "int8"))
            if self.kv_quantized else None
        )
        self._horizon: Optional[HorizonGraphs] = None
        if config.decode_steps > 1:
            self._horizon = self._build_horizon()

    def _build_horizon(self) -> HorizonGraphs:
        """The horizon's static buffers, and on CUDA (unless ``cuda_graphs``
        is off) its graphs, captured now, before any traffic."""
        c, m = self.cfg, self.mcfg
        window_for = getattr(m, "window_for_layer", None)
        windows = sorted({w for w in map(window_for, range(m.num_layers)) if w}
                         if window_for else set())
        state = HorizonState(c.max_batch_size, c.max_blocks_per_seq, c.decode_steps,
                             m.vocab_size, TOP_LOGPROBS_K, self.device, windows,
                             slots=c.decode_pipeline)
        capture = self.device.type == "cuda" and c.cuda_graphs
        # the split scratch of the kernel the decode steps reach: the decode
        # kernel's for the families whose layers reach it (gemma's and
        # gpt-oss's all go through the unified kernel), the latent kernel's
        # for MLA, sized for the mixed step's rows too
        reserve = None
        if self._latent:
            def reserve():
                cuda_mla.reserve(self.device, c.max_batch_size + 1, m.num_heads,
                                 c.max_context)
        elif registry.family(m) in (llama, moe):
            def reserve():
                cuda_attention.reserve(self.device, c.max_batch_size, m.num_heads,
                                       m.num_kv_heads, c.max_context)
        graphs = HorizonGraphs(
            self._decode_multi, state,
            seq_len_buckets(c.max_context, cuda_attention.DEC_SPLIT_KEYS), self.device,
            capture, reserve=reserve)
        if capture:
            graphs.capture_all()
            log.info("decode horizon: %d CUDA graphs of %d steps captured in %.2f s, "
                     "pool %.1f MiB", len(graphs.graphs), c.decode_steps, graphs.capture_s,
                     graphs.pool_bytes / 2**20)
        return graphs

    def horizon_stats(self) -> dict:
        """Graphs, capture seconds, pool bytes and replays of the horizon."""
        return self._horizon.stats() if self._horizon is not None else {}

    def _init_caches(self) -> list:
        """One zeroed paged cache per layer: raw model-dtype tensors, or
        ``QuantizedKV`` (int8 payload + f32 [num_blocks, kv_heads] scales)."""
        c, m = self.cfg, self.mcfg
        shape = (c.num_blocks, c.block_size, m.num_kv_heads, m.head_dim)
        if self.kv_quantized:
            return [QuantizedKV(torch.zeros(shape, dtype=torch.int8, device=self.device),
                                torch.zeros((c.num_blocks, m.num_kv_heads),
                                            dtype=torch.float32, device=self.device))
                    for _ in range(m.num_layers)]
        return [torch.zeros(shape, dtype=m.dtype, device=self.device)
                for _ in range(m.num_layers)]

    # ------------------------------------------------------------ requests
    def _check_request(self, req: PreprocessedRequest) -> List[int]:
        """Refuse what this engine cannot serve as asked; returns the prompt
        (token_ids + prior_token_ids, as the reference)."""
        ann = req.annotations or {}
        for key in ("lora", "logits_processors", "images", "disagg"):
            if ann.get(key):
                raise UnsupportedRequestError(f"this engine does not support {key!r}")
        if ann.get("op") == "embed":
            raise UnsupportedRequestError("this engine does not serve embeddings")
        if req.sampling.guided is not None:
            raise UnsupportedRequestError("this engine has no guided decoding")
        if req.kv_transfer:
            raise UnsupportedRequestError("this engine has no KV transfer")
        seed = req.sampling.seed
        if seed is not None and not 0 <= seed < 1 << 32:
            raise ValueError(f"seed {seed} outside [0, 2**32): seeds key as uint32")
        prompt = list(req.token_ids) + list(req.prior_token_ids)
        if not prompt:
            raise ValueError("empty prompt")
        if min(prompt) < 0 or max(prompt) >= self.mcfg.vocab_size:
            raise ValueError(f"prompt token ids outside the vocab of {self.mcfg.vocab_size}")
        if len(prompt) >= self.cfg.max_context:
            raise ValueError(
                f"prompt {len(prompt)} tokens exceeds engine max_context "
                f"{self.cfg.max_context}"
            )
        if len(prompt) // self.cfg.block_size + 2 > self.cfg.num_blocks:
            raise ValueError(
                f"prompt {len(prompt)} tokens cannot fit the KV pool "
                f"({self.cfg.num_blocks} blocks x {self.cfg.block_size})"
            )
        return prompt

    async def generate(self, request: Any, context: Context) -> AsyncIterator[BackendOutput]:
        req = request if isinstance(request, PreprocessedRequest) else (
            PreprocessedRequest.from_obj(request)
        )
        prompt = self._check_request(req)
        self._ensure_loop()
        st = _Seq(
            req=req, context=context, out_queue=asyncio.Queue(),
            seq=TokenBlockSequence(prompt, self.cfg.block_size),
            last_token=prompt[-1],
        )
        if self.kvbm is not None:
            # a tier miss or a foreign block format is a miss; a kernel or
            # device error raises to the caller (no silent recompute)
            await self._onboard_from_kvbm(st)
        self._waiting.append(st)
        self._idle = False
        self._wake.set()
        while True:
            item = await st.out_queue.get()
            yield item
            if item.finish_reason is not None:
                return

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
        self._executor.shutdown(wait=False)
        self._fetch_executor.shutdown(wait=False)
        self._offload_executor.shutdown(wait=False)

    # ------------------------------------------------------------ step loop
    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                if (not self._waiting and not self._chains
                        and all(s is None for s in self._slots)):
                    self._wake.clear()
                    self._idle = True
                    await self._wake.wait()
                    self._idle = False
                self._admit_cancelled()
                self._try_admit()
                # chunked prefill: ONE bounded chunk per tick, round-robin
                # over prefilling sequences
                prefilling = [
                    s for s in self._slots
                    if s is not None and not s.done and not s.prefilled
                ]
                did_mixed = False
                mixed_blocked = False
                if prefilling:
                    pick = prefilling[self._prefill_rr % len(prefilling)]
                    self._prefill_rr += 1
                    if pick.context.is_stopped():
                        pick.done = True
                        pick.out_queue.put_nowait(BackendOutput(
                            finish_reason=FINISH_CANCELLED,
                            cumulative_tokens=pick.produced,
                        ))
                    else:
                        # the fused mixed step, when decode rows are resident
                        # and no horizon is in flight (its carry would
                        # predate the fused step's cache writes)
                        mixed_seqs = None
                        if not self._chains:
                            snap = self._decode_snapshot()
                            if any(s is not None for s in snap):
                                if self._book_decode_blocks(snap, 1):
                                    mixed_seqs = snap
                                else:
                                    # no pages: this chunk runs split, and
                                    # horizons go on rather than wait for a
                                    # fused step that cannot book
                                    mixed_blocked = True
                        if mixed_seqs is not None:
                            results, first = await loop.run_in_executor(
                                self._executor, self._run_mixed_step, pick, mixed_seqs
                            )
                            did_mixed = True
                            for acc in results:
                                self._accept_token(*acc)
                        else:
                            first = await loop.run_in_executor(
                                self._executor, self._run_prefill_chunk, pick
                            )
                        self._commit_prefilled_blocks(pick)
                        if first is not None:
                            pick.prefilled = True
                            self._accept_token(*first)
                has_active = any(s is not None for s in self._decode_snapshot())
                # top up the horizon pipeline before fetching the oldest
                # results, so that the readback overlaps the horizons in
                # flight. While a prefill that the mixed step could carry is
                # in progress, no horizon is dispatched: the chains in
                # flight drain, then each tick runs one fused step. (A
                # prefill's first token is applied at once here, so a
                # prefill that just ended no longer holds horizons back.)
                prefilling = [s for s in prefilling if not s.done and not s.prefilled]
                mixed_wait = bool(prefilling) and has_active and not mixed_blocked
                while (
                    has_active
                    and not self._waiting
                    and not did_mixed
                    and not mixed_wait
                    and len(self._chains) < self.cfg.decode_pipeline
                    and (not self._chains or self._can_chain(self._chains[-1]))
                    and self._prepare_horizon(depth=len(self._chains) + 1)
                ):
                    prev = self._chains[-1] if self._chains else None
                    chain = await loop.run_in_executor(
                        self._executor, self._dispatch_horizon, prev, self._decode_snapshot()
                    )
                    chain.fetch = self._fetch_executor.submit(
                        HorizonGraphs.fetch, chain.host, chain.event
                    )
                    self._chains.append(chain)
                if self._chains:
                    chain = self._chains.popleft()
                    packed = await asyncio.wrap_future(chain.fetch)
                    self._apply_packed(chain, packed)
                elif has_active and not did_mixed:
                    results = await loop.run_in_executor(
                        self._executor, self._run_decode, self._decode_snapshot()
                    )
                    for acc in results:
                        self._accept_token(*acc)
                self._reap_finished()
                if self.kvbm is not None:
                    await self._offload_ready_blocks()
                await asyncio.sleep(0)
        except Exception:
            log.exception("engine loop crashed")
            for st in list(self._waiting) + [s for s in self._slots if s]:
                st.done = True
                st.out_queue.put_nowait(BackendOutput(
                    finish_reason=FINISH_ERROR, cumulative_tokens=st.produced,
                ))
                if st.block_ids:
                    self.allocator.release(st.block_ids)
            self._waiting = []
            self._slots = [None] * self.cfg.max_batch_size
            self._chains.clear()
            self._sealed_unwritten = []

    def _admit_cancelled(self) -> None:
        keep = []
        for st in self._waiting:
            if st.context.is_stopped():
                st.out_queue.put_nowait(
                    BackendOutput(finish_reason=FINISH_CANCELLED, cumulative_tokens=0)
                )
            else:
                keep.append(st)
        self._waiting = keep

    def _free_slot(self) -> int:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return -1

    def _try_admit(self) -> None:
        still: List[_Seq] = []
        bs = self.cfg.block_size
        for st in self._waiting:
            slot = self._free_slot()
            if slot < 0:
                still.append(st)
                continue
            prompt_len = len(st.seq)
            hashes = st.seq.sequence_hashes()
            # reuse at most the blocks strictly before the last prompt token,
            # so prefill always has >= 1 token to produce logits from
            reusable = min(len(hashes), (prompt_len - 1) // bs)
            prefix_ids = self.allocator.acquire_prefix(hashes[:reusable])
            blocks_needed = (prompt_len + bs - 1) // bs - len(prefix_ids)
            try:
                new_ids = self.allocator.allocate(blocks_needed)
            except OutOfBlocks:
                self.allocator.release(prefix_ids)
                still.append(st)
                continue
            st.block_ids = prefix_ids + new_ids
            st.cached_tokens = len(prefix_ids) * bs
            # prompt blocks become content-addressed only as their chunks'
            # KV is written (_commit_prefilled_blocks)
            st.commit_upto = len(prefix_ids)
            st.prefill_pos = st.cached_tokens
            st.slot = slot
            self._slots[slot] = st
            self._block_tables[slot].fill(0)
            self._block_tables[slot, : len(st.block_ids)] = st.block_ids
            s = st.req.sampling
            self._temps[slot] = s.temperature
            self._top_ks[slot] = s.top_k
            self._top_ps[slot] = s.top_p
            self._min_ps[slot] = s.min_p
            self._pres[slot] = s.presence_penalty
            self._freqs[slot] = s.frequency_penalty
            self._reps[slot] = s.repetition_penalty
            self._lp_ns[slot] = min(max(s.logprobs, 0), TOP_LOGPROBS_K)
            self._seeds[slot] = (
                s.seed if s.seed is not None else self._host_rng.integers(1 << 32)
            )
            # penalty tables: reset the slot's rows when this request uses
            # penalties or a prior occupant left them dirty
            st.counting = _has_penalties(s)
            if st.counting or self._slot_dirty[slot]:
                row = torch.zeros(self.mcfg.vocab_size, dtype=torch.int8)
                if st.counting:
                    row[torch.as_tensor(st.seq.tokens(), dtype=torch.long)] = 1
                self.prompt_masks[slot] = row.to(self.device)
                self.output_counts[slot] = 0
            # counts accumulate for every active slot while anyone counts: a
            # slot that shared a batch with a counting request holds stale
            # counts the next occupant must not inherit
            self._slot_dirty[slot] = st.counting or any(
                o is not None and o.counting for o in self._slots if o is not st
            )
            if st.counting:
                for j, other in enumerate(self._slots):
                    if other is not None and other is not st:
                        self._slot_dirty[j] = True
        self._waiting = still

    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prefill of {n} tokens exceeds largest bucket {self.cfg.prefill_buckets[-1]}"
        )

    def _commit_prefilled_blocks(self, st: _Seq) -> None:
        """Content-address the prompt blocks whose KV the last chunk wrote:
        only written blocks ever become matchable."""
        hashes = st.seq.sequence_hashes()
        upto = min(st.prefill_pos // self.cfg.block_size, len(hashes))
        for i in range(st.commit_upto, upto):
            self.allocator.commit(st.block_ids[i], hashes[i])
            if self.kvbm is not None:
                self._offload_pending.append((st.block_ids[i], hashes[i], 0))
        st.commit_upto = max(st.commit_upto, upto)

    def _decode_snapshot(self) -> List[Optional[_Seq]]:
        return [
            st if (st is not None and not st.done and st.prefilled) else None
            for st in self._slots
        ]

    def _book_decode_blocks(self, seqs: List[Optional[_Seq]], extra_tokens: int) -> bool:
        """Give every active sequence in ``seqs`` pages for ``extra_tokens``
        more decode tokens; all-or-nothing (what one call took is given back
        on failure)."""
        bs = self.cfg.block_size
        granted: List[Tuple[_Seq, int]] = []
        ok = True
        for st in seqs:
            if st is None or st.done or not st.prefilled:
                continue
            L = len(st.seq)
            if L + extra_tokens >= self.cfg.max_context:
                ok = False
                break
            extra = (L + extra_tokens) // bs + 1 - len(st.block_ids)
            if extra > 0:
                try:
                    new_ids = self.allocator.allocate(extra)
                except OutOfBlocks:
                    ok = False
                    break
                base = len(st.block_ids)
                st.block_ids.extend(new_ids)
                self._block_tables[st.slot, base:base + extra] = new_ids
                granted.append((st, extra))
        if not ok:
            for st, count in granted:
                taken = st.block_ids[-count:]
                del st.block_ids[-count:]
                self._block_tables[st.slot, len(st.block_ids):len(st.block_ids) + count] = 0
                self.allocator.release(taken)
        return ok

    def _prepare_horizon(self, depth: int = 1) -> bool:
        """Book pages so that every decoding sequence can absorb ``depth``
        more horizons (depth 2 when dispatching on top of one in flight).
        False: no horizon this tick (decode_steps 1, too few pages, or a
        sequence within reach of max_context); the loop runs one step."""
        n = self.cfg.decode_steps
        if n <= 1:
            return False
        return self._book_decode_blocks(self._slots, depth * n)

    def _can_chain(self, chain: _Chain) -> bool:
        """A horizon may start from ``chain``'s device carry only if every
        decoding slot holds the sequence it held at that dispatch: a
        sequence admitted into a recycled slot would decode from a stale
        carry."""
        for i, st in enumerate(self._slots):
            if (st is not None and not st.done and st.prefilled
                    and chain.seqs[i] is not st):
                return False
        return True

    # ------------------------------------------------ device work (executor)
    def _t(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def _chunk_arrays(self, token_ids: List[int], start: int, chunk_len: int,
                      block_ids: List[int]):
        """One prefill chunk's padded host arrays: (tokens [S_pad], positions
        [S_pad], new_block_ids [S_pad // bs]). Pad positions pin to
        max_context - 1, pad rows write scratch block 0."""
        bs = self.cfg.block_size
        S_pad = self._bucket(chunk_len)
        tokens = np.zeros(S_pad, np.int64)
        tokens[:chunk_len] = token_ids[start:start + chunk_len]
        positions = np.full(S_pad, self.cfg.max_context - 1, np.int64)
        positions[:chunk_len] = np.arange(start, start + chunk_len)
        new_block_ids = np.zeros(S_pad // bs, np.int64)
        real = block_ids[start // bs:][: S_pad // bs]
        new_block_ids[: len(real)] = real
        return tokens, positions, new_block_ids

    def _next_chunk(self, st: _Seq):
        prompt = st.seq.tokens()
        start = st.prefill_pos
        remaining = len(prompt) - start
        is_final = remaining <= self.cfg.prefill_chunk
        chunk_len = remaining if is_final else self.cfg.prefill_chunk
        arrays = self._chunk_arrays(prompt, start, chunk_len, st.block_ids)
        return start, chunk_len, is_final, arrays

    def _chunk_table(self, st: _Seq, total_len: int) -> torch.Tensor:
        """The sequence's block table cut to the pages holding keys <
        total_len (the attention never reads past them)."""
        n = -(-total_len // self.cfg.block_size)
        return self._t(self._block_tables[st.slot, :n], torch.int32)

    def _ragged(self, q, kc, vc, tables, rows, max_q_len: int, max_seq_len: int,
                attrs: dict) -> torch.Tensor:
        """One ragged launch over ``rows`` (q_starts, q_lens, seq_lens): the
        latent kernel for an MLA model (its first kv_lora_rank output
        lanes), else the unified kernel with the layer's attention
        attributes."""
        if self._latent:
            return cuda_mla.latent_paged_attention(
                q, kc, vc, tables, *rows, v_dim=self.mcfg.kv_lora_rank, max_q_len=max_q_len,
                max_seq_len=max_seq_len)
        return cuda_unified.ragged_paged_attention(
            q, kc, vc, tables, *rows, max_q_len=max_q_len, max_seq_len=max_seq_len, **attrs)

    @torch.inference_mode()
    def _run_prefill_chunk(self, st: _Seq) -> Optional[Accepted]:
        """Prefill ONE bounded chunk of st's prompt; the final chunk also
        samples the first token (returned), earlier ones return None."""
        start, chunk_len, is_final, (tokens, positions, new_ids) = self._next_chunk(st)
        total_len = start + chunk_len
        table = self._chunk_table(st, total_len)
        new_ids_t = self._t(new_ids)

        pad = self._pad_rows(chunk_len, len(tokens))
        # for layers with attention attributes: the chunk as ONE ragged row
        # of the unified kernel, its segment at the tail of a total_len context
        unified = _UnifiedRows(self._t, [0], [chunk_len], [total_len])

        def attend(q, k_new, v_new, layer_idx, **extra):
            kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
            att.write_prefill_kv(kc, vc, *pad(k_new, v_new), new_ids_t)
            if extra or self._latent:
                return self._ragged(q, kc, vc, table[None], unified.rows(), chunk_len,
                                    unified.max_seq_len, unified.attrs(**extra))
            if self.kv_quantized:
                # raw int8 context + per-position scales: the kernel
                # dequantizes in registers (half the context bytes of bf16)
                kq, vq, ks, vs = att.gather_kv_quant(kc, vc, table)
                return cuda_prefill.flash_extend_attention(
                    q, kq, vq, start, total_len, k_scales=ks, v_scales=vs)
            k_ctx, v_ctx = att.gather_kv(kc, vc, table)
            return cuda_prefill.flash_extend_attention(q, k_ctx, v_ctx, start, total_len)

        hidden = self._forward(
            self.params, self.mcfg, self._t(tokens), self._t(positions), attend
        )
        self.step_counts["prefill"] += 1
        st.prefill_pos = total_len
        if not is_final:
            return None
        return self._first_token(st, hidden[chunk_len - 1:chunk_len])

    def _pad_rows(self, chunk_len: int, S_pad: int):
        """(k, v) -> (k, v) for the chunk's KV write. An int8 cache zeroes
        the bucket-padding rows first: they share the chunk's last block
        with real rows, and their activations would enter the per-block
        quantization amax and coarsen the real tokens' scale. Pad rows are
        never attended, so zeros are safe (and exact for the amax)."""
        if not self.kv_quantized or chunk_len == S_pad:
            return lambda k, v: (k, v)
        valid = (torch.arange(S_pad, device=self.device) < chunk_len)[:, None, None]
        return lambda k, v: (torch.where(valid, k, 0.0), torch.where(valid, v, 0.0))

    def _first_token(self, st: _Seq, hidden: torch.Tensor) -> Accepted:
        """Sample a prefill's first generated token from its last position
        (step 0 of the request's seeded stream)."""
        slot, s = st.slot, st.req.sampling
        logits = self._lm_logits(self.params, self.mcfg, hidden)      # [1, V]
        pen = logits
        if st.counting:
            pen = apply_penalties(
                logits, torch.zeros_like(logits, dtype=torch.int32),
                self.prompt_masks[slot][None], self._t([s.presence_penalty]),
                self._t([s.frequency_penalty]), self._t([s.repetition_penalty]),
            )
        gumbel = None
        if s.temperature > 0.0:
            gumbel = gumbel_noise(
                [int(self._seeds[slot])], [0], self.mcfg.vocab_size, self.device
            )
        tok = sample_tokens(
            pen, self._t([s.temperature]), self._t([s.top_k]), self._t([s.top_p]),
            self._t([s.min_p]), gumbel, filtered=s.top_k > 0 or s.top_p < 1.0,
        )
        if st.counting:
            # the first generated token enters the output counts, or the
            # first decode step's penalties would miss it
            self.output_counts[slot, tok[0]] += 1
        lp = logprobs_of(logits, tok)
        tlp_ids = tlp_vals = None
        if self._lp_ns[slot] > 0:
            vals, ids = top_logprobs(logits)
            tlp_ids, tlp_vals = ids[0].tolist(), vals[0].tolist()
        return st, int(tok[0]), float(lp[0]), tlp_ids, tlp_vals

    def _decode_dispatch_arrays(self, seqs: List[Optional[_Seq]]):
        """Per-slot host arrays of ONE decode step over ``seqs`` (shared by
        the split decode and the fused mixed step); refreshes self._tokens.
        Returns (positions, seq_lens, write_blocks, write_offsets, steps)."""
        bs = self.cfg.block_size
        B = self.cfg.max_batch_size
        positions = np.zeros(B, np.int64)
        seq_lens = np.zeros(B, np.int32)
        write_blocks = np.zeros(B, np.int64)
        write_offsets = np.zeros(B, np.int64)
        steps = np.zeros(B, np.int64)
        for i, st in enumerate(seqs):
            if st is None:
                continue
            L = len(st.seq)                    # includes the token being fed
            positions[i] = L - 1
            seq_lens[i] = L
            st.kv_written = L
            self._tokens[i] = st.last_token
            write_blocks[i] = st.block_ids[(L - 1) // bs]
            write_offsets[i] = (L - 1) % bs
            steps[i] = st.produced
        return positions, seq_lens, write_blocks, write_offsets, steps

    def _decode_epilogue(self, hidden: torch.Tensor, seqs: List[Optional[_Seq]],
                         seq_lens: np.ndarray, steps: np.ndarray) -> List[Accepted]:
        """Sample one token for every active row of a decode step."""
        logits = self._lm_logits(self.params, self.mcfg, hidden)      # [B, V]
        active = seq_lens > 0
        pen = logits
        if any(st is not None and st.counting for st in seqs):
            pen = apply_penalties(
                logits, self.output_counts, self.prompt_masks,
                self._t(self._pres), self._t(self._freqs), self._t(self._reps),
            )
        sampled = active & (self._temps > 0.0)
        gumbel = None
        if sampled.any():
            gumbel = gumbel_noise(
                [int(x) for x in self._seeds], steps.tolist(),
                self.mcfg.vocab_size, self.device, rows=sampled.tolist(),
            )
        toks = sample_tokens(
            pen, self._t(self._temps), self._t(self._top_ks),
            self._t(self._top_ps), self._t(self._min_ps), gumbel,
            filtered=bool(np.any((self._top_ks > 0) | (self._top_ps < 1.0))),
        )
        if any(st is not None and st.counting for st in self._slots):
            update_counts(self.output_counts, toks, self._t(active))
        lps = logprobs_of(logits, toks)
        want = (self._lp_ns > 0) & active
        tlp_ids = tlp_vals = None
        if want.any():
            vals, ids = top_logprobs(logits)
            tlp_ids, tlp_vals = ids.tolist(), vals.tolist()
        toks_l, lps_l = toks.tolist(), lps.tolist()
        out: List[Accepted] = []
        for i, st in enumerate(seqs):
            if st is None:
                continue
            if want[i]:
                out.append((st, toks_l[i], lps_l[i], tlp_ids[i], tlp_vals[i]))
            else:
                out.append((st, toks_l[i], lps_l[i], None, None))
        return out

    @torch.inference_mode()
    def _run_decode(self, seqs: List[Optional[_Seq]]) -> List[Accepted]:
        positions, seq_lens, write_blocks, write_offsets, steps = (
            self._decode_dispatch_arrays(seqs)
        )
        tables = self._t(self._block_tables)
        lens_t = self._t(seq_lens)
        wb, wo = self._t(write_blocks), self._t(write_offsets)
        # for layers with attention attributes: the decode batch as q_len = 1
        # rows of the unified kernel (inactive slots: q_len 0); its
        # max_seq_len also sizes the decode kernel's split grid
        unified = _UnifiedRows(self._t, np.arange(len(seq_lens)), seq_lens > 0, seq_lens)

        def attend(q, k_new, v_new, layer_idx, **extra):
            kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
            att.write_decode_kv(kc, vc, k_new[:, 0], v_new[:, 0], wb, wo)
            if extra or self._latent:
                return self._ragged(q[:, 0], kc, vc, tables, unified.rows(), 1,
                                    unified.max_seq_len, unified.attrs(**extra))[:, None]
            return cuda_attention.paged_decode_attention(
                q[:, 0], kc, vc, tables, lens_t, max_seq_len=unified.max_seq_len
            )[:, None]

        hidden = self._forward(
            self.params, self.mcfg, self._t(self._tokens)[:, None],
            self._t(positions)[:, None], attend,
        )                                                   # [B, 1, H]
        self.step_counts["decode"] += 1
        return self._decode_epilogue(hidden[:, 0], seqs, seq_lens, steps)

    @torch.inference_mode()
    def _run_mixed_step(self, st: _Seq, seqs: List[Optional[_Seq]]):
        """ONE fused forward: st's next prefill chunk (row 0 of the unified
        launch) and one decode step for the ``seqs`` snapshot (rows 1..B).
        The packed token buffer is [S_pad + B]: the chunk's bucketed tokens,
        then one decode token per slot. Returns (decode acceptances, the
        chunk's first-token acceptance or None)."""
        start, chunk_len, is_final, (c_tokens, c_positions, c_new_ids) = self._next_chunk(st)
        total_len = start + chunk_len
        positions, seq_lens, write_blocks, write_offsets, steps = (
            self._decode_dispatch_arrays(seqs)
        )
        S_pad, B = len(c_tokens), self.cfg.max_batch_size
        chunk_table = np.zeros((1, self._block_tables.shape[1]), np.int32)
        chunk_table[0] = self._block_tables[st.slot]
        tables = self._t(np.concatenate([chunk_table, self._block_tables]))
        unified = _UnifiedRows(self._t, np.concatenate([[0], S_pad + np.arange(B)]),
                               np.concatenate([[chunk_len], seq_lens > 0]),
                               np.concatenate([[total_len], seq_lens]))
        c_new_ids_t = self._t(c_new_ids)
        wb, wo = self._t(write_blocks), self._t(write_offsets)

        pad = self._pad_rows(chunk_len, S_pad)

        def attend(q, k_new, v_new, layer_idx, **extra):
            # extra: the layer's attention attributes (gemma, gpt-oss), if any
            kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
            att.write_prefill_kv(kc, vc, *pad(k_new[:S_pad], v_new[:S_pad]), c_new_ids_t)
            att.write_decode_kv(kc, vc, k_new[S_pad:], v_new[S_pad:], wb, wo)
            return self._ragged(q, kc, vc, tables, unified.rows(), chunk_len,
                                unified.max_seq_len, unified.attrs(**extra))

        tokens = self._t(np.concatenate([c_tokens, self._tokens]))
        pos = self._t(np.concatenate([c_positions, positions]))
        hidden = self._forward(self.params, self.mcfg, tokens, pos, attend)
        self.step_counts["mixed"] += 1
        st.prefill_pos = total_len
        results = self._decode_epilogue(hidden[S_pad:], seqs, seq_lens, steps)
        first = None
        if is_final:
            first = self._first_token(st, hidden[chunk_len - 1:chunk_len])
        return results, first

    # ------------------------------------------------ decode horizon
    def _dispatch_horizon(self, chain: Optional[_Chain],
                          seqs: List[Optional[_Seq]]) -> _Chain:
        """Step executor: stage the horizon's inputs and run it (one graph
        replay on CUDA) over the loop-thread ``seqs`` snapshot. With
        ``chain``, the carry (tokens, seq_lens, steps) is the one that
        horizon leaves in the static buffers; without, it is written from
        the host state. Every dispatch stages the block tables (booked
        pages) and the active rows."""
        hz, c = self._horizon, self.cfg
        hs = hz.state
        slot = hz.next_slot()
        active = np.array([st is not None for st in seqs])
        if chain is None:
            carry = hs.carry.host_views[slot]
            carry["tokens"][:] = 0
            carry["seq_lens"][:] = 0
            carry["steps"][:] = 0
            for i, st in enumerate(seqs):
                if st is not None:
                    carry["tokens"][i] = st.last_token
                    carry["seq_lens"][i] = len(st.seq)
                    carry["steps"][i] = st.produced
            lens = carry["seq_lens"].copy()
            hs.carry.upload(slot)
        else:
            lens = chain.lens_after
        counting = any(o is not None and o.counting for o in self._slots)
        inp = hs.inputs.host_views[slot]
        inp["tables"][:] = self._block_tables
        inp["active"][:] = active
        inp["count_rows"][:] = active & counting
        inp["sample_rows"][:] = active & (self._temps > 0.0)
        inp["seeds"][:] = self._seeds
        for name, arr in (("temps", self._temps), ("top_ks", self._top_ks),
                          ("top_ps", self._top_ps), ("min_ps", self._min_ps),
                          ("pres", self._pres), ("freqs", self._freqs),
                          ("reps", self._reps)):
            inp[name][:] = arr
        hs.inputs.upload(slot)
        n = c.decode_steps
        max_seq_len = int(lens[active].max()) + n - 1
        host, event = hz.run(slot, max_seq_len, bool(inp["sample_rows"].any()))
        self.step_counts["horizon"] += 1
        return _Chain(seqs=list(seqs), host=host, event=event,
                      lens_after=lens + n * active.astype(np.int32))

    @torch.inference_mode()
    def _decode_multi(self, hs: HorizonState, max_seq_len: int, sampled: bool) -> None:
        """The horizon body: ``decode_steps`` decode iterations on device
        tensors only (no readback, no host-to-device copy: it is what the
        CUDA graphs capture). Each step takes its positions from the carry
        ``seq_lens``, its write pages from the block tables (inactive rows
        write scratch block 0), writes the fed tokens' KV, attends (the
        decode kernel, or the q_len = 1 rows of the unified kernel for
        layers with attention attributes, of the latent kernel for MLA),
        applies the penalties (exact no-ops at their defaults), samples at
        ``steps + s``, updates the output counts
        and writes its row of ``hs.packed``; its samples are the next step's
        tokens. The carry is written back in place. ``max_seq_len``, a
        bound on every row's length in the horizon, sizes the split grids;
        ``sampled``: whether any row samples (else no Gumbel draw)."""
        bs = self.cfg.block_size
        n = hs.packed.shape[0]
        V = self.mcfg.vocab_size
        active = hs.active
        act = active.to(torch.int32)
        tokens, seq_lens = hs.tokens, hs.seq_lens
        for s in range(n):
            positions = torch.clamp(seq_lens - 1, min=0)
            page = torch.gather(hs.tables, 1, (positions // bs).long()[:, None])[:, 0]
            wb = torch.where(active, page, 0)
            wo = torch.where(active, positions % bs, 0)

            def attend(q, k_new, v_new, layer_idx, **extra):
                kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
                att.write_decode_kv(kc, vc, k_new[:, 0], v_new[:, 0], wb, wo)
                if extra or self._latent:
                    return self._ragged(q[:, 0], kc, vc, hs.tables,
                                        (hs.q_starts, act, seq_lens), 1, max_seq_len,
                                        hs.attrs(**extra))[:, None]
                return cuda_attention.paged_decode_attention(
                    q[:, 0], kc, vc, hs.tables, seq_lens, max_seq_len=max_seq_len)[:, None]

            hidden = self._forward(self.params, self.mcfg, tokens[:, None],
                                   positions[:, None], attend)
            logits = self._lm_logits(self.params, self.mcfg, hidden[:, 0])
            pen = apply_penalties(logits, self.output_counts, self.prompt_masks,
                                  hs.pres, hs.freqs, hs.reps)
            gumbel = None
            if sampled:
                gumbel = gumbel_noise_tensor(hs.seeds, hs.steps + s, V, rows=hs.sample_rows)
            toks = sample_tokens(pen, hs.temps, hs.top_ks, hs.top_ps, hs.min_ps, gumbel)
            update_counts(self.output_counts, toks, hs.count_rows)
            vals, ids = top_logprobs(logits)
            hs.packed[s].copy_(torch.cat(
                [toks[:, None].float(), logprobs_of(logits, toks)[:, None], ids.float(), vals],
                dim=1))
            tokens = toks
            seq_lens = seq_lens + act
        hs.tokens.copy_(tokens)
        hs.seq_lens.copy_(seq_lens)
        hs.steps.add_(act * n)

    def _apply_packed(self, chain: _Chain, packed: np.ndarray) -> None:
        """Apply one fetched horizon [N, B, 2+2K]: each snapshot sequence's
        tokens go through stop handling in order (the tail after a finish
        is discarded) and leave as ONE BackendOutput. The horizon wrote
        the KV of every token it fed: all but its last sample's."""
        K = TOP_LOGPROBS_K
        n = packed.shape[0]
        toks = packed[:, :, 0].astype(np.int64)
        lps = packed[:, :, 1]
        tlp_ids = packed[:, :, 2:2 + K].astype(np.int64)
        tlp_vals = packed[:, :, 2 + K:]
        for i, st in enumerate(chain.seqs):
            if st is None or st.done:
                continue
            L = len(st.seq)
            want = st.req.sampling.logprobs > 0
            self._accept_tokens(st, toks[:, i].tolist(), lps[:, i].tolist(),
                                tlp_ids[:, i] if want else None,
                                tlp_vals[:, i] if want else None)
            st.kv_written = max(st.kv_written, min(len(st.seq), L + n - 1))

    # ------------------------------------------------- KVBM offload/onboard
    async def _offload_ready_blocks(self) -> None:
        """Loop thread, at the end of a tick: gather every block whose KV is
        written and that awaits offload. The gathers go through the step
        executor, so they are enqueued on the device in order before any
        later step could evict and rewrite those pages; only the copy to
        the host runs on the offload thread."""
        if not self._offload_pending:
            return
        pending, self._offload_pending = self._offload_pending, []
        loop = asyncio.get_running_loop()
        gathered, ready = await loop.run_in_executor(
            self._executor, self._enqueue_offload_gather, pending
        )
        self._offload_executor.submit(self._offload_fetch, pending, gathered, ready)

    async def flush_offload(self, timeout_s: float = 30.0) -> None:
        """With KVBM: wait until the step loop is idle and every block it
        offloaded has reached the tiers (tests, benchmarks, shutdown)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while self._loop_task is not None and not self._loop_task.done() and (
                not self._idle) and loop.time() < deadline:
            await asyncio.sleep(0.005)
        done = self._offload_executor.submit(lambda: None)
        await loop.run_in_executor(None, done.result, timeout_s)
        await loop.run_in_executor(None, self.kvbm.flush, timeout_s)

    @torch.inference_mode()
    def _enqueue_offload_gather(self, pending: List[Tuple[int, int, int]]):
        """Step executor: launch ONE page gather of the pending blocks, every
        layer's K and V (and scale rows) at once, into a fresh buffer in the
        host storage layout [n, L, 2, ...] (block_copy.gather_layers), on the
        step's stream; returns (the buffer, or for an int8 cache a
        (payload, scales) QuantizedKV, and an event recorded after it, or
        None on the CPU)."""
        ids = self._t([bid for bid, _, _ in pending], torch.int32)
        gathered = bc.gather_layers(self.k_caches, self.v_caches, ids)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return gathered, ready

    def _offload_fetch(self, pending, gathered, ready) -> None:
        """Offload thread: wait for the gather (on a side stream, so the
        copy overlaps later steps), copy its buffer to fresh host memory and
        hand each block to the KVBM priority queue. The tier bytes are the
        storage format (kvbm/layout): the int8 codec buffer, or model-dtype
        pages (bf16 as bit patterns)."""
        try:
            with torch.inference_mode(), torch.cuda.stream(self._offload_stream):
                if ready is not None:
                    self._offload_stream.wait_event(ready)
                if self.kv_quantized:
                    pay = gathered.data.cpu().numpy()
                    scl = gathered.scale.cpu().numpy()
                    blocks = [self._codec.encode(pay[i], scl[i]) for i in range(len(pending))]
                else:
                    arr = to_host(gathered.cpu())
                    blocks = [arr[i].copy() for i in range(len(pending))]
            for (_, h, prio), block in zip(pending, blocks):
                self.kvbm.offload(h, block, priority=prio)
        except Exception:
            self.offload_errors += 1
            log.exception("kv offload of %d blocks failed", len(pending))

    @torch.inference_mode()
    def _scatter_blocks(self, local_ids: List[int], arr) -> None:
        """Step executor: upload host blocks and scatter them into device
        pages with ONE launch (block_copy.scatter_layers; no allocator
        access here: the allocator lives on the loop thread).

        ``arr`` is model-dtype pages [n, L, 2, bs, kvh, d] (host storage
        form, kvbm/layout) or, for an int8 cache, a (payload int8 [n, L, 2,
        bs, kvh, d], scales f32 [n, L, 2, kvh]) pair that scatters straight
        into the quantized cache, bit-exactly."""
        ids = self._t(local_ids, torch.int32)
        if self.kv_quantized:
            pages = QuantizedKV(*(from_host(a).to(self.device) for a in arr))
        else:
            pages = from_host(arr).to(self.device)
        bc.scatter_layers(self.k_caches, self.v_caches, ids, pages)

    async def import_blocks(self, hashes: List[int], arr) -> int:
        """Import [n, L, 2, bs, kvh, d] pages (or an int8 (payload, scales)
        pair, see _scatter_blocks) as content-addressed cached pages; returns
        the number imported (0 when the pool has no room). Allocator changes
        stay on the loop thread; only the scatter runs on the executor."""
        n = (arr[0] if isinstance(arr, tuple) else arr).shape[0]
        try:
            local_ids = self.allocator.allocate(n)
        except OutOfBlocks:
            log.warning("no room to import %d blocks; skipping", n)
            return 0
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(self._executor, self._scatter_blocks, local_ids, arr)
        except BaseException:
            self.allocator.release(local_ids)
            raise
        for bid, h in zip(local_ids, hashes):
            self.allocator.commit(bid, h)
        self.allocator.release(local_ids)
        return n

    async def _onboard_from_kvbm(self, st: _Seq) -> None:
        """Pull a host/disk-cached prefix into device pages before
        admission (blocks strictly before the last prompt token, as
        admission reuses)."""
        bs = self.cfg.block_size
        hashes = st.seq.sequence_hashes()[: (len(st.seq) - 1) // bs]
        have = len(self.allocator.match_prefix(hashes))
        loop = asyncio.get_running_loop()
        n = await loop.run_in_executor(None, self.kvbm.match_prefix, hashes[have:])
        if n == 0:
            return
        want = hashes[have:have + n]
        arr = await loop.run_in_executor(None, self.kvbm.load_prefix, want)
        if arr is None:
            return
        # format guard: the disk tier survives restarts, so blocks written
        # under another kv_dtype or model shape can come back under the same
        # content hashes; they are a miss, never imported
        if self.kv_quantized:
            if arr.dtype != np.uint8 or arr.ndim != 2 or arr.shape[1] != self._codec.nbytes:
                log.warning("kvbm blocks are not this engine's int8 codec format "
                            "(%s %s); skipping onboard", arr.dtype, arr.shape)
                return
            arr = self._codec.decode_many(arr)
        else:
            m = self.mcfg
            expect = (m.num_layers, 2, self.cfg.block_size, m.num_kv_heads, m.head_dim)
            if arr.ndim != 6 or arr.shape[1:] != expect or arr.dtype != storage_dtype(m.dtype):
                log.warning("kvbm blocks do not match this engine's KV layout "
                            "(%s %s vs %s); skipping onboard", arr.dtype,
                            arr.shape[1:], expect)
                return
        got = await self.import_blocks(list(want), arr)
        if got:
            log.debug("onboarded %d blocks from kvbm for %s", got, st.req.request_id[:8])

    # ------------------------------------------------ host-side bookkeeping
    def _accept_token(self, st: _Seq, tok: int, logprob: float,
                      tlp_ids: Optional[List[int]] = None,
                      tlp_vals: Optional[List[float]] = None) -> None:
        """Apply one sampled token (a prefill's, a decode step's)."""
        self._accept_tokens(st, [tok], [logprob],
                            None if tlp_ids is None else [tlp_ids],
                            None if tlp_vals is None else [tlp_vals])

    def _accept_tokens(self, st: _Seq, toks: List[int], logprobs: List[float],
                       tlp_ids=None, tlp_vals=None) -> None:
        """Apply a run of sampled tokens (a horizon's, or one) to their
        sequence in order and stream what survives, or the finish, as ONE
        BackendOutput; the tokens after a finish are the discarded
        speculative tail. ``tlp_ids`` / ``tlp_vals``: [n, K] top logprobs."""
        if st.done:
            return
        first = st.produced == 0
        stop = st.req.stop
        n_tlp = min(st.req.sampling.logprobs, TOP_LOGPROBS_K)
        tlp = [] if n_tlp > 0 and tlp_ids is not None else None
        emit: List[int] = []
        emit_lps: List[float] = []
        finish: Optional[str] = None
        for n, tok in enumerate(toks):
            st.produced += 1
            if tok in stop.stop_token_ids and st.produced > stop.min_tokens:
                finish = FINISH_STOP   # the stop token is not emitted
                break
            emit.append(tok)
            emit_lps.append(logprobs[n])
            if tlp is not None:
                tlp.append({int(i): float(v)
                            for i, v in zip(tlp_ids[n][:n_tlp], tlp_vals[n][:n_tlp])})
            if stop.max_tokens is not None and st.produced >= stop.max_tokens:
                finish = FINISH_LENGTH
            elif st.context.is_stopped():
                finish = FINISH_CANCELLED
            elif len(st.seq) + 1 >= self.cfg.max_context:
                finish = FINISH_LENGTH
            else:
                L_before = len(st.seq)
                sealed = st.seq.append(tok)
                st.last_token = tok
                if sealed is not None:
                    # its last row (this token) is written by a later step:
                    # it enters the prefix cache, and the offload queue,
                    # once that step ran (_commit_written_blocks)
                    self._sealed_unwritten.append((
                        st, sealed.position, st.block_ids[sealed.position],
                        sealed.sequence_hash,
                    ))
                # a block must exist for the NEXT token's write position
                if (L_before + 1) // self.cfg.block_size + 1 > len(st.block_ids):
                    try:
                        (new_id,) = self.allocator.allocate(1)
                    except OutOfBlocks:
                        finish = FINISH_LENGTH   # out of KV memory: end gracefully
                    else:
                        st.block_ids.append(new_id)
                        self._block_tables[st.slot, len(st.block_ids) - 1] = new_id
            if finish is not None:
                break
        ann: Dict[str, Any] = {}
        if first:
            ann = {"cached_tokens": st.cached_tokens,
                   "input_tokens": len(st.req.token_ids)}
        st.out_queue.put_nowait(BackendOutput(
            token_ids=emit, finish_reason=finish, cumulative_tokens=st.produced,
            logprobs=emit_lps if emit else None, top_logprobs=tlp if tlp else None,
            annotations=ann,
        ))
        if finish is not None:
            st.done = True

    def _commit_written_blocks(self) -> None:
        """Content-address the decode-sealed blocks whose last row a step
        has written (and queue them for offload). Until then the device
        prefix cache must not serve them: a prefill that matched one would
        attend over an unwritten row. (The reference commits at sealing.)
        A sequence that finished before the write drops its entries."""
        bs = self.cfg.block_size
        waiting = []
        for entry in self._sealed_unwritten:
            st, idx, bid, h = entry
            if st.kv_written >= (idx + 1) * bs:
                self.allocator.commit(bid, h)
                if self.kvbm is not None:
                    self._offload_pending.append((bid, h, 1))
            elif not st.done:
                waiting.append(entry)
        self._sealed_unwritten = waiting

    def _reap_finished(self) -> None:
        # commit what is written before any block goes back to the pool
        self._commit_written_blocks()
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            if st.done or st.context.is_killed():
                self.allocator.release(st.block_ids)
                self._slots[i] = None
                self._sealed_unwritten = [e for e in self._sealed_unwritten
                                          if e[0] is not st]
                if not st.done:
                    st.done = True
                    st.out_queue.put_nowait(BackendOutput(
                        finish_reason=FINISH_CANCELLED, cumulative_tokens=st.produced,
                    ))
